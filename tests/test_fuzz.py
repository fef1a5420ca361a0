"""Cross-implementation fuzz: every impl must agree with the NumPy spec
across random shapes, k values, N rates, and canonical modes."""

import jax
import numpy as np
import pytest

from cfrk_tpu.ops.perread import count_perread
from cfrk_tpu.ops.reference import count_perread_np, spectrum_np
from cfrk_tpu.ops.spectrum import spectrum


def _case(seed):
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 20))
    lo = int(rng.integers(1, 40))
    hi = lo + int(rng.integers(1, 120))
    n_frac = float(rng.choice([0.0, 0.02, 0.3]))
    reads = []
    for _ in range(b):
        ln = int(rng.integers(lo, hi + 1))
        r = rng.integers(0, 4, size=ln).astype(np.int8)
        r[rng.random(ln) < n_frac] = -1
        reads.append(r)
    ml = max(len(r) for r in reads)
    codes = np.full((b, ml), -1, dtype=np.int8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
    return reads, codes


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("canonical", [False, True])
def test_perread_impls_vs_numpy_spec(seed, canonical):
    _, codes = _case(seed)
    rng = np.random.default_rng(seed + 1000)
    k = int(rng.integers(1, 9))
    if codes.shape[1] < k:
        codes = np.pad(codes, ((0, 0), (0, k - codes.shape[1])),
                       constant_values=-1)
    # padding cols are invalid and count nothing, so the padded batch
    # must agree with the spec applied row-by-row.
    want_padded = count_perread_np(list(codes), k, canonical)
    impls = ["compare"] if 4**k <= 64 else ["matmul", "scatter", "host"]
    for impl in impls:
        got = np.asarray(
            count_perread(codes, k, canonical=canonical, impl=impl)
        )
        np.testing.assert_array_equal(got, want_padded, err_msg=f"{impl} k={k}")


@pytest.mark.parametrize("seed", range(4))
def test_spectrum_impls_vs_numpy_spec(seed):
    _, codes = _case(seed + 50)
    rng = np.random.default_rng(seed + 2000)
    k = int(rng.integers(1, 9))
    if codes.shape[1] < k:
        codes = np.pad(codes, ((0, 0), (0, k - codes.shape[1])),
                       constant_values=-1)
    want = spectrum_np(list(codes), k).astype(np.int64)
    for impl in ("matmul", "scatter"):
        got = np.asarray(spectrum(codes, k, impl=impl), dtype=np.int64)
        np.testing.assert_array_equal(got, want, err_msg=f"{impl} k={k}")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("canonical", [False, True])
def test_sparse_spectrum_vs_numpy_spec(seed, canonical):
    """Sort+RLE sparse spectra (single-key route k<=15 AND 2-key route
    k>15) agree with a brute-force int64 window-code oracle across
    random shapes, N rates, and canonical modes."""
    from cfrk_tpu.ops.reference import canonical_indices_np, window_indices_np
    from cfrk_tpu.ops.sparse import merge_sorted_spectra, sparse_spectrum

    _, codes = _case(seed + 100)
    rng = np.random.default_rng(seed + 3000)
    k = int(rng.choice([2, 9, 15, 16, 23, 31]))
    if codes.shape[1] < k:
        codes = np.pad(codes, ((0, 0), (0, k - codes.shape[1])),
                       constant_values=-1)
    fn = canonical_indices_np if canonical else window_indices_np
    want: dict[int, int] = {}
    for row in codes:
        idx = fn(row, k)
        for v in idx[idx >= 0].tolist():
            want[v] = want.get(v, 0) + 1
    triple = tuple(np.asarray(a) for a in sparse_spectrum(codes, k, canonical))
    got = merge_sorted_spectra([triple])
    assert got == want, f"k={k}"


@pytest.mark.parametrize("seed", range(4))
def test_perread_sparse_rows_vs_numpy_spec(seed):
    """Per-read sparse rows (both the small-k idx route and the large-k
    (hi, lo) route) agree with the dense NumPy histograms."""
    from cfrk_tpu.ops.perread_sparse import (
        count_perread_sparse,
        count_perread_sparse_large,
        pairs_to_host,
    )
    from cfrk_tpu.ops.reference import window_indices_np

    _, codes = _case(seed + 200)
    rng = np.random.default_rng(seed + 4000)
    for k, op in [(int(rng.integers(1, 16)), count_perread_sparse),
                  (int(rng.integers(16, 24)), count_perread_sparse_large)]:
        c = codes
        if c.shape[1] < k:
            c = np.pad(c, ((0, 0), (0, k - c.shape[1])), constant_values=-1)
        idx, cnt = pairs_to_host(op(c, k), c.shape[0])
        for r, row in enumerate(c):
            widx = window_indices_np(row, k)
            want: dict[int, int] = {}
            for v in widx[widx >= 0].tolist():
                want[v] = want.get(v, 0) + 1
            m = cnt[r] > 0
            got = dict(zip(idx[r][m].tolist(), cnt[r][m].tolist()))
            assert got == want, f"k={k} row={r}"


def test_cli_differential_fuzz(tmp_path):
    """Bounded version of tools/fuzz_cli.py: random CLI configurations
    (mode x k x canonical x stream x nonzero x compression x mesh) end
    to end against the NumPy oracle, through real output files.  Kept
    small — every random shape is a fresh XLA compile; deep campaigns
    run offline via the tool."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    from fuzz_cli import run_trial

    rng = np.random.default_rng(1000)
    for t in range(3):
        d = tmp_path / f"t{t}"
        d.mkdir()
        run_trial(rng, str(d), use_mesh=len(jax.devices()) >= 8)


def test_parser_garbage_parity():
    """Random byte blobs (headers, half-records, stray separators):
    the native and pure-Python parsers must either raise the same class
    of error or parse to identical reads — never diverge silently."""
    import io as _io

    from cfrk_tpu.io.fasta import encode_seq, iter_reads
    from cfrk_tpu.io.native import HAVE_NATIVE, _fastaio

    if not HAVE_NATIVE:
        pytest.skip("native extension not built")
    rng = np.random.default_rng(0)
    alphabet = b">@ACGTNacgtn+\r\n\t 0123xyz"
    for t in range(150):
        n = int(rng.integers(0, 200))
        blob = bytes(alphabet[i] for i in rng.integers(0, len(alphabet), n))
        try:
            py = [
                encode_seq(s).tolist()
                for _, s in iter_reads(_io.BytesIO(blob))
            ]
        except ValueError:
            py = None
        try:
            codes_b, lens_b = _fastaio.parse_encode(blob)
            codes = np.frombuffer(codes_b, dtype=np.int8)
            lens = np.frombuffer(lens_b, dtype=np.int64)
            offs = np.concatenate(([0], np.cumsum(lens))).astype(int)
            nat = [
                codes[offs[i] : offs[i + 1]].tolist()
                for i in range(len(lens))
            ]
        except ValueError:
            nat = None
        assert (py is None) == (nat is None), (t, blob[:60])
        if py is not None:
            assert py == nat, (t, blob[:60])


def test_chunked_parser_garbage_parity():
    """parse_encode_stream over random chunk splits of garbage-ish
    FASTA bytes == parse_encode over the whole blob (the record-carry
    logic must be split-point invariant)."""
    from cfrk_tpu.io.native import HAVE_STREAM_NATIVE, _fastaio

    if not HAVE_STREAM_NATIVE:
        pytest.skip("native extension not built")
    rng = np.random.default_rng(1)
    alphabet = b">ACGTNacgtn\r\n\t 0123xyz"
    for t in range(150):
        n = int(rng.integers(0, 400))
        blob = bytes(alphabet[i] for i in rng.integers(0, len(alphabet), n))
        want = _fastaio.parse_encode(blob)
        cuts = sorted(
            set(int(c) for c in rng.integers(0, n + 1, int(rng.integers(1, 6))))
        ) + [n]
        got_codes, got_lens = b"", b""
        data, prev = b"", 0
        for i, c in enumerate(cuts):
            data += blob[prev:c]
            prev = c
            codes_b, lens_b, _offs, consumed = _fastaio.parse_encode_stream(
                data, False, i == len(cuts) - 1
            )
            got_codes += codes_b
            got_lens += lens_b
            data = data[consumed:]
        assert (got_codes, got_lens) == want, (t, blob[:60])


def test_chunked_parser_fastq_garbage_parity():
    """FASTQ branch of parse_encode_stream over random chunk splits ==
    the single-pass parse (or both reject), across CRLF records, empty
    reads, and stray blank lines at header position."""
    from cfrk_tpu.io.native import HAVE_STREAM_NATIVE, _fastaio

    if not HAVE_STREAM_NATIVE:
        pytest.skip("native extension not built")
    rng = np.random.default_rng(3)
    for t in range(120):
        recs = []
        for i in range(int(rng.integers(0, 8))):
            ln = int(rng.integers(0, 30))
            seq = bytes(b"ACGTN"[c] for c in rng.integers(0, 5, ln))
            qual = bytes(rng.integers(33, 80, ln).astype(np.uint8))
            sep = b"\r\n" if rng.integers(0, 3) == 0 else b"\n"
            recs.append(
                b"@r%d" % i + sep + seq + sep + b"+" + sep + qual + sep
            )
            if rng.integers(0, 4) == 0:
                recs.append(sep)  # stray blank line at header position
        blob = b"".join(recs)
        try:
            want = _fastaio.parse_encode(blob)
        except ValueError:
            want = None
        cuts = sorted(
            set(
                int(c)
                for c in rng.integers(0, len(blob) + 1, int(rng.integers(1, 6)))
            )
        ) + [len(blob)]
        got_codes, got_lens, data, prev = b"", b"", b"", 0
        got = None
        try:
            for i, c in enumerate(cuts):
                data += blob[prev:c]
                prev = c
                codes_b, lens_b, _o, consumed = _fastaio.parse_encode_stream(
                    data, True, i == len(cuts) - 1
                )
                got_codes += codes_b
                got_lens += lens_b
                data = data[consumed:]
            got = (got_codes, got_lens)
        except ValueError:
            got = None
        assert (want is None) == (got is None), (t, blob[:80])
        if want is not None:
            assert got == want, (t, blob[:80])
