"""Sparse per-read counting (8 < k <= 15): agreement with the dense path
at small k, with a NumPy oracle at large k, and the CLI route."""

import numpy as np
import pytest

from cfrk_tpu.format import format_rows_nonzero, format_rows_pairs
from cfrk_tpu.io.fasta import decode_codes
from cfrk_tpu.ops.perread import count_perread
from cfrk_tpu.ops.perread_sparse import count_perread_sparse


def _random_codes(b, l, rng, n_frac=0.03):
    codes = rng.integers(0, 4, size=(b, l)).astype(np.int8)
    codes[rng.random(codes.shape) < n_frac] = -1
    return codes


@pytest.mark.parametrize("k", [2, 4, 7])
def test_sparse_rows_equal_dense_nonzero(k):
    rng = np.random.default_rng(0)
    codes = _random_codes(12, 80, rng)
    idx, counts = count_perread_sparse(codes, k)
    dense = np.asarray(count_perread(codes, k))
    assert format_rows_pairs(idx, counts) == format_rows_nonzero(dense)


def test_sparse_large_k_numpy_oracle():
    k = 12
    rng = np.random.default_rng(1)
    codes = _random_codes(6, 200, rng)
    idx, counts = count_perread_sparse(codes, k)
    idx, counts = np.asarray(idx), np.asarray(counts)
    for r in range(codes.shape[0]):
        want: dict = {}
        row = codes[r]
        for p in range(len(row) - k + 1):
            win = row[p : p + k]
            if (win < 0).any():
                continue
            key = 0
            for c in win:
                key = key * 4 + int(c)
            want[key] = want.get(key, 0) + 1
        got = {
            int(i): int(c)
            for i, c in zip(idx[r], counts[r])
            if c > 0
        }
        assert got == want


def test_sparse_canonical_matches_dense():
    k = 6
    rng = np.random.default_rng(2)
    codes = _random_codes(8, 60, rng)
    idx, counts = count_perread_sparse(codes, k, True)
    dense = np.asarray(count_perread(codes, k, canonical=True))
    assert format_rows_pairs(idx, counts) == format_rows_nonzero(dense)


def test_cli_large_k_requires_nonzero(tmp_path):
    from cfrk_tpu.cli import main

    rng = np.random.default_rng(3)
    reads = [rng.integers(0, 4, size=50).astype(np.int8) for _ in range(4)]
    fasta = tmp_path / "r.fasta"
    with open(fasta, "wb") as f:
        for i, codes in enumerate(reads):
            f.write(b">r%d\n" % i + decode_codes(codes) + b"\n")
    out = tmp_path / "o.cfrk"
    with pytest.raises(SystemExit, match="requires --nonzero"):
        main([str(fasta), "-k", "11", "-o", str(out)])
    rc = main([str(fasta), "-k", "11", "-o", str(out), "--nonzero"])
    assert rc == 0
    rows = out.read_bytes().split(b"\n")
    assert len(rows) == 4
    # Each 50 bp read has 40 windows, all unique with high probability.
    for row in rows:
        cells = [c for c in row.split(b" ") if c]
        assert 1 <= len(cells) <= 40
        total = sum(int(c.split(b":")[1]) for c in cells)
        assert total == 40


def test_sparse_large_k_matches_oracle_k20():
    import numpy as np

    from cfrk_tpu.ops.perread_sparse import (
        count_perread_sparse_large,
        pairs_to_host,
    )

    k = 20
    rng = np.random.default_rng(4)
    codes = _random_codes(5, 120, rng)
    out = count_perread_sparse_large(codes, k)
    idx, counts = pairs_to_host(out, 5)
    assert idx.dtype == np.uint64
    for r in range(codes.shape[0]):
        want: dict = {}
        row = codes[r]
        for p in range(len(row) - k + 1):
            win = row[p : p + k]
            if (win < 0).any():
                continue
            key = 0
            for c in win:
                key = key * 4 + int(c)
            want[key] = want.get(key, 0) + 1
        got = {
            int(i): int(c) for i, c in zip(idx[r], counts[r]) if c > 0
        }
        assert got == want


def test_large_small_k_agree_at_boundary():
    """k=15 via both ops produces identical formatted rows."""
    import numpy as np

    from cfrk_tpu.format import format_rows_pairs
    from cfrk_tpu.ops.perread_sparse import (
        count_perread_sparse,
        count_perread_sparse_large,
        pairs_to_host,
    )

    rng = np.random.default_rng(5)
    codes = _random_codes(6, 100, rng)
    a = pairs_to_host(count_perread_sparse(codes, 15), 6)
    b = pairs_to_host(count_perread_sparse_large(codes, 15), 6)
    assert format_rows_pairs(*a) == format_rows_pairs(*b)


def test_cli_perread_k31(tmp_path):
    import numpy as np

    from cfrk_tpu.cli import main
    from cfrk_tpu.io.fasta import decode_codes

    rng = np.random.default_rng(6)
    reads = [rng.integers(0, 4, size=64).astype(np.int8) for _ in range(3)]
    fasta = tmp_path / "r.fasta"
    with open(fasta, "wb") as f:
        for i, codes in enumerate(reads):
            f.write(b">r%d\n" % i + decode_codes(codes) + b"\n")
    out = tmp_path / "o.cfrk"
    rc = main([str(fasta), "-k", "31", "-o", str(out), "--nonzero"])
    assert rc == 0
    rows = out.read_bytes().split(b"\n")
    assert len(rows) == 3
    for row in rows:
        cells = [c for c in row.split(b" ") if c]
        total = sum(int(c.split(b":")[1]) for c in cells)
        assert total == 64 - 31 + 1
        # keys are 2k-bit codes, some certainly above 2**32
        assert max(int(c.split(b":")[0]) for c in cells) > 2**32


def test_sparse_large_k_canonical_oracle():
    import numpy as np

    from cfrk_tpu.ops.perread_sparse import (
        count_perread_sparse_large,
        pairs_to_host,
    )

    k = 18
    rng = np.random.default_rng(7)
    codes = _random_codes(4, 80, rng)
    idx, counts = pairs_to_host(count_perread_sparse_large(codes, k, True), 4)
    for r in range(codes.shape[0]):
        want: dict = {}
        row = codes[r]
        for p in range(len(row) - k + 1):
            win = row[p : p + k]
            if (win < 0).any():
                continue
            fwd = 0
            for c in win:
                fwd = fwd * 4 + int(c)
            rc = 0
            for c in reversed(win):
                rc = rc * 4 + (3 - int(c))
            key = min(fwd, rc)
            want[key] = want.get(key, 0) + 1
        got = {int(i): int(c) for i, c in zip(idx[r], counts[r]) if c > 0}
        assert got == want


def test_narrow_for_fetch_dtype_ladder():
    """D2H narrowing: uint8 counts for short reads (< 256 windows),
    int16 below 2**15, uint16 idx for k <= 8 — and pairs_to_host widens
    everything back to int32 exactly."""
    import jax.numpy as jnp
    import numpy as np

    from cfrk_tpu.ops.perread_sparse import (
        count_perread_sparse,
        count_perread_sparse_large,
        narrow_for_fetch,
        pairs_to_host,
    )

    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 4, size=(6, 150)).astype(np.int8))
    out = count_perread_sparse(codes, 8)
    ni, nc = narrow_for_fetch(out, 8)
    assert ni.dtype == jnp.uint16 and nc.dtype == jnp.uint8
    wi, wc = pairs_to_host((ni, nc), 6)
    ri, rc = pairs_to_host(out, 6)
    np.testing.assert_array_equal(wc, rc)
    mask = rc > 0
    np.testing.assert_array_equal(wi[mask], ri[mask])

    # long reads: counts can exceed 255 -> int16
    long_codes = jnp.asarray(np.zeros((2, 600), np.int8))  # poly-A
    out2 = count_perread_sparse(long_codes, 8)
    _, nc2 = narrow_for_fetch(out2, 8)
    assert nc2.dtype == jnp.int16
    _, wc2 = pairs_to_host(narrow_for_fetch(out2, 8), 2)
    assert int(wc2.max()) == 600 - 8 + 1  # single run of all windows

    out31 = count_perread_sparse_large(codes, 31, True)
    trip = narrow_for_fetch(out31, 31)
    assert trip[2].dtype == jnp.uint8
    k2, c2 = pairs_to_host(trip, 6)
    rk, rcc = pairs_to_host(out31, 6)
    np.testing.assert_array_equal(c2, rcc)
    np.testing.assert_array_equal(k2[rcc > 0], rk[rcc > 0])

