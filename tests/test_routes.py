"""The XLA device routes vs the NumPy specification (ops/reference.py).

Dense per-read counting (compare, scatter, matmul), the dense spectrum
(matmul, scatter), the per-read rows route (row sort + RLE) that every
``.cfrk`` output and the sparse modes ride, and the route choice itself.
Compiled on the card, the same routes are checked by ``chip_smoke.py``
and the ``gpu``-marked tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfrk_tpu.ops.perread import count_perread, resolve_perread_impl
from cfrk_tpu.ops.perread_sparse import (
    count_perread_rows,
    count_perread_sparse,
    count_perread_sparse_large,
)
from cfrk_tpu.ops.reference import (
    canonical_indices_np,
    count_perread_np,
    spectrum_np,
    window_indices_np,
)
from cfrk_tpu.ops.sparse import INVALID_SENTINEL, LO_BASES
from cfrk_tpu.ops.spectrum import resolve_spectrum_impl, spectrum


def _batch(rng, b, l, p_invalid=0.03):
    codes = rng.integers(0, 4, size=(b, l)).astype(np.int8)
    codes[rng.random(codes.shape) < p_invalid] = -1
    return codes


def _rows_reference(codes, k, canonical=False):
    """The rows route's exact layout, row by row from the reference:
    sorted distinct keys at their run-start positions, sentinels and
    zero counts elsewhere."""
    b, length = codes.shape
    w = length - k + 1
    fn = canonical_indices_np if canonical else window_indices_np
    keys_out = np.zeros((b, w), np.uint64)
    cnt_out = np.zeros((b, w), np.int32)
    for r in range(b):
        idx = fn(codes[r], k)
        keys, counts = np.unique(idx[idx >= 0], return_counts=True)
        pos = np.cumsum(counts) - counts
        keys_out[r, pos] = keys.astype(np.uint64)
        cnt_out[r, pos] = counts
    run = cnt_out > 0
    if k <= 15:
        idx = np.where(run, keys_out, 4**k).astype(np.int32)
        return idx, cnt_out
    hi = (keys_out >> np.uint64(2 * LO_BASES)).astype(np.uint32)
    lo = (keys_out & np.uint64(4**LO_BASES - 1)).astype(np.uint32)
    return (
        np.where(run, hi, INVALID_SENTINEL).astype(np.uint32),
        np.where(run, lo, INVALID_SENTINEL).astype(np.uint32),
        cnt_out,
    )


def _assert_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


# ---------------------------------------------------------------- dense


@pytest.mark.parametrize("impl", ["scatter", "matmul"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4, 5, 8])
def test_perread_impls(rng, k, canonical, impl):
    codes = _batch(rng, 13, 171)
    got = np.asarray(count_perread(jnp.asarray(codes), k, canonical=canonical,
                                   impl=impl))
    np.testing.assert_array_equal(got, count_perread_np(list(codes), k, canonical))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_perread_compare(rng, k, canonical):
    codes = _batch(rng, 13, 171)
    got = np.asarray(count_perread(jnp.asarray(codes), k, canonical=canonical,
                                   impl="compare"))
    np.testing.assert_array_equal(got, count_perread_np(list(codes), k, canonical))


@pytest.mark.parametrize("impl", ["scatter", "matmul"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4, 5, 8])
def test_spectrum_impls(rng, k, canonical, impl):
    codes = _batch(rng, 13, 171)
    got = np.asarray(spectrum(jnp.asarray(codes), k, canonical=canonical,
                              impl=impl))
    np.testing.assert_array_equal(got.astype(np.int64),
                                  spectrum_np(list(codes), k, canonical))


@pytest.mark.parametrize("impl", ["scatter", "matmul"])
def test_perread_long_reads(rng, impl):
    """Reads past the reference's 1024-base cap (src/kmer_kernel.cu:83-85)
    count every window."""
    codes = _batch(rng, 3, 1500)
    got = np.asarray(count_perread(jnp.asarray(codes), 4, impl=impl))
    np.testing.assert_array_equal(got, count_perread_np(list(codes), 4))


@pytest.mark.parametrize("impl", ["scatter", "matmul"])
def test_spectrum_no_cross_read_windows(rng, impl):
    """Full-length reads sit adjacent once flattened: no window may
    cross a read boundary."""
    codes = rng.integers(0, 4, size=(16, 64)).astype(np.int8)
    got = np.asarray(spectrum(jnp.asarray(codes), 3, impl=impl))
    np.testing.assert_array_equal(got.astype(np.int64),
                                  spectrum_np(list(codes), 3))


def test_perread_odd_batch(rng):
    codes = _batch(rng, 9, 77)
    got = np.asarray(count_perread(jnp.asarray(codes), 5))
    np.testing.assert_array_equal(got, count_perread_np(list(codes), 5))


@pytest.mark.parametrize(
    "impl,k", [("compare", 3), ("scatter", 5), ("matmul", 5), ("host", 5)]
)
def test_perread_int16_output_parity(impl, k):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(16, 100)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.02] = -1
    c32 = np.asarray(count_perread(codes, k, impl=impl))
    c16 = np.asarray(count_perread(codes, k, impl=impl, out_dtype=jnp.int16))
    assert c16.dtype == np.int16
    np.testing.assert_array_equal(c16.astype(np.int32), c32)
    np.testing.assert_array_equal(c32, count_perread_np(list(codes), k))


def test_perread_int16_overflow_guard():
    codes = np.zeros((1, 2**15 + 8), dtype=np.int8)
    with pytest.raises(ValueError, match="int16 counts unsafe"):
        count_perread(codes, 2, out_dtype=jnp.int16)


def test_spectrum_k9_scatter_matches_reference(rng):
    codes = _batch(rng, 12, 80, p_invalid=0.02)
    got = np.asarray(spectrum(codes, 9))
    np.testing.assert_array_equal(got.astype(np.int64),
                                  spectrum_np(list(codes), 9))


# ---------------------------------------------------------------- rows


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 2, 8, 15])
def test_rows_route(rng, k, canonical):
    codes = _batch(rng, 13, 171)
    _assert_rows(count_perread_rows(jnp.asarray(codes), k, canonical),
                 _rows_reference(codes, k, canonical))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [16, 24, 31])
def test_rows_route_two_key(rng, k, canonical):
    codes = _batch(rng, 13, 171, p_invalid=0.005)
    _assert_rows(count_perread_rows(jnp.asarray(codes), k, canonical),
                 _rows_reference(codes, k, canonical))


@pytest.mark.parametrize("length", [136, 150, 199, 200])
def test_rows_route_widths(rng, length):
    """Row widths on both sides of the 128/256 length buckets, with the
    two degenerate rows: one run (poly-A) and no valid window (poly-N)."""
    codes = _batch(rng, 11, length)
    codes[0] = 0
    codes[1] = -1
    _assert_rows(count_perread_rows(jnp.asarray(codes), 8),
                 _rows_reference(codes, 8))


def test_rows_route_long_reads_and_edge_rows(rng):
    codes = _batch(rng, 5, 1000)
    codes[0] = 0
    codes[1] = -1
    _assert_rows(count_perread_rows(jnp.asarray(codes), 8),
                 _rows_reference(codes, 8))


def test_rows_route_hi_sentinel_collision():
    """A 16-T prefix at k=31 makes the hi key half equal the sentinel
    value — validity is judged on lo, never hi, or these k-mers vanish."""
    codes = np.zeros((4, 60), np.int8)
    codes[:, :20] = 3
    got = count_perread_rows(jnp.asarray(codes), 31)
    _assert_rows(got, _rows_reference(codes, 31))
    assert int(np.asarray(got[2]).sum()) > 0


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("length", [36, 70])
def test_rows_route_short_reads(rng, length, canonical):
    codes = _batch(rng, 37, length)
    _assert_rows(count_perread_rows(jnp.asarray(codes), 8, canonical),
                 _rows_reference(codes, 8, canonical))
    _assert_rows(count_perread_rows(jnp.asarray(codes), 31, canonical),
                 _rows_reference(codes, 31, canonical))


def test_count_perread_rows_dispatcher(rng):
    """One key below k=16, the (hi, lo) pair from k=16 on."""
    codes = jnp.asarray(_batch(rng, 7, 150))
    _assert_rows(count_perread_rows(codes, 15),
                 [np.asarray(a) for a in count_perread_sparse(codes, 15)])
    _assert_rows(count_perread_rows(codes, 16),
                 [np.asarray(a) for a in count_perread_sparse_large(codes, 16)])


# ---------------------------------------------------------------- routes


@pytest.mark.parametrize("k", range(1, 9))
def test_perread_auto_route_is_a_device_route(k):
    """No (k, width) sends auto dense per-read counting to the host."""
    for w in (1, 143, 2**15, 2**24):
        impl = resolve_perread_impl(k, w)
        assert impl == ("compare" if k <= 3 else "scatter"), (k, w, impl)


@pytest.mark.parametrize("k", [1, 4, 6, 7, 10, 15])
def test_spectrum_auto_route_is_a_device_route(k):
    for n in (1, 2**20, 2**24):
        impl = resolve_spectrum_impl(k, n)
        want = "matmul" if k <= 6 and n < 2**24 else "scatter"
        assert impl == want, (k, n, impl)


def test_matmul_reroutes_past_float32_exactness():
    assert resolve_perread_impl(5, 2**24, "matmul") == "scatter"
    assert resolve_perread_impl(5, 2**24 - 1, "matmul") == "matmul"
    assert resolve_spectrum_impl(5, 2**24, "matmul") == "scatter"
    assert resolve_spectrum_impl(5, 2**24 - 1, "matmul") == "matmul"


def test_auto_dense_counting_runs_on_the_device(monkeypatch):
    """Outside a trace, auto dense counting above 4**3 bins dispatches
    the device scatter route, not the host oracle."""
    import cfrk_tpu.ops.perread as perread

    calls = []
    real = perread._count_scatter

    def spy(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(perread, "_count_scatter", spy)
    codes = np.random.default_rng(3).integers(0, 4, (4, 40)).astype(np.int8)
    out = count_perread(codes, 6)
    assert calls == [(6, False)]
    np.testing.assert_array_equal(np.asarray(out), count_perread_np(list(codes), 6))


def test_impl_choices_are_the_xla_routes(capsys):
    from cfrk_tpu.cli import build_parser

    parser = build_parser()
    impl = next(a for a in parser._actions if a.dest == "impl")
    assert set(impl.choices) == {
        "auto", "compare", "matmul", "scatter", "host", "sort",
    }
    with pytest.raises(SystemExit):
        parser.parse_args(["x.fasta", "-k", "4", "--impl", "pallas"])
    assert "invalid choice" in capsys.readouterr().err


def test_no_output_packing_option():
    from cfrk_tpu.cli import build_parser

    assert not [o for o in build_parser()._option_string_actions if "pack" in o]


def test_no_pallas_package():
    import importlib.util

    assert importlib.util.find_spec("cfrk_tpu.ops.pallas") is None
    assert importlib.util.find_spec("cfrk_tpu.ops.roofline") is None


# ---------------------------------------------------------------- cache


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the code sets nothing."""
    from cfrk_tpu.runtime.compile_cache import setup_compile_cache

    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert setup_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_unset(monkeypatch):
    """Without it, the cache is <checkout>/.jax_cache."""
    import os

    from cfrk_tpu.runtime.compile_cache import setup_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        got = setup_compile_cache()
        checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(checkout, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
