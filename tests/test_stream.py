"""Streaming driver: equality with the in-memory path, checkpoint/resume,
shape-bucket reuse, and byte-exact golden parity through the stream path."""

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import pytest

from cfrk_tpu.format import parse_cfrk
from cfrk_tpu.io.fasta import decode_codes
from cfrk_tpu.pipeline.count import count_reads, spectrum_file
from cfrk_tpu.pipeline.stream import (
    _len_bucket,
    stream_batches,
    stream_count_file,
    stream_spectrum_file,
)
from cfrk_tpu.runtime.checkpoint import StreamCheckpoint, checkpoint_path

DATA = Path(__file__).parent / "data"
MANIFEST = json.loads((DATA / "goldens.json").read_text())


def _write_fasta(path, reads):
    with open(path, "wb") as f:
        for i, codes in enumerate(reads):
            f.write(b">r%d\n" % i)
            f.write(decode_codes(np.asarray(codes, dtype=np.int8)) + b"\n")


def _random_reads(n, rng, lo=20, hi=300, n_frac=0.02):
    reads = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi))
        r = rng.integers(0, 4, size=ln).astype(np.int8)
        r[rng.random(ln) < n_frac] = -1
        reads.append(r)
    return reads


def test_len_bucket_geometric():
    assert _len_bucket(1) == 128
    assert _len_bucket(128) == 128
    assert _len_bucket(129) == 256
    assert _len_bucket(1000) == 1024


def test_stream_batches_order_and_shapes(tmp_path):
    rng = np.random.default_rng(0)
    reads = _random_reads(25, rng)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    batches = list(stream_batches(fasta, k=4, batch_size=8))
    assert [b.n_reads for b in batches] == [8, 8, 8, 1]
    # Every batch keeps the full batch_size rows (executable reuse).
    assert all(b.codes.shape[0] == 8 for b in batches)
    # Order is preserved across batches.
    flat = [
        b.codes[i, : b.lengths[i]]
        for b in batches
        for i in range(b.n_reads)
    ]
    for got, want in zip(flat, reads):
        np.testing.assert_array_equal(got, want)


def test_stream_count_matches_inmemory(tmp_path):
    rng = np.random.default_rng(1)
    reads = _random_reads(40, rng)
    fasta = tmp_path / "r.fasta"
    out = tmp_path / "r.cfrk"
    _write_fasta(fasta, reads)
    k = 4
    m = stream_count_file(fasta, out, k, batch_size=16)
    assert m.reads == 40 and m.batches == 3
    got = parse_cfrk(out.read_bytes())
    want = count_reads(reads, k)
    np.testing.assert_array_equal(got, want)
    # Checkpoint sidecar removed on success.
    assert not os.path.exists(checkpoint_path(out))


def test_stream_golden_byte_exact(tmp_path):
    """The stream path reproduces the reference goldens byte-for-byte."""
    name, meta = sorted(MANIFEST["files"].items())[1]  # seq2: 710 reads
    out = tmp_path / "g.cfrk"
    stream_count_file(DATA / name, out, MANIFEST["k"], batch_size=128)
    assert hashlib.sha256(out.read_bytes()).hexdigest() == meta["sha256"]


def test_stream_resume_midway(tmp_path):
    """Kill after a prefix of batches; resume completes identically."""
    rng = np.random.default_rng(2)
    reads = _random_reads(50, rng)
    fasta = tmp_path / "r.fasta"
    out = tmp_path / "r.cfrk"
    _write_fasta(fasta, reads)
    k = 3

    # Simulate an interrupted run: stream only the first 2 batches by hand.
    full = tmp_path / "full.cfrk"
    stream_count_file(fasta, full, k, batch_size=16)
    want = full.read_bytes()

    from cfrk_tpu.format import CfrkWriter
    from cfrk_tpu.pipeline.count import count_reads as _cr

    prefix_reads = reads[:32]
    with open(out, "wb") as f:
        w = CfrkWriter(f)
        w.write_batch(_cr(prefix_reads, k, batch_size=16))
        f.flush()
        nbytes = f.tell()
        # Torn tail: garbage after the checkpointed offset must be dropped.
        f.write(b"GARBAGE")
    ckpt = StreamCheckpoint(
        fingerprint=StreamCheckpoint.fingerprint_of(fasta, k, "perread", False),
        reads_done=32,
        out_bytes=nbytes,
    )
    ckpt.save(checkpoint_path(out))

    m = stream_count_file(fasta, out, k, batch_size=16, resume=True)
    assert m.reads == 18  # only the remaining reads were processed
    assert out.read_bytes() == want
    assert not os.path.exists(checkpoint_path(out))


def test_stream_resume_rejects_stale_checkpoint(tmp_path):
    """A checkpoint for a different config restarts from scratch."""
    rng = np.random.default_rng(3)
    reads = _random_reads(10, rng)
    fasta = tmp_path / "r.fasta"
    out = tmp_path / "r.cfrk"
    _write_fasta(fasta, reads)
    stale = StreamCheckpoint(
        fingerprint={"input": "other", "k": 9, "mode": "perread",
                     "canonical": False, "input_size": 0, "input_mtime": 0},
        reads_done=5,
        out_bytes=123,
    )
    stale.save(checkpoint_path(out))
    m = stream_count_file(fasta, out, 3, batch_size=4, resume=True)
    assert m.reads == 10  # full run, stale checkpoint ignored
    got = parse_cfrk(out.read_bytes())
    np.testing.assert_array_equal(got, count_reads(reads, 3))


def test_stream_spectrum_matches_inmemory(tmp_path):
    rng = np.random.default_rng(4)
    reads = _random_reads(30, rng)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    k = 5
    table, m = stream_spectrum_file(fasta, k, batch_size=8)
    want = spectrum_file(fasta, k)
    np.testing.assert_array_equal(table, want)
    assert m.reads == 30


def test_stream_spectrum_resume(tmp_path):
    rng = np.random.default_rng(5)
    reads = _random_reads(24, rng)
    fasta = tmp_path / "r.fasta"
    out = tmp_path / "r.spectrum"
    _write_fasta(fasta, reads)
    k = 4
    want, _ = stream_spectrum_file(fasta, k, batch_size=8)

    # Interrupted run: accumulator for the first 2 of 3 batches.
    from cfrk_tpu.pipeline.count import count_reads as _cr

    acc = _cr(reads[:16], k).sum(axis=0).astype(np.int64)
    cpath = checkpoint_path(out)
    ckpt = StreamCheckpoint(
        fingerprint=StreamCheckpoint.fingerprint_of(fasta, k, "spectrum", False),
        reads_done=16,
    )
    ckpt.save_spectrum(cpath, acc)
    ckpt.save(cpath)

    table, m = stream_spectrum_file(
        fasta, k, batch_size=8, out_path=out, resume=True
    )
    assert m.reads == 8
    np.testing.assert_array_equal(table, want)


def test_metrics_json_line(tmp_path):
    rng = np.random.default_rng(6)
    reads = _random_reads(5, rng)
    fasta = tmp_path / "r.fasta"
    out = tmp_path / "r.cfrk"
    _write_fasta(fasta, reads)
    m = stream_count_file(fasta, out, 2, batch_size=4)
    d = json.loads(m.json_line())
    assert d["reads"] == 5
    assert d["bases"] == sum(len(r) for r in reads)
    assert d["bases_per_sec"] > 0
    assert "dispatch" in d["stages_s"] and "write" in d["stages_s"]


def test_cli_stream_flag(tmp_path):
    rng = np.random.default_rng(7)
    reads = _random_reads(12, rng)
    fasta = tmp_path / "r.fasta"
    out = tmp_path / "r.cfrk"
    _write_fasta(fasta, reads)
    from cfrk_tpu.cli import main

    rc = main([str(fasta), "-k", "3", "-o", str(out), "--stream",
               "--batch-size", "4"])
    assert rc == 0
    got = parse_cfrk(out.read_bytes())
    np.testing.assert_array_equal(got, count_reads(reads, 3))


def test_stream_count_with_mesh(tmp_path):
    """Mesh-sharded streaming equals the single-device path bit-for-bit."""
    import jax

    from cfrk_tpu.parallel import make_mesh

    rng = np.random.default_rng(8)
    reads = _random_reads(40, rng)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    mesh = make_mesh(jax.devices())
    out_m = tmp_path / "m.cfrk"
    out_s = tmp_path / "s.cfrk"
    stream_count_file(fasta, out_m, 4, batch_size=16, mesh=mesh)
    stream_count_file(fasta, out_s, 4, batch_size=16)
    assert out_m.read_bytes() == out_s.read_bytes()


def test_stream_spectrum_with_mesh(tmp_path):
    import jax

    from cfrk_tpu.parallel import make_mesh

    rng = np.random.default_rng(9)
    reads = _random_reads(32, rng)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    mesh = make_mesh(jax.devices(), tp=2)
    table_m, _ = stream_spectrum_file(fasta, 4, batch_size=16, mesh=mesh)
    table_s, _ = stream_spectrum_file(fasta, 4, batch_size=16)
    np.testing.assert_array_equal(np.asarray(table_m), table_s)


def test_stream_mesh_batch_divisibility(tmp_path):
    import jax
    import pytest as _pytest

    from cfrk_tpu.parallel import make_mesh

    mesh = make_mesh(jax.devices())
    with _pytest.raises(ValueError, match="not divisible"):
        stream_count_file("x.fasta", "y.cfrk", 4, batch_size=9, mesh=mesh)


def test_stream_sparse_spectrum(tmp_path):
    from cfrk_tpu.pipeline.count import sparse_spectrum_file
    from cfrk_tpu.pipeline.stream import stream_sparse_spectrum_file

    rng = np.random.default_rng(11)
    reads = _random_reads(30, rng, lo=40, hi=90)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    keys, counts, m = stream_sparse_spectrum_file(
        fasta, 21, batch_size=8, merge_every=2
    )
    want = sparse_spectrum_file(fasta, 21)
    assert dict(zip(keys.tolist(), counts.tolist())) == want
    assert m.reads == 30


def test_stream_sparse_resume(tmp_path):
    from cfrk_tpu.ops.sparse import SparseAccumulator, sparse_spectrum
    from cfrk_tpu.pipeline.count import count_reads as _cr  # noqa: F401
    from cfrk_tpu.pipeline.stream import (
        stream_batches,
        stream_sparse_spectrum_file,
    )

    rng = np.random.default_rng(12)
    reads = _random_reads(24, rng, lo=40, hi=80)
    fasta = tmp_path / "r.fasta"
    out = tmp_path / "r.kmers"
    _write_fasta(fasta, reads)
    k = 17
    keys_w, counts_w, _ = stream_sparse_spectrum_file(fasta, k, batch_size=8)

    # Simulate an interrupted run after 2 of 3 batches.
    acc = SparseAccumulator()
    for batch in list(stream_batches(fasta, k, 8))[:2]:
        hi, lo, c = sparse_spectrum(batch.codes, k, False)
        acc.add(np.asarray(hi), np.asarray(lo), np.asarray(c))
    pk, pc = acc.result_arrays()
    cpath = checkpoint_path(out)
    ckpt = StreamCheckpoint(
        fingerprint=StreamCheckpoint.fingerprint_of(fasta, k, "sparse", False),
        reads_done=16,
    )
    ckpt.save_sparse(cpath, pk, pc)
    ckpt.save(cpath)

    keys, counts, m = stream_sparse_spectrum_file(
        fasta, k, batch_size=8, out_path=out, resume=True
    )
    assert m.reads == 8
    np.testing.assert_array_equal(keys, keys_w)
    np.testing.assert_array_equal(counts, counts_w)


def test_stream_sparse_perread_rows(tmp_path):
    """Streaming k>8 per-read sparse rows == in-memory sparse-row path."""
    from cfrk_tpu.pipeline.count import count_file_sparse_rows

    rng = np.random.default_rng(13)
    reads = _random_reads(30, rng, lo=40, hi=120)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    out_s = tmp_path / "s.cfrk"
    out_m = tmp_path / "m.cfrk"
    m = stream_count_file(fasta, out_s, 11, batch_size=8, nonzero=True)
    assert m.reads == 30
    count_file_sparse_rows(fasta, out_m, 11, batch_size=8)
    assert out_s.read_bytes() == out_m.read_bytes()


def test_stream_nonzero_k8_sparse_route_byte_parity(tmp_path):
    """k <= 8 --nonzero auto-routes through the row-sorted sparse op;
    bytes must equal the dense-kernel + host-nonzero-scan route (forced
    via an explicit impl)."""
    rng = np.random.default_rng(21)
    reads = _random_reads(30, rng, lo=20, hi=90)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    sparse_out = tmp_path / "sparse.cfrk"
    dense_out = tmp_path / "dense.cfrk"
    m = stream_count_file(fasta, sparse_out, 8, batch_size=8, nonzero=True)
    assert m.reads == 30
    # explicit impl keeps the dense kernel (the user's choice wins)
    stream_count_file(
        fasta, dense_out, 8, batch_size=8, nonzero=True, impl="scatter"
    )
    assert sparse_out.read_bytes() == dense_out.read_bytes()
    # canonical too
    s2, d2 = tmp_path / "s2.cfrk", tmp_path / "d2.cfrk"
    stream_count_file(
        fasta, s2, 6, batch_size=8, nonzero=True, canonical=True
    )
    stream_count_file(
        fasta, d2, 6, batch_size=8, nonzero=True, canonical=True,
        impl="scatter",
    )
    assert s2.read_bytes() == d2.read_bytes()


def test_stream_dense_pairs_route_byte_parity(tmp_path):
    """DENSE output (no --nonzero) at k <= 8 also auto-routes through the
    row-sorted sparse op, densified inside the native formatter's bin
    walk; bytes must equal the dense-kernel route (forced via an
    explicit impl)."""
    rng = np.random.default_rng(23)
    reads = _random_reads(30, rng, lo=20, hi=90)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    for k, canonical in ((2, False), (8, False), (5, True)):
        auto_out = tmp_path / f"auto{k}{canonical}.cfrk"
        dense_out = tmp_path / f"dense{k}{canonical}.cfrk"
        m = stream_count_file(
            fasta, auto_out, k, batch_size=8, canonical=canonical
        )
        assert m.reads == 30
        stream_count_file(
            fasta, dense_out, k, batch_size=8, canonical=canonical,
            impl="scatter",
        )
        assert auto_out.read_bytes() == dense_out.read_bytes()


def test_stream_dense_pairs_route_resume(tmp_path):
    """Resume splices byte-identically on the dense pairs route."""
    rng = np.random.default_rng(24)
    reads = _random_reads(40, rng, lo=20, hi=90)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    full = tmp_path / "full.cfrk"
    stream_count_file(fasta, full, 4, batch_size=8)

    out = tmp_path / "r.cfrk"
    from cfrk_tpu.runtime import faults

    faults.arm("batch-written", 2)
    try:
        with pytest.raises(faults.InjectedFault):
            stream_count_file(fasta, out, 4, batch_size=8, resume=True)
    finally:
        faults.disarm()
    m = stream_count_file(fasta, out, 4, batch_size=8, resume=True)
    assert m.reads < 40  # really resumed, not restarted
    assert out.read_bytes() == full.read_bytes()


def test_stream_dense_pairs_route_mesh(tmp_path):
    """Dense pairs route under a dp mesh == single-device bytes."""
    import jax

    from cfrk_tpu.parallel import make_mesh

    rng = np.random.default_rng(25)
    reads = _random_reads(40, rng, lo=20, hi=90)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    mesh = make_mesh(jax.devices()[:8])
    out_m = tmp_path / "m.cfrk"
    out_s = tmp_path / "s.cfrk"
    stream_count_file(fasta, out_m, 4, batch_size=16, mesh=mesh)
    stream_count_file(fasta, out_s, 4, batch_size=16)
    assert out_m.read_bytes() == out_s.read_bytes()


def test_stream_sparse_perread_requires_nonzero(tmp_path):
    import pytest as _pytest

    with _pytest.raises(ValueError, match="requires nonzero"):
        stream_count_file("x.fasta", "y.cfrk", 9)


def test_stream_resume_missing_output_restarts(tmp_path):
    """A checkpoint whose output file is missing/short must restart from
    scratch, not NUL-extend (code-review finding)."""
    rng = np.random.default_rng(14)
    reads = _random_reads(12, rng)
    fasta = tmp_path / "r.fasta"
    out = tmp_path / "r.cfrk"
    _write_fasta(fasta, reads)
    k = 3
    ckpt = StreamCheckpoint(
        fingerprint=StreamCheckpoint.fingerprint_of(fasta, k, "perread", False),
        reads_done=8,
        out_bytes=500,
    )
    ckpt.save(checkpoint_path(out))
    # Case 1: output missing entirely.
    m = stream_count_file(fasta, out, k, batch_size=4, resume=True)
    assert m.reads == 12  # full restart
    got = parse_cfrk(out.read_bytes())
    np.testing.assert_array_equal(got, count_reads(reads, k))
    assert b"\x00" not in out.read_bytes()
    # Case 2: output shorter than checkpointed offset.
    ckpt.save(checkpoint_path(out))
    out.write_bytes(b"short")
    m = stream_count_file(fasta, out, k, batch_size=4, resume=True)
    assert m.reads == 12
    np.testing.assert_array_equal(
        parse_cfrk(out.read_bytes()), count_reads(reads, k)
    )


def test_stream_long_contig_buckets(tmp_path):
    """A 20 kb contig walks the geometric bucket ladder and matches the
    in-memory path (the reference silently truncated reads at 1024 bp)."""
    rng = np.random.default_rng(20)
    reads = [
        rng.integers(0, 4, size=20_000).astype(np.int8),
        rng.integers(0, 4, size=150).astype(np.int8),
        rng.integers(0, 4, size=3_000).astype(np.int8),
    ]
    fasta = tmp_path / "contigs.fasta"
    _write_fasta(fasta, reads)
    out = tmp_path / "c.cfrk"
    m = stream_count_file(fasta, out, 6, batch_size=2)
    assert m.reads == 3
    got = parse_cfrk(out.read_bytes())
    np.testing.assert_array_equal(got, count_reads(reads, 6))


def test_stream_resume_at_every_boundary(tmp_path):
    """Interrupt + resume after each batch boundary; output must always
    equal the uninterrupted run byte-for-byte."""
    rng = np.random.default_rng(21)
    reads = _random_reads(20, rng, lo=20, hi=60)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    k, bs = 3, 4
    full = tmp_path / "full.cfrk"
    stream_count_file(fasta, full, k, batch_size=bs)
    want = full.read_bytes()

    from cfrk_tpu.format import CfrkWriter
    from cfrk_tpu.pipeline.count import count_reads as _cr

    for cut in range(bs, len(reads), bs):
        out = tmp_path / f"r{cut}.cfrk"
        with open(out, "wb") as f:
            w = CfrkWriter(f)
            w.write_batch(_cr(reads[:cut], k, batch_size=bs))
            f.flush()
            nbytes = f.tell()
        ckpt = StreamCheckpoint(
            fingerprint=StreamCheckpoint.fingerprint_of(
                fasta, k, "perread", False
            ),
            reads_done=cut,
            out_bytes=nbytes,
        )
        ckpt.save(checkpoint_path(out))
        m = stream_count_file(fasta, out, k, batch_size=bs, resume=True)
        assert m.reads == len(reads) - cut, f"cut={cut}"
        assert out.read_bytes() == want, f"cut={cut}"


def test_stream_nonzero_k8_resume_midway(tmp_path):
    """Kill + resume on the k <= 8 nonzero sparse route: resumed output
    must equal the uninterrupted run byte-for-byte."""
    rng = np.random.default_rng(31)
    reads = _random_reads(20, rng, lo=20, hi=60)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    k, bs = 8, 4
    full = tmp_path / "full.cfrk"
    stream_count_file(fasta, full, k, batch_size=bs, nonzero=True)
    want = full.read_bytes()

    # simulate a crash after 2 batches by running with a tiny limit:
    # write the first 8 reads' rows, checkpoint, then resume.
    from cfrk_tpu.format import CfrkWriter
    from cfrk_tpu.ops.perread_sparse import count_perread_sparse, pairs_to_host
    import jax.numpy as jnp

    cut = 8
    out = tmp_path / "resumed.cfrk"
    with open(out, "wb") as f:
        w = CfrkWriter(f, nonzero=True)
        for s in range(0, cut, bs):
            batch = [np.asarray(r, np.int8) for r in reads[s : s + bs]]
            from cfrk_tpu.pipeline.batch import pad_reads

            b = pad_reads(batch, bs, 64)
            idx, cnt = pairs_to_host(
                count_perread_sparse(jnp.asarray(b.codes), k, False), bs
            )
            w.write_pairs(idx, cnt)
        f.flush()
        nbytes = f.tell()
    ckpt = StreamCheckpoint(
        fingerprint=StreamCheckpoint.fingerprint_of(
            fasta, k, "perread-nonzero", False
        ),
        reads_done=cut,
        out_bytes=nbytes,
    )
    ckpt.save(checkpoint_path(out))
    m = stream_count_file(fasta, out, k, batch_size=bs, nonzero=True, resume=True)
    assert m.reads == len(reads) - cut
    assert out.read_bytes() == want


def test_stage_timer_accumulates():
    import time as _time

    from cfrk_tpu.runtime.metrics import StageTimer

    t = StageTimer()
    with t():
        _time.sleep(0.01)
    with t():
        _time.sleep(0.01)
    assert t.count == 2
    assert t.total >= 0.02


def test_offset_iterator_matches_plain_and_resume(tmp_path):
    from cfrk_tpu.io.fasta import iter_encoded_with_offsets, iter_fasta_encoded

    rng = np.random.default_rng(30)
    reads = _random_reads(9, rng, lo=10, hi=40)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    pairs = list(iter_encoded_with_offsets(fasta))
    assert len(pairs) == 9
    for (got, off), want in zip(pairs, reads):
        np.testing.assert_array_equal(got, want)
        assert isinstance(off, int)
    # Resuming from record 4's end_offset yields exactly records 5..8.
    rest = list(iter_encoded_with_offsets(fasta, start_offset=pairs[3][1]))
    assert len(rest) == 5
    for (got, _), want in zip(rest, reads[4:]):
        np.testing.assert_array_equal(got, want)
    # FASTQ offsets too.
    fq = tmp_path / "r.fastq"
    with open(fq, "wb") as f:
        for i, codes in enumerate(reads):
            s = decode_codes(codes)
            f.write(b"@q%d\n" % i + s + b"\n+\n" + b"I" * len(s) + b"\n")
    pairs_q = list(iter_encoded_with_offsets(fq))
    assert len(pairs_q) == 9
    rest_q = list(iter_encoded_with_offsets(fq, start_offset=pairs_q[5][1]))
    assert len(rest_q) == 3
    # Gzip: offsets are None, full stream matches.
    import gzip as _gz

    gz = tmp_path / "r.fasta.gz"
    gz.write_bytes(_gz.compress(fasta.read_bytes()))
    pairs_gz = list(iter_encoded_with_offsets(gz))
    assert all(off is None for _, off in pairs_gz)
    assert len(pairs_gz) == 9


def test_stream_resume_uses_offset_seek(tmp_path, monkeypatch):
    """Resume with a checkpointed input_offset must NOT re-parse the
    consumed prefix (seek path), and output equals the full run."""
    rng = np.random.default_rng(31)
    reads = _random_reads(24, rng, lo=20, hi=50)
    fasta = tmp_path / "r.fasta"
    out = tmp_path / "r.cfrk"
    _write_fasta(fasta, reads)
    k, bs = 3, 8
    full = tmp_path / "f.cfrk"
    stream_count_file(fasta, full, k, batch_size=bs)
    want = full.read_bytes()

    # Build a mid-run checkpoint WITH input_offset via a real partial run
    # state: compute offsets for the first 2 batches by hand.
    from cfrk_tpu.format import CfrkWriter
    from cfrk_tpu.io.fasta import iter_encoded_with_offsets
    from cfrk_tpu.pipeline.count import count_reads as _cr

    offsets = [off for _, off in iter_encoded_with_offsets(fasta)]
    with open(out, "wb") as f:
        w = CfrkWriter(f)
        w.write_batch(_cr(reads[:16], k, batch_size=bs))
        f.flush()
        nbytes = f.tell()
    ckpt = StreamCheckpoint(
        fingerprint=StreamCheckpoint.fingerprint_of(fasta, k, "perread", False),
        reads_done=16,
        out_bytes=nbytes,
        input_offset=offsets[15],
    )
    ckpt.save(checkpoint_path(out))

    # Poison skip-based parsing: if resume re-parses from the start it
    # would consume skip_reads and this spy would see i < skip.
    import cfrk_tpu.pipeline.stream as stream_mod

    real = stream_mod.stream_batches
    calls = {}

    def spy(path, k2, bs2, **kw):
        calls.update(kw)
        return real(path, k2, bs2, **kw)

    monkeypatch.setattr(stream_mod, "stream_batches", spy)
    m = stream_count_file(fasta, out, k, batch_size=bs, resume=True)
    assert calls.get("start_offset") == offsets[15]
    assert "skip_reads" not in calls
    assert m.reads == 8
    assert out.read_bytes() == want


def test_resume_tolerates_corrupt_checkpoint(tmp_path):
    rng = np.random.default_rng(32)
    reads = _random_reads(8, rng)
    fasta = tmp_path / "r.fasta"
    out = tmp_path / "r.cfrk"
    _write_fasta(fasta, reads)
    (tmp_path / "r.cfrk.ckpt.json").write_text("{torn json")
    m = stream_count_file(fasta, out, 3, batch_size=4, resume=True)
    assert m.reads == 8  # fresh start, no crash
    np.testing.assert_array_equal(
        parse_cfrk(out.read_bytes()), count_reads(reads, 3)
    )
    # Unknown fields from a future build are ignored, not fatal.
    import json as _json

    ckpt_data = {
        "fingerprint": StreamCheckpoint.fingerprint_of(fasta, 3, "perread", False),
        "reads_done": 0,
        "out_bytes": 0,
        "spectrum_path": None,
        "input_offset": None,
        "field_from_the_future": 42,
    }
    (tmp_path / "r.cfrk.ckpt.json").write_text(_json.dumps(ckpt_data))
    m = stream_count_file(fasta, out, 3, batch_size=4, resume=True)
    assert m.reads == 8


def test_spectrum_sorted_path_matches_scatter(tmp_path):
    """The k>=11 sort+RLE spectrum route (impl='sort') must match the scatter path exactly, in-memory and
    streaming, single-device and mesh."""
    import jax

    from cfrk_tpu.parallel.mesh import make_mesh
    from cfrk_tpu.pipeline.count import spectrum_file
    from cfrk_tpu.pipeline.stream import stream_spectrum_file

    rng = np.random.default_rng(33)
    reads = _random_reads(40, rng, lo=20, hi=80)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)

    k = 11
    want = spectrum_file(fasta, k, impl="scatter")
    got = spectrum_file(fasta, k, impl="sort")
    np.testing.assert_array_equal(got, want)

    got_c = spectrum_file(fasta, k, impl="sort", canonical=True)
    want_c = spectrum_file(fasta, k, impl="scatter", canonical=True)
    np.testing.assert_array_equal(got_c, want_c)

    mesh = make_mesh(jax.devices())
    got_m = spectrum_file(fasta, k, impl="sort", mesh=mesh, batch_size=16)
    np.testing.assert_array_equal(got_m, want)

    # (dp, tp) mesh: the bucket exchange only uses the dp axis (tp
    # columns compute redundantly) but the result must stay exact.
    mesh_tp = make_mesh(jax.devices(), tp=2)
    got_tp = spectrum_file(fasta, k, impl="sort", mesh=mesh_tp, batch_size=16)
    np.testing.assert_array_equal(got_tp, want)

    out = tmp_path / "s.spectrum"
    got_s, m = stream_spectrum_file(
        fasta, k, impl="sort", batch_size=16, out_path=str(out)
    )
    np.testing.assert_array_equal(got_s, want)
    assert m.reads == 40

    got_sm, _ = stream_spectrum_file(
        fasta, k, impl="sort", batch_size=16, out_path=str(out), mesh=mesh
    )
    np.testing.assert_array_equal(got_sm, want)


def test_spectrum_sorted_dense_fold_small_k(tmp_path):
    """The k <= 10 sorted spectrum route (impl='sort') folds batches
    into a dense table with the threaded native histogram
    (DenseFoldAccumulator) — exact vs the scatter path, in-memory and
    streaming, plus kill+resume through the dense accumulator's
    load_arrays."""
    from cfrk_tpu.pipeline.count import spectrum_file
    from cfrk_tpu.pipeline.stream import stream_spectrum_file

    rng = np.random.default_rng(34)
    reads = _random_reads(60, rng, lo=20, hi=160)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)

    for k in (5, 9, 10):
        want = spectrum_file(fasta, k, impl="scatter")
        got = spectrum_file(fasta, k, impl="sort", batch_size=16)
        np.testing.assert_array_equal(got, want)
        out = tmp_path / f"s{k}.spectrum"
        got_s, m = stream_spectrum_file(
            fasta, k, impl="sort", batch_size=16, out_path=str(out)
        )
        np.testing.assert_array_equal(got_s, want)
        assert m.reads == 60

    # Resume splice: crash at the second checkpoint, resume, and the
    # dense-fold accumulator must restore (load_arrays) + complete
    # exactly with no double counting.
    from cfrk_tpu.runtime import faults

    out = tmp_path / "resume.spectrum"
    want = spectrum_file(fasta, 9, impl="scatter")
    faults.arm("checkpoint", 2)
    with pytest.raises(faults.InjectedFault):
        stream_spectrum_file(
            fasta, 9, impl="sort", batch_size=16,
            out_path=str(out), checkpoint_every=1, cleanup=False,
        )
    faults.disarm()
    got_r, m = stream_spectrum_file(
        fasta, 9, impl="sort", batch_size=16, out_path=str(out),
        resume=True, checkpoint_every=1,
    )
    np.testing.assert_array_equal(got_r, want)
    assert m.reads < 60  # resumed, not restarted


def test_gzip_resume_warns_and_completes(tmp_path, capsys):
    """Resuming a gzip input cannot seek (VERDICT round 1 #10): it must
    re-parse with a loud stderr notice and still produce exact output."""
    import gzip as _gzip

    rng = np.random.default_rng(44)
    reads = _random_reads(20, rng, lo=20, hi=60)
    plain = tmp_path / "r.fasta"
    _write_fasta(plain, reads)
    gz = tmp_path / "r.fasta.gz"
    gz.write_bytes(_gzip.compress(plain.read_bytes()))
    out = tmp_path / "r.cfrk"
    k = 3

    full = tmp_path / "full.cfrk"
    stream_count_file(gz, full, k, batch_size=8)
    want = full.read_bytes()

    # Interrupted run: first 8 reads done, no input_offset (gzip).
    from cfrk_tpu.format import CfrkWriter
    from cfrk_tpu.pipeline.count import count_reads as _cr

    with open(out, "wb") as f:
        CfrkWriter(f).write_batch(_cr(reads[:8], k, batch_size=8))
        f.flush()
        nbytes = f.tell()
    ckpt = StreamCheckpoint(
        fingerprint=StreamCheckpoint.fingerprint_of(gz, k, "perread", False),
        reads_done=8,
        out_bytes=nbytes,
    )
    ckpt.save(checkpoint_path(out))

    m = stream_count_file(gz, out, k, batch_size=8, resume=True)
    assert m.reads == 12
    assert out.read_bytes() == want
    assert "decompress the input first" in capsys.readouterr().err


def test_byte_range_partition_exact(tmp_path):
    """Splitting one FASTA into N record-aligned byte ranges and
    streaming each range must reproduce the whole-file run exactly
    (multi-host single-file sharding, BASELINE config 5)."""
    from cfrk_tpu.parallel.distributed import align_to_record

    rng = np.random.default_rng(55)
    reads = _random_reads(57, rng, lo=10, hi=200)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    size = os.path.getsize(fasta)

    full = [
        (b.codes[i, : b.lengths[i]].tolist())
        for b in stream_batches(fasta, 4, 8)
        for i in range(b.n_reads)
    ]
    for n_hosts in (2, 3, 5):
        got = []
        for pi in range(n_hosts):
            start = align_to_record(fasta, size * pi // n_hosts)
            limit = size * (pi + 1) // n_hosts if pi + 1 < n_hosts else size
            for b in stream_batches(
                fasta, 4, 8, start_offset=start, limit_offset=limit
            ):
                for i in range(b.n_reads):
                    got.append(b.codes[i, : b.lengths[i]].tolist())
        assert got == full, f"partition mismatch at n_hosts={n_hosts}"


def test_byte_range_partition_python_fallback(tmp_path, monkeypatch):
    """Same partition exactness through the pure-Python record path."""
    from cfrk_tpu.parallel.distributed import align_to_record
    import cfrk_tpu.pipeline.stream as st

    monkeypatch.setattr("cfrk_tpu.io.native.HAVE_STREAM_NATIVE", False)
    rng = np.random.default_rng(56)
    reads = _random_reads(23, rng, lo=10, hi=90)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    size = os.path.getsize(fasta)
    full = [
        b.codes[i, : b.lengths[i]].tolist()
        for b in st.stream_batches(fasta, 3, 4)
        for i in range(b.n_reads)
    ]
    got = []
    for pi in range(3):
        start = align_to_record(fasta, size * pi // 3)
        limit = size * (pi + 1) // 3 if pi < 2 else size
        for b in st.stream_batches(
            fasta, 3, 4, start_offset=start, limit_offset=limit
        ):
            for i in range(b.n_reads):
                got.append(b.codes[i, : b.lengths[i]].tolist())
    assert got == full


def test_stream_count_byte_range_splice(tmp_path):
    """Per-range .cfrk parts spliced with '\\n' equal the whole-file
    output byte-for-byte (the multi-host CLI's concatenation step)."""
    from cfrk_tpu.parallel.distributed import align_to_record

    rng = np.random.default_rng(57)
    reads = _random_reads(31, rng, lo=15, hi=120)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    size = os.path.getsize(fasta)
    whole = tmp_path / "whole.cfrk"
    stream_count_file(fasta, whole, 4, batch_size=8)

    parts = []
    for pi in range(3):
        start = align_to_record(fasta, size * pi // 3)
        limit = size * (pi + 1) // 3 if pi < 2 else size
        p = tmp_path / f"part{pi}.cfrk"
        stream_count_file(
            fasta, p, 4, batch_size=8, byte_range=(start, limit)
        )
        parts.append(p.read_bytes())
    spliced = b"\n".join(x for x in parts if x)
    assert spliced == whole.read_bytes()


def test_byte_range_random_cuts_fuzz(tmp_path):
    """ANY ascending set of raw cut points must partition the records
    exactly (cuts land mid-record, mid-header, on boundaries...)."""
    from cfrk_tpu.parallel.distributed import align_to_record

    rng = np.random.default_rng(58)
    reads = _random_reads(40, rng, lo=5, hi=150)
    fasta = tmp_path / "r.fasta"
    _write_fasta(fasta, reads)
    size = os.path.getsize(fasta)
    full = [
        b.codes[i, : b.lengths[i]].tolist()
        for b in stream_batches(fasta, 3, 8)
        for i in range(b.n_reads)
    ]
    for trial in range(5):
        n_cuts = int(rng.integers(1, 6))
        cuts = sorted(int(c) for c in rng.integers(0, size, size=n_cuts))
        bounds = [0] + cuts + [size]
        got = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            start = align_to_record(fasta, lo)
            for b in stream_batches(
                fasta, 3, 8, start_offset=start, limit_offset=hi
            ):
                for i in range(b.n_reads):
                    got.append(b.codes[i, : b.lengths[i]].tolist())
        assert got == full, f"trial {trial} cuts {cuts}"


def test_gzip_native_ingest_parity(tmp_path, monkeypatch):
    """gzip inputs stream through the chunked native parser (when built)
    with the same records, shapes, and batch order as the pure-Python
    path — and end_offset=None on every batch (a decompressed-stream
    position is not a seekable resume point)."""
    import gzip as _gzip

    from cfrk_tpu.io.native import HAVE_STREAM_NATIVE
    import cfrk_tpu.pipeline.stream as st

    rng = np.random.default_rng(77)
    reads = _random_reads(37, rng, lo=10, hi=250)
    plain = tmp_path / "r.fasta"
    _write_fasta(plain, reads)
    gz = tmp_path / "r.fasta.gz"
    gz.write_bytes(_gzip.compress(plain.read_bytes()))

    def dump(path):
        return [
            b.codes[i, : b.lengths[i]].tolist()
            for b in st.stream_batches(path, 4, 8)
            for i in range(b.n_reads)
        ]

    native = dump(gz)
    for b in st.stream_batches(gz, 4, 8):
        assert b.end_offset is None
    monkeypatch.setattr("cfrk_tpu.io.native.HAVE_STREAM_NATIVE", False)
    pure = dump(gz)
    assert native == pure
    assert native == dump(plain)
    if not HAVE_STREAM_NATIVE:
        pytest.skip("native extension not built: fallback-only parity")


def test_gzip_native_ingest_fastq_and_skip(tmp_path, monkeypatch):
    """gzip FASTQ sniffing works on decompressed blocks, and skip_reads
    (the gzip resume re-parse) drops exactly that many leading records
    through both the native and pure-Python paths."""
    import gzip as _gzip

    import cfrk_tpu.pipeline.stream as st

    rng = np.random.default_rng(78)
    reads = _random_reads(21, rng, lo=15, hi=120)
    fq = tmp_path / "r.fastq"
    with open(fq, "wb") as f:
        for i, codes in enumerate(reads):
            s = decode_codes(np.asarray(codes, dtype=np.int8))
            f.write(b"@q%d\n" % i + s + b"\n+\n" + b"I" * len(s) + b"\n")
    gz = tmp_path / "r.fastq.gz"
    gz.write_bytes(_gzip.compress(fq.read_bytes()))

    def dump(path, skip=0):
        return [
            b.codes[i, : b.lengths[i]].tolist()
            for b in st.stream_batches(path, 3, 4, skip_reads=skip)
            for i in range(b.n_reads)
        ]

    want = [np.asarray(r, dtype=np.int8).tolist() for r in reads]
    assert dump(gz) == want
    for skip in (1, 5, 20, 21, 30):
        assert dump(gz, skip) == want[skip:], f"skip={skip}"
    monkeypatch.setattr("cfrk_tpu.io.native.HAVE_STREAM_NATIVE", False)
    assert dump(gz, 5) == want[5:]


def test_gzip_byte_addressing_still_rejected(tmp_path):
    """start_offset / byte ranges on gzip input must raise, native or not."""
    import gzip as _gzip

    rng = np.random.default_rng(79)
    reads = _random_reads(5, rng, lo=10, hi=40)
    plain = tmp_path / "r.fasta"
    _write_fasta(plain, reads)
    gz = tmp_path / "r.fasta.gz"
    gz.write_bytes(_gzip.compress(plain.read_bytes()))
    with pytest.raises(ValueError):
        list(stream_batches(gz, 3, 4, start_offset=10))
    # limit_offset alone must raise too: the pure-Python gzip path
    # yields no offsets, so an unobservable limit would silently stream
    # the whole file (double counting in a ranged multi-host run).
    with pytest.raises(ValueError):
        list(stream_batches(gz, 3, 4, limit_offset=100))
    from cfrk_tpu.pipeline.stream import (
        stream_sparse_spectrum_file,
        stream_spectrum_file,
    )

    with pytest.raises(ValueError, match="gzip"):
        stream_spectrum_file(gz, 3, byte_range=(0, 100))
    with pytest.raises(ValueError, match="gzip"):
        stream_sparse_spectrum_file(gz, 31, byte_range=(0, 100))


def test_iter_spill_chunks_exact_partition():
    """Row and position chunking preserves every window exactly and
    respects row/length multiples (the single-batch overflow guard)."""
    from cfrk_tpu.ops.reference import spectrum_np
    from cfrk_tpu.pipeline.count import iter_spill_chunks

    rng = np.random.default_rng(11)
    k = 3
    codes = rng.integers(-1, 4, size=(12, 41)).astype(np.int8)
    want = spectrum_np(codes, k)
    for limit, rm, lm in [(10**9, 1, 1), (200, 1, 1), (200, 4, 1),
                          (20, 1, 1), (20, 1, 5), (45, 2, 3)]:
        got = np.zeros_like(want)
        rows_seen = 0
        for chunk in iter_spill_chunks(codes, k, rm, lm, limit):
            w = chunk.shape[1] - k + 1
            # valid windows per dispatch stay under the limit; -1 column
            # padding can add < lm invalid (zero-count) windows per row
            assert chunk.shape[0] * w < limit + chunk.shape[0] * lm
            if limit > 40:  # row-chunk branch: whole rows, multiples hold
                assert chunk.shape[0] % rm == 0 or chunk.shape[0] == 12
            if lm > 1:
                assert chunk.shape[1] % lm == 0
            got += spectrum_np(chunk, k)
            rows_seen += 0  # position slices revisit rows; count windows only
        np.testing.assert_array_equal(got, want, err_msg=f"{limit},{rm},{lm}")


def test_dense_spectrum_accumulator_tiny_limit():
    """With a tiny injected limit the accumulator must spill repeatedly
    and still produce the exact table (oracle: one-shot spectrum_np)."""
    from cfrk_tpu.ops.reference import spectrum_np
    from cfrk_tpu.pipeline.count import DenseSpectrumAccumulator

    rng = np.random.default_rng(5)
    k = 2
    batches = [rng.integers(-1, 4, size=(6, 33)).astype(np.int8)
               for _ in range(3)]
    want = sum(spectrum_np(b, k) for b in batches)

    calls = []

    def dispatch(arr):
        arr = np.asarray(arr)
        calls.append(arr.shape)
        return spectrum_np(arr, k).astype(np.int32)

    acc = DenseSpectrumAccumulator(
        k, dispatch, np.zeros(4**k, dtype=np.int64), limit=50
    )
    for b in batches:
        acc.add(b)
    np.testing.assert_array_equal(acc.total(), want)
    # the tiny limit must actually have split the 6x33 batches
    assert all(s[0] * (s[1] - k + 1) < 50 for s in calls)
    assert len(calls) > len(batches)


def test_total_reads_survives_resume_of_complete_run(tmp_path):
    """A resumed run whose work is already done processes 0 new reads but
    must still report the output's total row count via total_reads — the
    multi-host splice sidecars depend on it (a 0 would silently drop the
    whole part from the merged .cfrk)."""
    rng = np.random.default_rng(9)
    reads = _random_reads(9, rng, lo=10, hi=40)
    fasta = tmp_path / "t.fasta"
    _write_fasta(fasta, reads)
    out = tmp_path / "o.cfrk"
    m1 = stream_count_file(fasta, out, 4, batch_size=4)
    assert m1.reads == 9 and m1.total_reads == 9
    want = out.read_bytes()
    # Simulate a crash AFTER the final checkpoint save but BEFORE the
    # cleanup: the rerun finds all work done and processes 0 new reads.
    ckpt = StreamCheckpoint(
        fingerprint=StreamCheckpoint.fingerprint_of(fasta, 4, "perread", False),
        reads_done=9,
        out_bytes=len(want),
        input_offset=os.path.getsize(fasta),
    )
    ckpt.save(checkpoint_path(out))
    m2 = stream_count_file(fasta, out, 4, batch_size=4, resume=True)
    assert m2.reads == 0  # nothing new to process
    assert m2.total_reads == 9  # but the part holds every row
    assert out.read_bytes() == want


def test_checkpoint_non_object_json_falls_back(tmp_path):
    """A checkpoint file whose top level is not a JSON object must read
    as 'no checkpoint', not crash resume with an AttributeError."""
    p = tmp_path / "o.cfrk.ckpt.json"
    for content in ("null", "[]", '"str"'):
        p.write_text(content)
        assert StreamCheckpoint.load_if_valid(str(p)) is None


def test_checkpoint_sidecar_paths_absolute(tmp_path, monkeypatch):
    """Accumulator sidecar paths are stored absolute: a run launched with
    a relative out_path must resume from any working directory."""
    monkeypatch.chdir(tmp_path)
    ckpt = StreamCheckpoint(fingerprint={}, reads_done=3)
    ckpt.save_spectrum("rel.ckpt.json", np.arange(4, dtype=np.int64))
    assert os.path.isabs(ckpt.spectrum_path)
    monkeypatch.chdir("/")
    np.testing.assert_array_equal(ckpt.load_spectrum(), np.arange(4))


def test_checkpoint_fingerprint_mtime_ns(tmp_path):
    """Fingerprints use nanosecond mtimes: a same-size rewrite within the
    same second must not match (it would splice two different inputs)."""
    f = tmp_path / "a.fasta"
    f.write_bytes(b">r\nACGT\n")
    fp1 = StreamCheckpoint.fingerprint_of(f, 2, "perread", False)
    os.utime(f, ns=(os.stat(f).st_atime_ns, os.stat(f).st_mtime_ns + 1))
    fp2 = StreamCheckpoint.fingerprint_of(f, 2, "perread", False)
    assert fp1 != fp2


def test_auto_batch_size_ladder():
    """Reads/batch scale inversely with length on every platform;
    contig-class buckets (> 64 kb) drop the 512-read floor so padded
    window streams stay inside device memory."""
    from cfrk_tpu.pipeline.batch import auto_batch_size

    assert auto_batch_size(70) == 65536
    assert auto_batch_size(150) == 32768
    assert auto_batch_size(16000) == 512
    assert auto_batch_size(64000) == 512
    assert auto_batch_size(131000) == 64
    assert auto_batch_size(1_000_000) == 8
    assert auto_batch_size(None) == 8192


def test_stream_sparse_mem_budget_byte_identical(tmp_path):
    """--mem-budget-mb: disk-spilled runs + chunked merge must equal the
    unbounded accumulator exactly (VERDICT r4 #3), and the spill dir
    must be gone after a clean finish."""
    import os

    from cfrk_tpu.io.fasta import decode_codes
    from cfrk_tpu.pipeline.stream import stream_sparse_spectrum_file

    rng = np.random.default_rng(31)
    fasta = tmp_path / "in.fasta"
    with open(fasta, "wb") as f:
        for i in range(600):
            codes = rng.integers(0, 4, size=100).astype(np.int8)
            f.write(b">r%d\n" % i + decode_codes(codes) + b"\n")
    k, bs = 16, 64

    wk, wc, _ = stream_sparse_spectrum_file(fasta, k, batch_size=bs)
    out = tmp_path / "s.tsv"
    gk, gc, m = stream_sparse_spectrum_file(
        fasta, k, batch_size=bs, out_path=out,
        mem_budget_mb=1, checkpoint_every=2,
    )
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    leftovers = [p for p in os.listdir(tmp_path) if ".spill" in p]
    assert not leftovers, leftovers


def test_stream_sparse_budget_needs_out_path(tmp_path):
    from cfrk_tpu.io.fasta import decode_codes
    from cfrk_tpu.pipeline.stream import stream_sparse_spectrum_file

    fasta = tmp_path / "in.fasta"
    with open(fasta, "wb") as f:
        f.write(b">r0\n" + decode_codes(
            np.random.default_rng(0).integers(0, 4, 40).astype(np.int8)
        ) + b"\n")
    with pytest.raises(ValueError, match="out_path"):
        stream_sparse_spectrum_file(fasta, 16, mem_budget_mb=1)


def test_spectrum_stream_stage_attribution(tmp_path):
    """Stage honesty (VERDICT r4 #2): the device-queue drain must be
    booked under 'drain', never inside 'checkpoint' (which is sidecar
    I/O only); the sparse driver books enqueue/fetch/fold separately."""
    from cfrk_tpu.io.fasta import decode_codes
    from cfrk_tpu.pipeline.stream import (
        stream_sparse_spectrum_file,
        stream_spectrum_file,
    )

    rng = np.random.default_rng(3)
    fasta = tmp_path / "in.fasta"
    with open(fasta, "wb") as f:
        for i in range(40):
            f.write(b">r%d\n" % i + decode_codes(
                rng.integers(0, 4, 60).astype(np.int8)) + b"\n")

    out = tmp_path / "t.spec"
    _, m = stream_spectrum_file(
        fasta, 3, batch_size=8, out_path=out, checkpoint_every=2,
    )
    assert "drain" in m.stages and "checkpoint" in m.stages
    assert "dispatch" in m.stages

    _, _, m2 = stream_sparse_spectrum_file(fasta, 16, batch_size=8)
    # fold runs on the background worker ("fold_bg"); "fold_wait" is
    # the exposed main-thread wait.
    assert {"dispatch", "materialize", "fold_bg", "fold_wait"} <= set(
        m2.stages
    )


def test_valid_pair_prefix_exact():
    """Bucket-pad columns of sorted-RLE rows are structurally
    (sentinel, 0): slicing to the TRUE max window count (reads 100 bp
    inside a 256-wide bucket) must preserve every nonzero cell."""
    from cfrk_tpu.ops.perread_sparse import (
        count_perread_sparse,
        count_perread_sparse_large,
        valid_pair_prefix,
    )

    rng = np.random.default_rng(9)
    codes = np.full((16, 256), -1, dtype=np.int8)  # 256-bucket padding
    codes[:, :100] = rng.integers(0, 4, size=(16, 100)).astype(np.int8)
    codes[2, 5] = -1  # an internal N too
    for k, fn in ((9, count_perread_sparse), (31, count_perread_sparse_large)):
        w = 100 - k + 1  # true windows; rows are 256-k+1 wide
        rows = tuple(np.asarray(a) for a in fn(codes, k))
        assert rows[-1].shape[1] == 256 - k + 1
        sliced = valid_pair_prefix(rows, w)
        assert (rows[-1][:, w:] == 0).all()  # pad columns carry nothing
        assert int((rows[-1] > 0).sum()) == int((sliced[-1] > 0).sum())
        for a_full, a_sl in zip(rows, sliced):
            np.testing.assert_array_equal(a_full[:, :w], a_sl)


def test_malloc_pinning_applies_on_glibc():
    """The RSS scale-invariance story depends on pinning glibc's mmap
    threshold (docs/PERF.md); it must report success on glibc hosts."""
    import ctypes

    from cfrk_tpu.runtime.metrics import pin_malloc_for_streaming

    try:
        ctypes.CDLL("libc.so.6")
    except OSError:
        pytest.skip("not a glibc platform")
    assert pin_malloc_for_streaming() is True
