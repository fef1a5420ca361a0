"""Constant-memory streaming driver: FASTA of any size → `.cfrk` / spectrum.

The in-memory driver (pipeline/count.py) holds every read; this one holds
at most a few batches, for assembly-scale runs (BASELINE.json config 5,
≥100M reads).  It is the replacement for the reference's
chunk machinery (``src/main.cu:160-230``: SelectChunk + pthread fan-out +
per-thread streams), restructured around XLA's execution model:

* **one compiled executable per shape bucket** — each batch is padded to
  a geometric length bucket (128·2^j), so a whole run touches only a
  handful of shapes and every batch after the first reuses a cached
  executable (the reference re-derived grid configs per chunk,
  ``src/kmer_main.cu:66-97``);
* **parse/compute overlap** — a background thread parses and packs the
  next batches into a bounded queue while the device runs (the
  reference used 12 OpenMP host threads for chunk copies,
  ``src/main.cu:186-190``; here one thread suffices because packing is
  NumPy-vectorised and XLA's dispatch is async);
* **bounded device queue** — results are materialised two batches behind
  enqueue, keeping the device busy without unbounded live buffers
  (replaces per-thread CUDA default streams, ``src/Makefile:3``);
* **checkpoint/resume** after every flushed batch (runtime/checkpoint.py)
  — absent from the reference, whose restart unit was a whole shard.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Iterator

import jax
import numpy as np

from ..format import CfrkWriter
from ..ops.perread import count_perread
from ..ops.spectrum import spectrum as spectrum_op
from ..runtime import faults
from ..runtime.checkpoint import StreamCheckpoint, checkpoint_path
from ..runtime.metrics import RunMetrics
from .batch import (
    ReadBatch,
    len_bucket as _len_bucket,
    pad_reads,
    pad_reads_flat,
)

__all__ = [
    "stream_batches",
    "stream_count_file",
    "stream_spectrum_file",
    "stream_sparse_spectrum_file",
]

_SENTINEL = None


def stream_batches(
    path,
    k: int,
    batch_size: int,
    *,
    skip_reads: int = 0,
    start_offset: int | None = None,
    limit_offset: int | None = None,
    len_base: int = 128,
    min_qual: int = 0,
) -> Iterator[ReadBatch]:
    """Stream fixed-shape batches from a FASTA file, preserving read order.

    Each batch is padded to the geometric length bucket of its longest
    read and carries ``end_offset`` (input byte position past its last
    record, plain files only).  Resume paths: ``start_offset`` seeks
    straight to a record boundary (O(1), plain files); ``skip_reads``
    drops that many leading records by re-parsing (gzip fallback).
    ``limit_offset`` stops before the first record STARTING at or past
    it (byte-range host sharding; see parallel/distributed).
    """
    from ..io.fasta import is_stdin, iter_encoded_with_offsets
    from ..io.native import HAVE_STREAM_NATIVE

    if is_stdin(path):
        # Pipe ingest ('-'): sequential only.  Offsets never exist
        # (end_offset=None like plain gzip); skip_reads still works for
        # completeness, though resume is refused upstream (a re-run
        # reads a DIFFERENT stream).
        if start_offset or limit_offset is not None:
            raise ValueError(
                "byte offsets cannot address a pipe; '-' reads stdin "
                "sequentially"
            )
        from ..io.fasta import open_stdin_reads

        stream = open_stdin_reads()
        if HAVE_STREAM_NATIVE and (min_qual == 0 or _qual_native_ok()):
            yield from _stream_batches_flat(
                stream, k, batch_size, None, len_base, None,
                skip_reads=skip_reads, decompress=False, min_qual=min_qual,
            )
            return
        from ..io.fasta import encode_seq, iter_reads

        buf: list[np.ndarray] = []
        for i, (_, s) in enumerate(iter_reads(stream, min_qual)):
            if i < skip_reads:
                continue
            buf.append(encode_seq(s))
            if len(buf) == batch_size:
                longest = max(max(len(r) for r in buf), k)
                yield pad_reads(buf, batch_size, _len_bucket(longest, len_base))
                buf = []
        if buf:
            longest = max(max(len(r) for r in buf), k)
            yield pad_reads(buf, batch_size, _len_bucket(longest, len_base))
        return

    gz = _is_gzip(path)
    if gz and (start_offset or limit_offset is not None):
        from ..io.bgzf import is_bgzf

        # Raise here, not just in stream_count_file: a limit_offset the
        # pure-Python gzip path cannot observe (offsets are all None)
        # would otherwise stream the WHOLE file — silent double counting
        # in a ranged multi-host run.  Exception: bgzf offsets are
        # DECOMPRESSED positions, seekable via block metadata — both
        # resume and byte-range sharding work.
        if not is_bgzf(path):
            raise ValueError(
                "byte offsets cannot address a gzip stream; "
                "decompress the input first (or recompress with bgzip)"
            )
    if HAVE_STREAM_NATIVE and (min_qual == 0 or _qual_native_ok()):
        # Chunked native ingest: the C++ parser encodes 64 MB blocks in
        # one pass and the flat packer assembles batches without any
        # per-read Python loop — the reference's single-pass C ingest
        # (src/fastaIO.h:24-102) at streaming scale.  gzip inputs stream
        # through the same parser on decompressed blocks (offsets are
        # then meaningless for resume, so batches carry end_offset=None
        # and checkpoints fall back to record counts).
        yield from _stream_batches_flat(
            path, k, batch_size, start_offset, len_base, limit_offset,
            skip_reads=skip_reads, decompress=gz, min_qual=min_qual,
        )
        return

    buf: list[np.ndarray] = []
    last_off: int | None = None
    prev_end = start_offset or 0  # start position of the next record

    def flush() -> ReadBatch:
        longest = max(max(len(r) for r in buf), k)
        b = pad_reads(buf, batch_size, _len_bucket(longest, len_base))
        return dataclasses.replace(b, end_offset=last_off)

    for i, (codes, off) in enumerate(
        iter_encoded_with_offsets(
            path, start_offset=start_offset, min_qual=min_qual
        )
    ):
        if limit_offset is not None and prev_end >= limit_offset:
            break
        if off is not None:
            prev_end = off
        if i < skip_reads:
            continue
        buf.append(codes)
        last_off = off
        if len(buf) == batch_size:
            yield flush()
            buf = []
    if buf:
        # Tail batch: keep the full batch_size shape so it hits the same
        # compiled executable as every other batch of its length bucket.
        yield flush()


def _qual_native_ok() -> bool:
    """True when the built extension supports the min_qual argument (a
    stale .so degrades min_qual runs to the pure-Python parser instead
    of crashing in the lookahead thread)."""
    from ..io.native import HAVE_QUAL_NATIVE

    return HAVE_QUAL_NATIVE


def _is_gzip(path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _stream_batches_flat(
    path,
    k: int,
    batch_size: int,
    start_offset: int | None,
    len_base: int,
    limit_offset: int | None = None,
    skip_reads: int = 0,
    decompress: bool = False,
    min_qual: int = 0,
) -> Iterator[ReadBatch]:
    """Native-ingest batch assembly: flat blocks in, fixed-shape padded
    batches out.  Shape semantics identical to the per-read path
    (geometric length bucket of each batch's longest read; tail batch
    keeps the full batch_size shape).  ``skip_reads`` drops leading
    records block-wise (gzip resume re-parse, at parser speed);
    ``decompress`` streams a gzip input and yields ``end_offset=None``
    (a decompressed-stream position is not a seekable resume point)."""
    from ..io.native import iter_record_blocks_native

    flat = np.empty(0, np.int8)
    lens = np.empty(0, np.int64)
    offs = np.empty(0, np.int64)

    # bgzf offsets are decompressed positions and remain valid resume
    # points (BgzfReader.seek_decompressed); plain-gzip offsets are not,
    # and a pipe's stream positions never are.
    if hasattr(path, "read"):
        offsets_ok = False
    elif decompress:
        from ..io.bgzf import is_bgzf

        offsets_ok = is_bgzf(path)
    else:
        offsets_ok = True

    def cut_batch(n: int) -> ReadBatch:
        nonlocal flat, lens, offs
        nbytes = int(lens[:n].sum())
        longest = max(int(lens[:n].max(initial=0)), k)
        b = pad_reads_flat(
            flat[:nbytes], lens[:n], batch_size, _len_bucket(longest, len_base)
        )
        b = dataclasses.replace(
            b, end_offset=int(offs[n - 1]) if offsets_ok else None
        )
        flat = flat[nbytes:]
        lens = lens[n:]
        offs = offs[n:]
        return b

    for bflat, blens, boffs in iter_record_blocks_native(
        path, start_offset=start_offset, limit_offset=limit_offset,
        decompress=decompress, min_qual=min_qual,
    ):
        if skip_reads:
            n = min(skip_reads, len(blens))
            nbytes = int(blens[:n].sum())
            bflat = bflat[nbytes:]
            blens = blens[n:]
            boffs = boffs[n:]
            skip_reads -= n
            if not len(blens):
                continue
        flat = np.concatenate([flat, bflat]) if flat.size else np.asarray(bflat)
        lens = np.concatenate([lens, blens]) if lens.size else np.asarray(blens)
        offs = np.concatenate([offs, boffs]) if offs.size else np.asarray(boffs)
        while len(lens) >= batch_size:
            yield cut_batch(batch_size)
    if len(lens):
        yield cut_batch(len(lens))



def _resume_fingerprint(
    path, k, mode_tag, canonical, out_path, byte_range, min_qual=0,
    resume=False,
):
    """Shared resume plumbing for the three stream drivers: reject gzip
    byte ranges, tag ranged runs as a distinct unit of work (resume must
    never mix a ranged checkpoint with a whole-file one), and build the
    (fingerprint, checkpoint-path) pair."""
    from ..io.fasta import is_stdin

    if is_stdin(path):
        # A pipe is a one-shot stream: a resumed re-run would read a
        # DIFFERENT stream, and ranges have nothing to address.
        if byte_range is not None:
            raise ValueError("byte_range cannot address a pipe ('-')")
        if resume:
            raise ValueError(
                "cannot resume from a pipe ('-'); stream from a file "
                "for checkpoint/resume"
            )
        fp = {
            "input": "<stdin>", "k": k, "mode": mode_tag,
            "canonical": bool(canonical),
        }
        if min_qual:
            fp["min_qual"] = int(min_qual)
        return fp, checkpoint_path(out_path) if out_path else None
    if byte_range is not None:
        if _is_gzip(path):
            from ..io.bgzf import is_bgzf

            if not is_bgzf(path):
                raise ValueError(
                    "byte_range needs a plain or bgzf input: a plain "
                    "gzip stream has no random access"
                )
        mode_tag += f"-range{byte_range[0]}-{byte_range[1]}"
    fp = StreamCheckpoint.fingerprint_of(path, k, mode_tag, canonical)
    if min_qual:
        # Part of the unit-of-work identity: resuming a min_qual run
        # without the flag (or vice versa) would splice differently
        # masked counts.  Only set when active, so checkpoints written
        # before the flag existed still match unmasked runs.
        fp["min_qual"] = int(min_qual)
    cpath = checkpoint_path(out_path) if out_path else None
    return fp, cpath


def _batch_feeder(gen: Iterator[ReadBatch], q: queue.Queue, err: list,
                  stop: threading.Event) -> None:
    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        for b in gen:
            if not put(b):
                return
    except BaseException as e:  # surface parser errors in the consumer
        err.append(e)
    finally:
        put(_SENTINEL)
        gen.close()  # release the input file handle promptly

def _prefetched(
    gen: Iterator[ReadBatch],
    depth: int = 4,
    metrics: RunMetrics | None = None,
) -> Iterator[ReadBatch]:
    """Run ``gen`` in a background thread with a bounded queue.

    If the consumer stops early (error downstream), the feeder is
    signalled via ``stop`` so it does not block forever on a full queue
    holding the input file open.  With ``metrics``, the time the
    CONSUMER blocks waiting for the parser is accumulated under the
    "parse_wait" stage — the *exposed* ingest time (zero when parsing
    fully overlaps device compute)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()
    t = threading.Thread(
        target=_batch_feeder, args=(gen, q, err, stop), daemon=True
    )
    t.start()
    try:
        while True:
            if metrics is not None:
                with metrics.stage("parse_wait"):
                    item = q.get()
            else:
                item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=5)


def _resume_batches(
    path, k: int, batch_size: int, ckpt, byte_range=None, min_qual=0
) -> Iterator[ReadBatch]:
    """Batch stream honouring a checkpoint: O(1) seek for plain files,
    re-parse + skip for gzip (with a loud warning — decompress first for
    large inputs; a gzip stream has no random access, so byte-offset
    resume cannot apply).  ``byte_range=(start, limit)`` restricts the
    stream to records starting in that range (multi-host single-file
    sharding; plain files only)."""
    start = byte_range[0] if byte_range else None
    limit = byte_range[1] if byte_range else None
    if ckpt.reads_done and ckpt.input_offset is not None:
        return stream_batches(
            path, k, batch_size, start_offset=ckpt.input_offset,
            limit_offset=limit, min_qual=min_qual,
        )
    if ckpt.reads_done and _is_gzip(path):
        import sys

        print(
            f"# resume on gzip input re-parses {ckpt.reads_done} records "
            "from the start (no random access in a gzip stream); "
            "decompress the input first for large runs",
            file=sys.stderr,
        )
    return stream_batches(
        path, k, batch_size, skip_reads=ckpt.reads_done,
        start_offset=start, limit_offset=limit, min_qual=min_qual,
    )


def _make_dispatch(k, canonical, impl, mesh, mode, seqpar=False):
    """Batch → device-counts callable, single-device or mesh-sharded."""
    import jax.numpy as jnp

    if mesh is not None and seqpar:
        from ..parallel.seqpar import count_perread_seqpar, spectrum_seqpar

        if mode == "perread":
            return lambda arr: count_perread_seqpar(
                arr, k, mesh, canonical=canonical, impl=impl
            )
        return lambda arr: spectrum_seqpar(
            arr, k, mesh, canonical=canonical, impl=impl
        )

    if mesh is None:
        if mode == "perread":
            # int16 counts halve the output bytes and D2H traffic; safe
            # whenever the per-read window count stays below 2**15
            # (counts are bounded by it).
            return lambda arr: count_perread(
                arr, k, canonical=canonical, impl=impl,
                out_dtype=(
                    jnp.int16 if arr.shape[1] - k + 1 < 2**15 else jnp.int32
                ),
            )
        return lambda arr: spectrum_op(arr, k, canonical=canonical, impl=impl)
    from ..parallel.sharded import count_perread_sharded, spectrum_sharded

    if mode == "perread":
        return lambda arr: count_perread_sharded(
            arr, k, mesh, canonical=canonical, impl=impl
        )
    return lambda arr: spectrum_sharded(arr, k, mesh, canonical=canonical, impl=impl)


def _check_mesh_batch(mesh, batch_size: int) -> None:
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(
            f"batch_size {batch_size} not divisible by mesh size {mesh.size}"
        )


def stream_count_file(
    path,
    out_path,
    k: int,
    *,
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int = 8192,
    resume: bool = False,
    checkpoint_every: int = 1,
    nonzero: bool = False,
    mesh=None,
    seqpar: bool = False,
    byte_range=None,
    metrics: RunMetrics | None = None,
    min_qual: int = 0,
) -> RunMetrics:
    """Stream a FASTA file into a `.cfrk` file with bounded memory.

    Checkpoints after every ``checkpoint_every`` flushed batches; with
    ``resume=True`` a matching checkpoint restarts the run where it
    stopped.  The checkpoint sidecar is removed on successful completion.
    With ``mesh`` given, each batch is sharded rows-over-devices
    (zero-collective data parallelism; batch_size must divide evenly).

    ``nonzero=True`` rows route through the sort-based sparse per-read
    op whenever the kernel choice is ours (impl='auto', no seqpar): the
    drain ships (idx, count) pairs instead of the dense
    matrix — mandatory past k=8 (dense 4**k rows are impossible), a
    large D2H/host win below it; bytes identical either way.
    """
    if str(out_path).endswith(".gz"):
        raise ValueError(
            "streaming .gz output is unsupported (checkpoints need byte "
            "offsets); write plain .cfrk and compress afterwards, or use "
            "the in-memory driver (cfrk_tpu.count_file + write_cfrk)"
        )
    if k > 8 and not nonzero:
        raise ValueError(
            f"per-read k={k} > 8 requires nonzero=True (dense 4**k "
            "rows would be gigabytes per read)"
        )
    # Whenever the kernel choice is ours, rows go through the row-sorted
    # sparse op: each read has <= W nonzero cells of 4**k, so the drain
    # ships (idx, count) pairs instead of the dense matrix — ~57x less
    # D2H at k=8/150 bp and no dense host materialisation.  This holds
    # for DENSE output too (not just --nonzero): the native formatter
    # densifies inside the bin walk the dense text format forces anyway
    # (format_dense_pairs), so bytes are identical either way (pinned by
    # tests).  An explicit impl request keeps the dense kernel the user
    # asked for; seqpar keeps the dense position-sharded path
    # (a per-row sort needs the whole row on one device).
    sparse_rows = (nonzero and k > 8) or (
        impl == "auto" and not seqpar
    )
    if sparse_rows:
        if seqpar:
            raise ValueError(
                "sparse per-read rows do not compose with seqpar "
                "(per-row sort needs the whole row on one device)"
            )
        from ..ops.perread_sparse import narrow_for_fetch

        if mesh is not None:
            # Rows shard over the mesh with zero collectives, exactly
            # like dense per-read mode (the default auto-mesh must not
            # break k > 8 --nonzero streaming).
            from ..parallel.sharded import count_perread_sparse_sharded

            def dispatch(arr):
                return narrow_for_fetch(
                    count_perread_sparse_sharded(
                        arr, k, mesh, canonical=canonical
                    ),
                    k,
                )
        else:
            from ..ops.perread_sparse import count_perread_rows

            dispatch = lambda arr: narrow_for_fetch(  # noqa: E731
                count_perread_rows(arr, k, canonical), k
            )
    else:
        dispatch = _make_dispatch(
            k, canonical, impl, mesh, "perread", seqpar
        )
    if not seqpar:  # seqpar shards positions, not batch rows
        _check_mesh_batch(mesh, batch_size)
    m = metrics or RunMetrics(k=k, mode="perread")
    fp, cpath = _resume_fingerprint(
        path, k, "perread-nonzero" if nonzero else "perread",
        canonical, out_path, byte_range, min_qual, resume,
    )

    ckpt = StreamCheckpoint(fingerprint=fp)
    if resume and os.path.exists(cpath):
        prev = StreamCheckpoint.load_if_valid(cpath)
        if prev is not None and prev.matches(fp):
            # The checkpoint only counts if the output really contains
            # the bytes it promises: a missing/short file (crash before
            # the data hit disk) would otherwise be NUL-extended by
            # truncate() and silently lose the first reads_done reads.
            if (
                os.path.exists(out_path)
                and os.path.getsize(out_path) >= prev.out_bytes
            ):
                ckpt = prev

    mode = "r+b" if (ckpt.reads_done and os.path.exists(out_path)) else "wb"
    with open(out_path, mode) as f:
        if ckpt.reads_done:
            f.truncate(ckpt.out_bytes)  # drop any torn tail
            f.seek(ckpt.out_bytes)
        w = CfrkWriter(f, continuing=ckpt.reads_done > 0, nonzero=nonzero)

        # O(1) seek resume for plain files; gzip warns and re-parses.
        gen = _resume_batches(path, k, batch_size, ckpt, byte_range, min_qual)
        pending: list = []
        since_ckpt = 0

        def drain_one() -> None:
            nonlocal since_ckpt
            n, dev_counts, end_off = pending.pop(0)
            with m.stage("materialize"):
                if sparse_rows:
                    from ..ops.perread_sparse import pairs_to_host

                    pairs = pairs_to_host(dev_counts, n)
                else:
                    counts = np.asarray(dev_counts)[:n]
            with m.stage("write"):
                if sparse_rows and nonzero:
                    w.write_pairs(*pairs)
                elif sparse_rows:
                    w.write_pairs_dense(*pairs, 4**k)
                else:
                    w.write_batch(counts)
            # Fault site: dies with this batch's rows written but NOT
            # checkpointed — resume must truncate the torn tail and redo
            # the batch (runtime/faults.py; no-op unless a test armed it).
            faults.trip("batch-written")
            ckpt.reads_done += n
            ckpt.input_offset = end_off
            since_ckpt += 1
            if since_ckpt >= checkpoint_every:
                with m.stage("checkpoint"):
                    # fsync the DATA before the fsynced checkpoint JSON
                    # claims it exists (write-ahead ordering).
                    f.flush()
                    os.fsync(f.fileno())
                    ckpt.out_bytes = f.tell()
                    ckpt.save(cpath)
                since_ckpt = 0

        for batch in _prefetched(gen, metrics=m):
            with m.stage("dispatch"):
                dev = dispatch(jax.numpy.asarray(batch.codes))
            pending.append((batch.n_reads, dev, batch.end_offset))
            m.batches += 1
            m.reads += batch.n_reads
            m.bases += int(batch.lengths.sum())
            if len(pending) > 2:
                drain_one()
        while pending:
            drain_one()
        # Make the tail durable BEFORE the checkpoint is removed — a
        # crash after cleanup must not leave a silently truncated file.
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(cpath):
        ckpt.cleanup(cpath)
    m.total_reads = ckpt.reads_done
    return m


def stream_spectrum_file(
    path,
    k: int,
    *,
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int = 8192,
    out_path=None,
    resume: bool = False,
    checkpoint_every: int = 16,
    mesh=None,
    seqpar: bool = False,
    cleanup: bool = True,
    byte_range=None,
    metrics: RunMetrics | None = None,
    min_qual: int = 0,
) -> tuple[np.ndarray, RunMetrics]:
    """Stream a FASTA file into one global dense spectrum [4**k] int64.

    The accumulator lives ON DEVICE (int64 add per batch, enqueued
    asynchronously) and is fetched to host only at checkpoints and at
    the end — a 4**15 table is 4 GB, so per-batch host round-trips
    would dominate the run.  ``out_path`` is only used to place the
    checkpoint sidecar; pass the eventual output path.  With ``mesh``,
    each batch's table is computed sharded (psum/psum_scatter merge)
    before the device accumulate.
    """
    if impl == "sort":
        # Sorted-route dense spectra stream through the sparse sort+RLE
        # machinery (same computation, same checkpoints) and densify
        # once at the end; k <= 10 folds each batch into a dense table
        # with the threaded native histogram
        # (ops/sparse.DenseFoldAccumulator).
        keys, counts, m2 = stream_sparse_spectrum_file(
            path, k, canonical=canonical, batch_size=batch_size,
            out_path=out_path, resume=resume,
            checkpoint_every=checkpoint_every, mesh=mesh,
            cleanup=cleanup, byte_range=byte_range, metrics=metrics,
            min_qual=min_qual, seqpar=seqpar,
        )
        total = np.zeros(4**k, dtype=np.int64)
        total[keys] = counts
        return total, m2

    if not seqpar:  # seqpar shards positions, not batch rows
        _check_mesh_batch(mesh, batch_size)
    dispatch = _make_dispatch(
        k, canonical, impl, mesh, "spectrum", seqpar=seqpar
    )
    m = metrics or RunMetrics(k=k, mode="spectrum")
    fp, cpath = _resume_fingerprint(
        path, k, "spectrum", canonical, out_path, byte_range, min_qual,
        resume,
    )

    ckpt = StreamCheckpoint(fingerprint=fp)
    base = np.zeros(4**k, dtype=np.int64)
    if resume and cpath and os.path.exists(cpath):
        prev = StreamCheckpoint.load_if_valid(cpath)
        if prev is not None and prev.matches(fp):
            try:
                base = prev.load_spectrum()
                ckpt = prev
            except (OSError, ValueError, KeyError):
                pass  # torn sidecar: restart from scratch

    # Device accumulator is int32 (device int64 needs the x64 flag);
    # it spills into the host int64 base before the windows added since
    # the last spill could overflow any single int32 bin — including a
    # SINGLE batch beyond the limit, which the accumulator dispatches
    # in row/position slices (pipeline/count.DenseSpectrumAccumulator).
    from .count import SPILL_LIMIT, DenseSpectrumAccumulator

    acc = DenseSpectrumAccumulator(
        k, dispatch, base,
        row_multiple=(mesh.size if mesh is not None and not seqpar else 1),
        len_multiple=(
            mesh.shape.get("sp", 1) if mesh is not None and seqpar else 1
        ),
    )

    gen = _resume_batches(path, k, batch_size, ckpt, byte_range, min_qual)
    since_ckpt = 0
    for batch in _prefetched(gen, metrics=m):
        batch_windows = batch.codes.shape[0] * (batch.codes.shape[1] - k + 1)
        if acc.windows + batch_windows >= SPILL_LIMIT:
            with m.stage("drain"):
                acc.spill()
        with m.stage("dispatch"):
            acc.add(batch.codes)
        m.batches += 1
        m.reads += batch.n_reads
        m.bases += int(batch.lengths.sum())
        ckpt.reads_done += batch.n_reads
        ckpt.input_offset = batch.end_offset
        since_ckpt += 1
        if cpath and since_ckpt >= checkpoint_every:
            # "drain" is the device-queue sync + table D2H — it
            # swallows every enqueued batch's device time, so it must
            # NOT be booked as checkpoint I/O.
            with m.stage("drain"):
                acc.spill()
            with m.stage("checkpoint"):
                ckpt.save_spectrum(cpath, acc.base)
                ckpt.save(cpath)
            since_ckpt = 0

    with m.stage("drain"):
        total = acc.total()
    # cleanup=False keeps the checkpoint until the CALLER has written
    # the real output (runtime.checkpoint.cleanup_checkpoint) — a crash
    # during that write stays resumable.
    if cleanup and cpath and os.path.exists(cpath):
        ckpt.cleanup(cpath)
    m.total_reads = ckpt.reads_done
    return total, m


def stream_sparse_spectrum_file(
    path,
    k: int,
    *,
    canonical: bool = False,
    batch_size: int = 8192,
    out_path=None,
    resume: bool = False,
    checkpoint_every: int = 64,
    merge_every: int = 32,
    cleanup: bool = True,
    mesh=None,
    slack: float = 2.0,
    byte_range=None,
    metrics: RunMetrics | None = None,
    min_qual: int = 0,
    seqpar: bool = False,
    mem_budget_mb: int | None = None,
    finalize: str = "arrays",
):
    """Stream a FASTA file into a sparse spectrum for large k (16..31).

    Returns (keys uint64 sorted, counts int64, metrics).  Bounded
    memory: per-batch sorted triples fold into one merged (keys, counts)
    pair every ``merge_every`` batches (ops/sparse.SparseAccumulator);
    checkpoints persist the merged arrays as ``.npz``.

    ``mem_budget_mb`` caps the host accumulator for k >= 11: merged
    arrays beyond the budget spill to sorted on-disk runs under
    ``<out>.ckpt.json.spill/`` and the final result multiway-merges
    them in bounded chunks (ops/sparse.SpillingSparseAccumulator).
    Checkpoints then record the APPEND-ONLY run list instead of
    rewriting the whole accumulator — O(new data) per checkpoint.
    Needs ``out_path``; byte-identical to the unbounded run.

    Batches pipeline twice over: the device sort for batch i+1 runs
    while batch i's pairs are fetched (bounded pending queue), and the
    host fold runs on a single worker thread so it overlaps the NEXT
    fetch.  Stage attribution: "dispatch" is the async device enqueue,
    "materialize" the device wait + D2H fetch, "fold_bg" the
    background fold work, "fold_wait" the exposed main-thread join
    (checkpoints and finish).

    ``finalize="accumulator"`` returns ``(accumulator, None, metrics)``
    instead of materialised arrays: the caller streams
    ``iter_merged_chunks()`` into its writer (bounded-memory output for
    >= 100M-read runs) and owns the checkpoint cleanup.

    With ``mesh`` (1-axis or (dp, tp)): each batch routes its keys
    through the all_to_all bucket exchange (parallel/bucket.py, the
    BASELINE config-4 path) so the sort + RLE runs sharded on-chip;
    bucket-box overflow retries with doubled ``slack`` automatically and
    later batches start at the discovered capacity.  With ``seqpar``
    the mesh is a 1-D ``sp`` mesh instead: each device sorts its own
    POSITION slice's windows (parallel/seqpar.spectrum_seqpar_triples)
    — the long-contig shape where row sharding has nothing to shard.
    """
    from ..ops.perread_sparse import (
        count_perread_rows,
        narrow_for_fetch,
        valid_pair_prefix,
    )
    from ..ops.sparse import (
        DenseFoldAccumulator,
        SparseAccumulator,
        SpillingSparseAccumulator,
        fetch_triples,
        fetched_to_triples,
    )

    if mesh is not None and seqpar:
        from ..parallel.seqpar import spectrum_seqpar_triples
    elif mesh is not None:
        from ..parallel.bucket import sparse_spectrum_sharded_retry

        _check_mesh_batch(mesh, batch_size)

    m = metrics or RunMetrics(k=k, mode="sparse")
    fp, cpath = _resume_fingerprint(
        path, k, "sparse", canonical, out_path, byte_range, min_qual,
        resume,
    )

    ckpt = StreamCheckpoint(fingerprint=fp)
    prev = None
    if resume and cpath and os.path.exists(cpath):
        prev = StreamCheckpoint.load_if_valid(cpath)
        if prev is not None and not prev.matches(fp):
            prev = None

    spilling = False
    if k <= 10:
        # k <= 10 (the sorted dense-spectrum route): dense threaded host
        # fold (<= 8 MB table — no budget needed).
        acc = DenseFoldAccumulator(k)
    elif mem_budget_mb or (prev is not None and prev.sparse_runs is not None):
        # Budget requested, or resuming a budgeted run's checkpoint
        # (the run list must be honoured whatever this call asks).
        if cpath is None:
            raise ValueError(
                "mem_budget_mb needs an out_path (spill runs live next "
                "to the checkpoint sidecar)"
            )
        from ..runtime.checkpoint import spill_dir_path

        acc = SpillingSparseAccumulator(
            spill_dir_path(cpath),
            (mem_budget_mb or 8192) * (1 << 20),
            merge_every=merge_every,
        )
        spilling = True
    else:
        acc = SparseAccumulator(merge_every=merge_every)
    if prev is not None:
        try:
            if prev.sparse_runs is not None:
                acc.adopt_runs(prev.sparse_runs)
            else:
                acc.load_arrays(*prev.load_sparse())
            ckpt = prev
        except (OSError, ValueError, KeyError):
            # Torn sidecar / missing runs: restart from scratch (and
            # clear any stale spill files so they cannot double-count).
            ckpt = StreamCheckpoint(fingerprint=fp)
            if spilling:
                acc.adopt_runs([])

    gen = _resume_batches(path, k, batch_size, ckpt, byte_range, min_qual)
    dense_fold = isinstance(acc, DenseFoldAccumulator)
    pending: list = []
    since_ckpt = 0

    # Large drain buffers must not be retained by glibc arenas: without
    # this a long sparse run's RSS creeps to ~2.7x the accumulator
    # budget before flattening (runtime/metrics.pin_malloc_for_streaming).
    from ..runtime.metrics import malloc_trim, pin_malloc_for_streaming

    pin_malloc_for_streaming()

    # Single-worker fold thread: the native fold and the NumPy merge
    # both release the GIL, so batch i's host fold really overlaps
    # batch i+1's D2H fetch (one worker — the accumulator is mutable
    # state).  Background fold time lands under "fold_bg"; the time the
    # MAIN thread waits on outstanding folds (checkpoints, finish) is
    # "fold_wait" — the exposed fold cost.
    import concurrent.futures
    import time as _time

    folder = (
        concurrent.futures.ThreadPoolExecutor(max_workers=1)
        if mesh is None else None
    )
    fold_futs: list = []

    def _fold(arrs) -> None:
        t0 = _time.perf_counter()
        if dense_fold and len(arrs) == 2:
            acc.add_pairs(arrs[0], arrs[1])
        else:
            acc.add(*fetched_to_triples(arrs, k))
        m.stages["fold_bg"] = m.stages.get("fold_bg", 0.0) + (
            _time.perf_counter() - t0
        )

    def _wait_folds() -> None:
        while fold_futs:
            fold_futs.pop(0).result()  # re-raise worker errors

    def drain_one() -> None:
        nonlocal since_ckpt
        fetch, n_reads, nbases, end_off = pending.pop(0)
        with m.stage("materialize"):  # device wait + D2H fetch
            arrs = fetch()
        if folder is not None:
            fold_futs.append(folder.submit(_fold, arrs))
        else:
            with m.stage("fold"):
                _fold(arrs)
        # Only FOLDED batches are checkpointable: reads_done must never
        # run ahead of the accumulator state the checkpoint persists
        # (outstanding folds are joined before any checkpoint write).
        ckpt.reads_done += n_reads
        ckpt.input_offset = end_off
        m.batches += 1
        m.reads += n_reads
        m.bases += nbases
        since_ckpt += 1
        if cpath and since_ckpt >= checkpoint_every:
            with m.stage("fold_wait"):
                _wait_folds()
            with m.stage("checkpoint"):
                if spilling:
                    ckpt.sparse_runs = acc.checkpoint_runs()
                    ckpt.save(cpath)
                else:
                    keys, cnts = acc.result_arrays()
                    ckpt.save_sparse(cpath, keys, cnts)
                    ckpt.save(cpath)
                malloc_trim()  # return freed arena pages at the quiet point
            since_ckpt = 0

    for batch in _prefetched(gen, metrics=m):
        if mesh is not None and seqpar:
            with m.stage("dispatch"):
                rows = narrow_for_fetch(
                    spectrum_seqpar_triples(
                        jax.numpy.asarray(batch.codes), k, mesh,
                        canonical=canonical,
                    ),
                    k,
                )
            fetch = lambda rows=rows: [np.asarray(a) for a in rows]  # noqa: E731
        elif mesh is not None:
            with m.stage("dispatch"):
                hi, lo, counts, slack = sparse_spectrum_sharded_retry(
                    jax.numpy.asarray(batch.codes), k, mesh,
                    canonical=canonical, slack=slack,
                )
            fetch = lambda h=hi, l=lo, c=counts: list(  # noqa: E731
                fetch_triples(h, l, c, k)
            )
        else:
            # Per-read row sorts; the enqueue is async, the fetch waits
            # at drain time.  valid_pair_prefix
            # slices rows to the batch's TRUE max window count (not the
            # geometric-bucket width — e.g. 142 of 248 columns for
            # 150 bp reads in a 256 bucket): pad columns past every
            # read's real windows are structurally (sentinel, 0).
            with m.stage("dispatch"):
                w = max(int(batch.lengths.max(initial=0)), k) - k + 1
                rows = valid_pair_prefix(
                    narrow_for_fetch(
                        count_perread_rows(
                            jax.numpy.asarray(batch.codes), k, canonical
                        ),
                        k,
                    ),
                    w,
                )
            fetch = lambda rows=rows: [np.asarray(a) for a in rows]  # noqa: E731
        pending.append(
            (fetch, batch.n_reads, int(batch.lengths.sum()), batch.end_offset)
        )
        if len(pending) > 2:
            drain_one()
    while pending:
        drain_one()
    if folder is not None:
        with m.stage("fold_wait"):
            _wait_folds()
        folder.shutdown(wait=True)

    m.total_reads = ckpt.reads_done
    if finalize == "accumulator":
        # The bounded-finalize path (>= 100M-read runs): the CALLER
        # streams acc.iter_merged_chunks()/result_arrays() into its
        # writer and then removes the checkpoint + spill runs
        # (runtime.checkpoint.cleanup_checkpoint) — a full key-set
        # materialisation never has to exist.
        return acc, None, m
    keys, counts = acc.result_arrays()
    if cleanup:
        if cpath and os.path.exists(cpath):
            ckpt.cleanup(cpath)
        elif spilling:
            acc.cleanup_spill()
    return keys, counts, m
