"""End-to-end file counting: FASTA in → counts / .cfrk out.

This is the in-memory driver, the analog of the reference's whole
``main`` flow (``src/main.cu:232-309``: parse → chunk → per-chunk kernel →
write) collapsed into: parse → fixed-shape batches → one jitted XLA
executable reused per batch → streaming writer.  The reference's pthread /
per-thread-stream machinery is subsumed by XLA's async dispatch: each
device batch is enqueued while the host packs the next one.

For runs too large to hold reads in memory, use pipeline/stream.py.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np

from ..format import CfrkWriter
from ..io.fasta import read_fasta_encoded
from ..ops.perread import count_perread
from ..ops.spectrum import spectrum as spectrum_op
from .batch import iter_batches, round_up

__all__ = [
    "count_reads",
    "count_file",
    "count_file_sparse_rows",
    "spectrum_file",
    "sparse_spectrum_file",
    "write_cfrk",
    "SPILL_LIMIT",
    "iter_spill_chunks",
    "DenseSpectrumAccumulator",
]

# Dense-spectrum device tables accumulate in int32 (device int64 needs
# the x64 flag); any single bin is bounded by the windows accumulated
# since the last spill, so staying below this keeps every bin exact.
# The 2**27 headroom keeps the comparison itself safely signed.
SPILL_LIMIT = 2**31 - 2**27


def iter_spill_chunks(codes, k: int, row_multiple: int = 1,
                      len_multiple: int = 1, limit: int = SPILL_LIMIT):
    """Split one batch so no single dispatch sees >= ``limit`` windows.

    Without this, a lone batch of long repeat-dominated contigs (e.g.
    8192 poly-A reads padded to a ~300 kbase bucket = ~2.5e9 windows)
    could wrap an int32 bin INSIDE one dispatch, before any
    across-batch spill guard runs.  Splits rows first (chunks stay
    divisible by ``row_multiple`` for dp-sharded dispatch); if even the
    minimal row chunk reaches the limit, slices the position axis with
    k-1 overlap — exact for a GLOBAL spectrum, since every window lands
    in exactly one slice.  Position slices are padded with -1 columns
    to ``len_multiple`` (seqpar divisibility); padding windows are
    invalid and count nothing.
    """
    b, length = codes.shape
    w = length - k + 1
    if b * w < limit:
        yield codes
        return
    rows = max(1, (limit - 1) // max(w, 1))
    rows = max(rows - rows % row_multiple, row_multiple)
    if rows * w < limit:
        for s in range(0, b, rows):
            yield codes[s : s + rows]
        return
    step = max(1, (limit - 1) // rows)
    for r in range(0, b, rows):
        rchunk = np.asarray(codes[r : r + rows])
        for s in range(0, w, step):
            sl = rchunk[:, s : min(s + step + k - 1, length)]
            pad = -sl.shape[1] % len_multiple
            if pad:
                sl = np.pad(sl, ((0, 0), (0, pad)), constant_values=-1)
            yield sl


class DenseSpectrumAccumulator:
    """int32-on-device dense-spectrum accumulation with int64 host spill.

    Shared by the in-memory (:func:`spectrum_file`) and streaming
    (``stream_spectrum_file``) drivers — one implementation of the
    overflow discipline: every dispatch AND the running device table
    stay below :data:`SPILL_LIMIT` windows, so no int32 bin can wrap.
    ``base`` is the flattened int64 host table (may hold a resumed
    checkpoint); with tp > 1 the device table arrives bins-over-tp and
    the spill's np.asarray gathers it.
    """

    def __init__(self, k: int, dispatch, base: np.ndarray,
                 row_multiple: int = 1, len_multiple: int = 1,
                 limit: int = SPILL_LIMIT):
        self.k = k
        self.base = base
        self._dispatch = dispatch
        self._dev = None
        self._windows = 0
        self._row_multiple = row_multiple
        self._len_multiple = len_multiple
        self._limit = limit

    def add(self, codes) -> None:
        import jax.numpy as jnp

        for chunk in iter_spill_chunks(
            codes, self.k, self._row_multiple, self._len_multiple,
            self._limit,
        ):
            bw = chunk.shape[0] * (chunk.shape[1] - self.k + 1)
            if self._windows + bw >= self._limit:
                self.spill()
            part = self._dispatch(jnp.asarray(chunk))
            self._dev = part if self._dev is None else self._dev + part
            self._windows += bw

    @property
    def windows(self) -> int:
        """Windows accumulated on device since the last spill (callers
        that stage/meter the spill can pre-check the limit)."""
        return self._windows

    def spill(self) -> None:
        """Fold the device table into the host int64 base."""
        if self._dev is not None:
            self.base = self.base + np.asarray(
                self._dev, dtype=np.int64
            ).reshape(-1)
            self._dev = None
        self._windows = 0

    def total(self) -> np.ndarray:
        self.spill()
        return self.base


def _plan_shapes(reads: Sequence[np.ndarray], k: int, batch_size: int | None,
                 max_len: int | None) -> tuple[int, int | None]:
    """Batch size + pad length.  ml=None means per-batch geometric
    buckets (iter_batches) — a lone long contig then widens only its
    own batch, not every batch of the run."""
    bs = min(batch_size or 8192, max(len(reads), 1))
    if max_len is not None:
        return bs, max_len
    longest = max((len(r) for r in reads), default=1)
    if longest <= 512:
        # Uniform short reads: one shared shape compiles once.
        return bs, round_up(max(longest, k), 128)
    return bs, None


def count_reads(
    reads: Sequence[np.ndarray],
    k: int,
    *,
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int | None = 8192,
    max_len: int | None = None,
    mesh=None,
    seqpar: bool = False,
) -> np.ndarray:
    """Per-read dense histograms for a ragged list of encoded reads.

    ``mesh``: shard batch rows data-parallel over a (dp, tp) mesh
    (zero-collective; parallel/sharded.py).  ``seqpar`` instead shards
    the POSITION axis of a 1-D ``sp`` mesh — for few very long contigs
    (parallel/seqpar.py); requires a seq mesh from ``make_seq_mesh``.
    """
    if not reads:
        return np.zeros((0, 4**k), dtype=np.int32)
    bs, ml = _plan_shapes(reads, k, batch_size, max_len)
    if mesh is not None and not seqpar:
        # every row block must land on a device: round the batch up.
        bs = -(-bs // mesh.size) * mesh.size
    out = np.zeros((len(reads), 4**k), dtype=np.int32)
    row = 0
    pending: list[tuple[int, int, object]] = []

    def materialise(r0, n, c):
        out[r0 : r0 + n] = np.asarray(c)[:n]

    for batch in iter_batches(reads, bs, ml):
        # int16 device counts (exact; bounded by windows/read) halve the
        # output bytes and the D2H transfer.
        odt = (
            jax.numpy.int16
            if batch.max_len - k + 1 < 2**15
            else jax.numpy.int32
        )
        if mesh is not None and seqpar:
            from ..parallel.seqpar import count_perread_seqpar

            counts = count_perread_seqpar(
                jax.numpy.asarray(batch.codes), k, mesh,
                canonical=canonical, impl=impl,
            )
        elif mesh is not None:
            from ..parallel.sharded import count_perread_sharded

            counts = count_perread_sharded(
                jax.numpy.asarray(batch.codes), k, mesh,
                canonical=canonical, impl=impl,
            )
        else:
            counts = count_perread(
                jax.numpy.asarray(batch.codes), k,
                canonical=canonical, impl=impl, out_dtype=odt,
            )
        # Keep device queue deep: materialise the previous batch while this
        # one computes (async dispatch does the overlap).
        pending.append((row, batch.n_reads, counts))
        row += batch.n_reads
        if len(pending) > 2:
            materialise(*pending.pop(0))
    for item in pending:
        materialise(*item)
    return out


def count_file(path, k: int, min_qual: int = 0, **kw) -> np.ndarray:
    """Count a FASTA file: returns [n_reads, 4**k] int32.

    ``min_qual`` masks FASTQ bases below that Phred quality (io.fasta)."""
    return count_reads(read_fasta_encoded(path, min_qual), k, **kw)


def spectrum_file(
    path,
    k: int,
    *,
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int | None = 8192,
    max_len: int | None = None,
    mesh=None,
    seqpar: bool = False,
    min_qual: int = 0,
) -> np.ndarray:
    """Global spectrum of a FASTA file: returns [4**k] int64.

    With ``mesh``, per-batch tables are computed sharded (psum over dp,
    psum_scatter bins over tp — parallel/sharded.py) and accumulated in
    that layout; the final host gather assembles the full table.
    """
    reads = read_fasta_encoded(path, min_qual)
    total = np.zeros(4**k, dtype=np.int64)
    if not reads:
        return total
    bs, ml = _plan_shapes(reads, k, batch_size, max_len)
    if mesh is not None and not seqpar:
        bs = -(-bs // mesh.size) * mesh.size
    if impl == "sort":
        # The sorted route (impl='sort'): sort+RLE the keys on device
        # per batch (for k <= 15 the sparse key IS the dense index);
        # k <= 10 folds batches into a dense table with the threaded
        # native histogram, k >= 11 merges sparsely on host and
        # densifies once.  Under seqpar each device sorts its own position slice's
        # windows (parallel/seqpar.spectrum_seqpar_triples) instead of
        # falling back to the ~54 Mb/s scatter accumulator.
        keys, counts = _sorted_spectrum_batches(
            iter_batches(reads, bs, ml), k, canonical, mesh, seqpar
        )
        total[keys] = counts
        return total
    if mesh is not None:
        if seqpar:
            from ..parallel.seqpar import spectrum_seqpar

            dispatch = lambda arr: spectrum_seqpar(  # noqa: E731
                arr, k, mesh, canonical=canonical, impl=impl
            )
        else:
            from ..parallel.sharded import spectrum_sharded

            dispatch = lambda arr: spectrum_sharded(  # noqa: E731
                arr, k, mesh, canonical=canonical, impl=impl
            )
    else:
        dispatch = lambda arr: spectrum_op(  # noqa: E731
            arr, k, canonical=canonical, impl=impl
        )
    # Accumulate on device (int32), spilling to the host int64 total
    # before any bin could overflow — avoids a full-table D2H per batch.
    acc = DenseSpectrumAccumulator(
        k, dispatch, total,
        row_multiple=(mesh.size if mesh is not None and not seqpar else 1),
        len_multiple=(
            mesh.shape.get("sp", 1) if mesh is not None and seqpar else 1
        ),
    )
    for batch in iter_batches(reads, bs, ml):
        acc.add(batch.codes)
    return acc.total()


def _sorted_spectrum_batches(batches, k, canonical, mesh, seqpar=False):
    """Accumulate batches sparsely (device sort+RLE); returns the merged
    (keys, counts) arrays.  With a dp/tp mesh, keys route through the
    all_to_all bucket exchange with overflow retry; with a seqpar mesh,
    each device sorts its own position slice (rows_to_triples merges the
    slice duplicates on host like any batch duplicates); single-device
    batches use per-read row sorts."""
    from ..ops.sparse import (
        SparseAccumulator,
        batch_spectrum_triples,
        fetch_triples,
        rows_to_triples,
    )

    if mesh is not None and not seqpar:
        from ..parallel.bucket import sparse_spectrum_sharded_retry
    if seqpar and mesh is not None:
        from ..parallel.seqpar import spectrum_seqpar_triples

    from ..ops.sparse import DenseFoldAccumulator

    # k <= 10: dense threaded fold (8 MB table max) instead of the
    # searchsorted sparse merge.
    acc = DenseFoldAccumulator(k) if k <= 10 else SparseAccumulator()
    slack = 2.0
    for batch in batches:
        if seqpar and mesh is not None:
            rows = spectrum_seqpar_triples(
                jax.numpy.asarray(batch.codes), k, mesh, canonical=canonical
            )
            acc.add(*rows_to_triples(rows, k))
        elif mesh is not None:
            hi, lo, counts, slack = sparse_spectrum_sharded_retry(
                jax.numpy.asarray(batch.codes), k, mesh,
                canonical=canonical, slack=slack,
            )
            acc.add(*fetch_triples(hi, lo, counts, k))
        else:
            acc.add(*batch_spectrum_triples(
                batch.codes, k, canonical,
                max_len=int(batch.lengths.max(initial=0)),
            ))
    return acc.result_arrays()


def sparse_spectrum_file(
    path,
    k: int,
    *,
    canonical: bool = False,
    batch_size: int | None = 8192,
    max_len: int | None = None,
    mesh=None,
    slack: float = 2.0,
    min_qual: int = 0,
    seqpar: bool = False,
) -> dict:
    """Sparse spectrum of a FASTA file for large k (16..31).

    Returns {int_kmer_code: count}.  Device side sorts + run-length
    encodes per batch (ops/sparse.py); batches merge on host.  With
    ``mesh``, keys route through the all_to_all bucket exchange
    (parallel/bucket.py) with automatic overflow retry — or, with
    ``seqpar``, each device sorts its own POSITION slice of a 1-D
    ``sp`` mesh (the long-contig shape; parallel/seqpar.py).
    """
    from ..ops.sparse import (
        SparseAccumulator,
        batch_spectrum_triples,
        fetch_triples,
        rows_to_triples,
    )

    reads = read_fasta_encoded(path, min_qual)
    if not reads:
        return {}
    bs, ml = _plan_shapes(reads, k, batch_size, max_len)
    if mesh is not None and seqpar:
        from ..parallel.seqpar import spectrum_seqpar_triples
    elif mesh is not None:
        from ..parallel.bucket import sparse_spectrum_sharded_retry

        bs = -(-bs // mesh.size) * mesh.size
    acc = SparseAccumulator()
    for batch in iter_batches(reads, bs, ml):
        if mesh is not None and seqpar:
            rows = spectrum_seqpar_triples(
                jax.numpy.asarray(batch.codes), k, mesh, canonical=canonical
            )
            acc.add(*rows_to_triples(rows, k))
        elif mesh is not None:
            hi, lo, counts, slack = sparse_spectrum_sharded_retry(
                jax.numpy.asarray(batch.codes), k, mesh,
                canonical=canonical, slack=slack,
            )
            acc.add(*fetch_triples(hi, lo, counts, k))
        else:
            acc.add(*batch_spectrum_triples(
                batch.codes, k, canonical,
                max_len=int(batch.lengths.max(initial=0)),
            ))
    return acc.result()


def count_file_sparse_rows(
    path,
    out_path,
    k: int,
    *,
    canonical: bool = False,
    batch_size: int | None = 8192,
    max_len: int | None = None,
    mesh=None,
    min_qual: int = 0,
    nonzero: bool = True,
) -> int:
    """Per-read SPARSE rows for 8 < k <= 31, streamed straight to disk.

    Dense [n_reads, 4**k] materialisation is impossible at these k
    (the reference OOM-exited, ``src/kmer_main.cu:51-56``); rows use the
    nonzero ``idx:count`` format — for k > 15 the idx is the combined
    64-bit code ``hi * 4**15 + lo``.  With ``mesh``, rows shard over the
    devices (zero collectives).  Returns the number of reads written.

    ``nonzero=False`` (k <= 8 only) writes DENSE rows instead: the
    device op and D2H still ship pairs; the native formatter densifies
    inside the bin walk (format.CfrkWriter.write_pairs_dense) — same
    bytes as the dense-kernel route, never the dense matrix in memory.
    """
    if not nonzero and k > 8:
        raise ValueError("dense rows require k <= 8")
    from ..ops.perread_sparse import count_perread_rows, pairs_to_host

    reads = read_fasta_encoded(path, min_qual)
    n_written = 0
    with CfrkWriter(out_path) as w:
        if not reads:
            return 0
        bs, ml = _plan_shapes(reads, k, batch_size, max_len)
        if mesh is not None:
            from ..parallel.sharded import count_perread_sparse_sharded

            bs = -(-bs // mesh.size) * mesh.size
        from ..ops.perread_sparse import narrow_for_fetch

        for batch in iter_batches(reads, bs, ml):
            if mesh is not None:
                out = count_perread_sparse_sharded(
                    jax.numpy.asarray(batch.codes), k, mesh,
                    canonical=canonical,
                )
            else:
                out = count_perread_rows(
                    jax.numpy.asarray(batch.codes), k, canonical
                )
            # one shared D2H narrowing policy (uint16 idx, int16 counts)
            idx, counts = pairs_to_host(
                narrow_for_fetch(out, k), batch.n_reads
            )
            if nonzero:
                w.write_pairs(idx, counts)
            else:
                w.write_pairs_dense(idx, counts, 4**k)
            n_written += batch.n_reads
    return n_written


def write_cfrk(path, counts: np.ndarray) -> None:
    """Write counts to a `.cfrk` file (exact reference byte format)."""
    with CfrkWriter(path) as w:
        w.write_batch(counts)
