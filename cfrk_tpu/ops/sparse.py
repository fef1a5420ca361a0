"""Sparse k-mer spectra for large k (dense 4**k tables impossible).

The reference simply aborted when the dense table exceeded device memory
(reference ``src/kmer_main.cu:51-56``).  For k up to 31 this module
represents each k-mer as a ``(hi, lo)`` pair of uint32 words:

    hi = first k-15 bases (<= 16 bases = 32 bits),
    lo = last 15 bases  (30 bits),

and counts distinct k-mers by SORT + RUN-LENGTH-ENCODE in place of a
hash table: ``lax.sort`` (multi-operand lexicographic) runs entirely on
the device with static shapes; run boundaries then segment the sorted
key stream into counts.
This is the "sharded hash table" design of BASELINE.json config 4, with
sorting playing the hash-bucket role (see parallel/bucket.py for the
all_to_all device sharding).

Invalid windows (N bases / padding / short reads) carry the sentinel
``lo = 0xFFFFFFFF`` — unreachable for real windows (lo < 2**30) — and
sort to the end, so compaction is a static-shape prefix selection.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "MAX_SPARSE_K",
    "LO_BASES",
    "INVALID_SENTINEL",
    "kmer_keys",
    "sparse_spectrum",
    "batch_spectrum_triples",
    "rows_to_triples",
    "fetch_triples",
    "fetched_to_triples",
    "merge_sorted_key_counts",
    "merge_sorted_spectra",
    "SparseAccumulator",
    "SpillingSparseAccumulator",
    "DenseFoldAccumulator",
    "decode_key",
]

MAX_SPARSE_K = 31
LO_BASES = 15
# np (not jnp): a module-level jnp scalar would initialise the XLA
# backend at import time, which breaks jax.distributed.initialize()
# for every downstream user (it must run before any backend touch).
INVALID_SENTINEL = np.uint32(0xFFFFFFFF)


def _horner_u32(views):
    acc = views[0].astype(jnp.uint32)
    for v in views[1:]:
        acc = (acc << jnp.uint32(2)) | v.astype(jnp.uint32)
    return acc


@partial(jax.jit, static_argnums=(1, 2), inline=True)
def kmer_keys(codes: jax.Array, k: int, canonical: bool = False):
    """All window keys of a padded batch.

    codes: [..., L] int8 → (hi, lo) uint32 arrays of shape [..., L-k+1].
    Invalid windows have lo == INVALID_SENTINEL (and hi == sentinel too,
    so sorting by (hi, lo) still pushes them last).
    """
    if not 1 <= k <= MAX_SPARSE_K:
        raise ValueError(f"k must be in [1, {MAX_SPARSE_K}]")
    length = codes.shape[-1]
    w = length - k + 1
    if w <= 0:
        raise ValueError(f"read length {length} < k={k}")
    kh = max(k - LO_BASES, 0)  # leading bases in hi (0 for k <= 15)

    c = codes.astype(jnp.int32)
    views = [jax.lax.slice_in_dim(c, i, i + w, axis=-1) for i in range(k)]
    valid = views[0] >= 0
    for v in views[1:]:
        valid &= v >= 0
    clamped = [jnp.maximum(v, 0) for v in views]

    def pack(vs):
        z = jnp.zeros(views[0].shape, dtype=jnp.uint32)
        return _horner_u32(vs) if vs else z

    hi, lo = pack(clamped[:kh]), pack(clamped[kh:])
    if canonical:
        rviews = [3 - v for v in reversed(clamped)]
        rc_hi, rc_lo = pack(rviews[:kh]), pack(rviews[kh:])
        fwd_smaller = (hi < rc_hi) | ((hi == rc_hi) & (lo <= rc_lo))
        hi = jnp.where(fwd_smaller, hi, rc_hi)
        lo = jnp.where(fwd_smaller, lo, rc_lo)
    hi = jnp.where(valid, hi, INVALID_SENTINEL)
    lo = jnp.where(valid, lo, INVALID_SENTINEL)
    return hi, lo


@jax.jit
def _rle(hi: jax.Array, lo: jax.Array):
    """Run-length-encode a SORTED key stream.

    Returns (uhi, ulo, counts) of the same length: position i holds a
    unique key and its count iff it is the first element of its run;
    other positions carry the sentinel and count 0.  Invalid keys
    (sentinel) always get count 0.  (Thin 1-D wrapper over the shared
    row-RLE core in ops/perread_sparse.py.)
    """
    from .perread_sparse import rle_rows

    uhi, ulo, counts = rle_rows(
        (hi[None, :], lo[None, :]),
        (lo != INVALID_SENTINEL)[None, :],
        (INVALID_SENTINEL, INVALID_SENTINEL),
    )
    return uhi[0], ulo[0], counts[0]


@partial(jax.jit, static_argnums=(1, 2))
def sparse_spectrum(codes: jax.Array, k: int, canonical: bool = False):
    """Distinct-k-mer counts of a batch, sort-based.

    codes: [B, L] int8 → (hi, lo, counts), each [B*(L-k+1)], sorted by
    key with unique keys at run starts (see _rle).  Static shapes: the
    caller compacts/merges on host or feeds the sorted stream onward.
    """
    hi, lo = kmer_keys(codes, k, canonical)
    lo = lo.reshape(-1)
    if k <= LO_BASES:
        # hi is structurally 0 for every valid key (the whole code fits
        # lo) and sentinel exactly when lo is — sorting and RLE-ing lo
        # ALONE is order-identical to the (hi, lo) lexicographic sort
        # at half the sort-operand traffic.
        from .perread_sparse import rle_rows

        lo = jax.lax.sort(lo)
        ulo, counts = rle_rows(
            (lo[None, :],),
            (lo != INVALID_SENTINEL)[None, :],
            (INVALID_SENTINEL,),
        )
        ulo, counts = ulo[0], counts[0]
        uhi = jnp.where(counts > 0, jnp.uint32(0), INVALID_SENTINEL)
        return uhi, ulo, counts
    hi = hi.reshape(-1)
    hi, lo = jax.lax.sort((hi, lo), num_keys=2)
    return _rle(hi, lo)


def fetch_triples(hi, lo, counts, k: int):
    """Materialise a device (hi, lo, counts) triple to host NumPy.

    For k <= LO_BASES the hi half of every VALID key is structurally 0
    (the key fits entirely in lo; invalid windows carry the sentinel
    but also count 0, which every consumer masks) — so the hi transfer
    is skipped and replaced with host zeros.  At config-3 batch sizes
    that is ~7 MB/batch of D2H for free.
    """
    nplo = np.asarray(lo)
    if k <= LO_BASES:
        nphi = np.zeros(nplo.shape, dtype=np.uint32)
    else:
        nphi = np.asarray(hi)
    return nphi, nplo, np.asarray(counts)


def batch_spectrum_triples(codes, k: int, canonical: bool = False,
                           max_len: int | None = None):
    """Host (hi, lo, counts) of ONE batch for the sparse accumulator.

    Counts via PER-READ row sorts (ops/perread_sparse) instead of one
    full-batch lexicographic sort: bitonic cost is n·log²n, so 8192
    independent ~256-element row sorts beat one 2M-element sort by
    3.1x at k=15 and 6.6x at k=31 canonical on-chip (docs/PERF.md).
    The accumulator's fold merges row-level uniques exactly like
    batch-level ones (and at k > 15 nearly every window is distinct
    anyway, so the entry counts match too).  The mesh path is NOT
    served here — all_to_all bucket routing needs bucket-contiguous
    keys from the global sort (parallel/bucket.py).

    ``max_len``: the batch's TRUE longest read (not the padded bucket
    width) — rows are prefix-sliced to its window count before the
    fetch (valid_pair_prefix; pad columns are structurally empty).
    """
    import jax.numpy as jnp

    from .perread_sparse import (
        count_perread_rows,
        narrow_for_fetch,
        valid_pair_prefix,
    )

    w = max(max_len or codes.shape[-1], k) - k + 1
    rows = valid_pair_prefix(
        narrow_for_fetch(
            count_perread_rows(jnp.asarray(codes), k, canonical), k
        ),
        w,
    )
    return fetched_to_triples([np.asarray(a) for a in rows], k)


def rows_to_triples(rows, k: int):
    """Per-read sorted-RLE rows (device) → host (hi, lo, counts) triple
    for the SparseAccumulator.  Shared by the per-batch single-device
    route and the seqpar per-slice route (parallel/seqpar.py)."""
    from .perread_sparse import narrow_for_fetch

    rows = narrow_for_fetch(rows, k)
    return fetched_to_triples([np.asarray(a) for a in rows], k)


def fetched_to_triples(arrs, k: int):
    """Already-fetched drain-narrowed host arrays → flat (hi, lo, counts).

    Keeps the drain dtypes (uint16/int32 keys, uint8/int16 counts) —
    both accumulators consume them directly, so widening here would
    only add ~100 MB/batch of astype memory traffic at production batch
    sizes (round-5 fold-path measurement, docs/PERF.md).  The streaming
    driver calls this on buffers it fetched itself so the fetch can be
    staged separately from the fold."""
    if (
        arrs[0].ndim == 2
        and all(
            a.shape == arrs[0].shape
            and a.flags.f_contiguous
            and not a.flags.c_contiguous
            for a in arrs
        )
    ):
        # Column-major buffers: spectrum accumulation is
        # cell-order-invariant, and an F-ravel of an F-contiguous array
        # is a zero-copy VIEW — every array of the tuple raveled the
        # same way keeps the cell pairing without a strided copy per
        # array (see io/native.fold_pairs_into).
        arrs = [a.ravel(order="F") for a in arrs]
    if len(arrs) == 2:
        idx, cnt = arrs
        lo = idx.reshape(-1)
        c = cnt.reshape(-1)
        # uint16-compacted idx wraps the sentinel to 0, but sentinel
        # cells carry count 0 and every consumer masks counts > 0.
        # hi is structurally zero for k <= 15: a broadcast view, not a
        # materialised zeros array.
        return np.broadcast_to(np.uint32(0), lo.shape), lo, c
    hi, lo, counts = arrs
    return hi.reshape(-1), lo.reshape(-1), counts.reshape(-1)


def merge_sorted_key_counts(parts):
    """Merge [(keys uint64 sorted-unique, counts int64), ...] pairs into
    one sorted-unique (keys, counts) pair, summing duplicate keys.

    argsort + add.reduceat — same rationale as SparseAccumulator._fold
    (np.add.at is ~10-60x slower at scale).  Used by the multi-host
    part splice and tools/merge_outputs.py.
    """
    ks = [np.asarray(k, dtype=np.uint64) for k, _ in parts]
    cs = [np.asarray(c, dtype=np.int64) for _, c in parts]
    if not ks:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    all_k = np.concatenate(ks)
    all_c = np.concatenate(cs)
    if not len(all_k):
        return all_k, all_c
    order = np.argsort(all_k, kind="stable")
    sk = all_k[order]
    sc = all_c[order]
    starts = np.r_[0, np.flatnonzero(sk[1:] != sk[:-1]) + 1]
    return sk[starts], np.add.reduceat(sc, starts)


def merge_sorted_spectra(parts):
    """Host-side merge of per-batch sparse spectra into a dict.

    parts: iterable of (hi, lo, counts) NumPy triples from
    :func:`sparse_spectrum`.  Returns {int_kmer_code: count} with the
    full k-mer code = hi * 4**LO_BASES + lo.  Vectorised: one
    np.unique-based reduction over all batches rather than a Python
    loop per key.
    """
    pairs = []
    for hi, lo, counts in parts:
        mask = counts > 0
        keys = (hi[mask].astype(np.uint64) << np.uint64(2 * LO_BASES)) | lo[
            mask
        ].astype(np.uint64)
        pairs.append((keys, counts[mask].astype(np.int64)))
    uniq, sums = merge_sorted_key_counts(pairs)
    return dict(zip(uniq.tolist(), sums.tolist()))


class SparseAccumulator:
    """Bounded-memory accumulator for sparse spectra across batches.

    Holds one merged (keys, counts) pair of int64 arrays; incoming
    batch triples are buffered and folded in with np.unique every
    ``merge_every`` batches, so peak memory is O(distinct k-mers +
    merge_every × batch windows) instead of O(all batches).
    """

    def __init__(self, merge_every: int = 32):
        self.keys = np.empty(0, dtype=np.uint64)
        self.counts = np.empty(0, dtype=np.int64)
        self._pending: list = []
        self._merge_every = merge_every

    def add(self, hi, lo, counts) -> None:
        mask = counts > 0
        keys = (hi[mask].astype(np.uint64) << np.uint64(2 * LO_BASES)) | lo[
            mask
        ].astype(np.uint64)
        self._pending.append((keys, counts[mask].astype(np.int64)))
        if len(self._pending) >= self._merge_every:
            self._fold()

    def _fold(self) -> None:
        """Fold pending batch triples into the sorted accumulator.

        Two-level: collapse the pending buffer alone (argsort +
        add.reduceat — the accumulator, usually much larger, is not
        re-sorted), then one searchsorted merge pass against the
        accumulator with DIRECT assignment for hits (collapsed keys
        are unique, so no scatter-add is needed).  Measured 67x the
        naive np.unique + np.add.at fold at a 6M-key accumulator (host
        CPU); the reference's host-side merge analog is the hash
        consolidation in ``src/main.cu:232-247``.
        """
        if not self._pending:
            return
        pk = np.concatenate([k for k, _ in self._pending])
        pc = np.concatenate([c for _, c in self._pending])
        self._pending = []
        if not len(pk):
            return
        order = np.argsort(pk, kind="stable")
        pk = pk[order]
        pc = pc[order]
        starts = np.r_[0, np.flatnonzero(pk[1:] != pk[:-1]) + 1]
        pk = pk[starts]
        pc = np.add.reduceat(pc, starts)
        if not len(self.keys):
            self.keys, self.counts = pk, pc
            return
        pos = np.searchsorted(self.keys, pk)
        pos_c = np.minimum(pos, len(self.keys) - 1)
        hit = self.keys[pos_c] == pk
        out_c = self.counts.copy()
        out_c[pos_c[hit]] += pc[hit]  # unique hits: plain assignment-add
        new_k = pk[~hit]
        new_c = pc[~hit]
        if not len(new_k):
            self.counts = out_c
            return
        # Interleave old and new rows in one allocation: each old row
        # shifts right by the number of new keys before it, each new
        # row lands at its insertion point plus its own rank.
        idx = np.arange(len(self.keys)) + np.searchsorted(
            new_k, self.keys, side="right"
        )
        nidx = np.searchsorted(self.keys, new_k) + np.arange(len(new_k))
        out_keys = np.empty(len(self.keys) + len(new_k), dtype=np.uint64)
        out_counts = np.empty(len(out_keys), dtype=np.int64)
        out_keys[idx] = self.keys
        out_counts[idx] = out_c
        out_keys[nidx] = new_k
        out_counts[nidx] = new_c
        self.keys, self.counts = out_keys, out_counts

    def result(self) -> dict:
        """Final {int_kmer_code: count} dict (kept for API parity)."""
        self._fold()
        return dict(zip(self.keys.tolist(), self.counts.tolist()))

    def result_arrays(self):
        """Final (keys uint64, counts int64), sorted by key — the
        scalable interface for large runs."""
        self._fold()
        return self.keys, self.counts

    def load_arrays(self, keys, counts) -> None:
        """Restore checkpointed (keys, counts) state (resume path)."""
        self.keys = np.asarray(keys, dtype=np.uint64)
        self.counts = np.asarray(counts, dtype=np.int64)
        self._pending = []

    def iter_merged_chunks(self, chunk: int | None = None):
        """Ascending (keys, counts) chunks — the uniform streamed-output
        interface (the spilling subclass merges disk runs here)."""
        keys, counts = self.result_arrays()
        chunk = chunk or (1 << 24)
        for s in range(0, len(keys), chunk):
            yield keys[s : s + chunk], counts[s : s + chunk]


class _RunArray:
    """Bounded-memory reader over one spilled ``.npy`` run: slices come
    via offset reads (np.fromfile), never mmap — during a multiway
    merge every mmap-touched page stays resident and ru_maxrss grows by
    the TOTAL run bytes (measured 16 GB at a 429M-key merge)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            self._off = f.tell()
        if fortran or len(shape) != 1:
            raise ValueError(f"unexpected spill run layout in {path}")
        self._n = int(shape[0])
        self.dtype = np.dtype(dtype)

    def __len__(self) -> int:
        return self._n

    def read(self, start: int, count: int) -> np.ndarray:
        count = max(0, min(count, self._n - start))
        return np.fromfile(
            self.path, dtype=self.dtype, count=count,
            offset=self._off + start * self.dtype.itemsize,
        )

    def key_at(self, i: int):
        return self.read(i, 1)[0]


class _MemArray:
    """In-memory (keys or counts) remainder with the _RunArray API."""

    def __init__(self, a: np.ndarray):
        self._a = a

    def __len__(self) -> int:
        return len(self._a)

    def read(self, start: int, count: int) -> np.ndarray:
        return self._a[start : start + count]

    def key_at(self, i: int):
        return self._a[i]


class SpillingSparseAccumulator(SparseAccumulator):
    """SparseAccumulator with a host-memory bound (disk-spilled runs).

    The unbounded accumulator reached ~24 GB RSS at a 10M-read k=31
    canonical run (~186M distinct keys plus fold transients) — which
    does not extrapolate to the >= 100M-read BASELINE config-5 target.
    This variant caps the merged in-memory (keys, counts) arrays: when
    they exceed a third of ``budget_bytes`` (the searchsorted merge
    transiently holds ~2x the merged arrays, and the pending buffer
    rides on top), they are written to ``spill_dir`` as one sorted-
    unique run (``.npy`` pair, fsynced) and accumulation restarts
    empty.  The final result is a bounded-memory multiway merge of all
    runs plus the in-memory remainder (:meth:`iter_merged_chunks`) —
    the on-disk extension of the two-level searchsorted merge.

    The reference simply OOM-exited when a table outgrew memory
    (reference ``src/kmer_main.cu:51-56``); this is the capability it
    never had.  Runs double as the CHECKPOINT unit: a checkpoint spills
    the in-memory state and records the run list (append-only, O(new
    data) per checkpoint instead of O(total accumulated)).
    """

    def __init__(self, spill_dir: str, budget_bytes: int,
                 merge_every: int = 32):
        super().__init__(merge_every=merge_every)
        self.spill_dir = str(spill_dir)
        self.budget_bytes = int(budget_bytes)
        self.run_files: list[str] = []  # run basenames, spill order
        self._run_seq = 0

    def add(self, hi, lo, counts) -> None:
        super().add(hi, lo, counts)
        # The budget must see EVERYTHING the accumulator holds: merged
        # arrays AND the un-folded pending buffer (up to merge_every
        # batches — at 10M-read k=31 scale the pending alone is ~2.6 GB
        # between folds; round-5 rerun measured a 10.4 GB sawtooth with
        # a merged-arrays-only trigger).  Trigger at budget/4: the fold
        # inside spill_run transiently holds ~2x the trigger volume
        # (argsort + the interleave allocation), keeping the true peak
        # near 3/4 of the budget.
        pend = sum(pk.nbytes + pc.nbytes for pk, pc in self._pending)
        if (
            self.keys.nbytes + self.counts.nbytes + pend
            >= max(self.budget_bytes // 4, 1 << 12)
        ):
            self.spill_run()

    def spill_run(self) -> None:
        """Write the merged in-memory arrays to disk as one sorted run
        (durable: data fsynced, then the rename, then the directory)."""
        import os

        self._fold()
        if not len(self.keys):
            return
        os.makedirs(self.spill_dir, exist_ok=True)
        base = f"run{self._run_seq:05d}"
        self._run_seq += 1
        for name, arr in (("keys", self.keys), ("counts", self.counts)):
            p = os.path.join(self.spill_dir, f"{base}.{name}.npy")
            tmp = p + ".tmp.npy"
            with open(tmp, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, p)
        dfd = os.open(self.spill_dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self.run_files.append(base)
        self.keys = np.empty(0, dtype=np.uint64)
        self.counts = np.empty(0, dtype=np.int64)

    def checkpoint_runs(self) -> list[str]:
        """Spill pending + in-memory state and return the authoritative
        run list for the checkpoint JSON (append-only checkpointing)."""
        self.spill_run()
        return list(self.run_files)

    def adopt_runs(self, run_files) -> None:
        """Resume from a checkpointed run list: restore it and delete
        any stale spill files from the crashed segment (runs spilled
        after the last durable checkpoint would double-count their
        batches, which the resume replays)."""
        import os

        self.run_files = [str(b) for b in run_files]
        seqs = [
            int(b[3:]) for b in self.run_files
            if b.startswith("run") and b[3:].isdigit()
        ]
        self._run_seq = max(seqs, default=-1) + 1
        keep = {
            f"{b}.{part}.npy"
            for b in self.run_files
            for part in ("keys", "counts")
        }
        if os.path.isdir(self.spill_dir):
            for fn in os.listdir(self.spill_dir):
                if fn not in keep:
                    try:
                        os.remove(os.path.join(self.spill_dir, fn))
                    except OSError:
                        pass
        missing = [
            fn for fn in keep
            if not os.path.exists(os.path.join(self.spill_dir, fn))
        ]
        if missing:
            raise ValueError(f"checkpoint spill runs missing: {missing}")
        self.keys = np.empty(0, dtype=np.uint64)
        self.counts = np.empty(0, dtype=np.int64)
        self._pending = []

    def _open_runs(self):
        import os

        runs = []
        for b in self.run_files:
            ks = _RunArray(os.path.join(self.spill_dir, f"{b}.keys.npy"))
            cs = _RunArray(os.path.join(self.spill_dir, f"{b}.counts.npy"))
            runs.append((ks, cs))
        return runs

    def iter_merged_chunks(self, chunk: int | None = None):
        """Yield the full merged spectrum as ascending (keys, counts)
        chunks; every key appears in exactly ONE chunk (so chunk-local
        duplicate summing is globally exact), keys strictly increase
        across chunks.  Run slices come through bounded pread-style
        reads, NOT mmap: a mmap'd multiway merge leaves every touched
        page resident (measured 16 GB ru_maxrss at a 429M-key merge —
        round 5); with window reads the peak is O(n_runs * chunk).
        This is the >= 100M-read output path: a chunked writer never
        materialises the full key set."""
        self._fold()
        runs = self._open_runs()
        if len(self.keys):
            runs.append((_MemArray(self.keys), _MemArray(self.counts)))
        if not runs:
            return
        if chunk is None:
            per_run = self.budget_bytes // (6 * 16 * max(len(runs), 1))
            chunk = int(min(max(per_run, 1 << 20), 1 << 25))
        cursors = [0] * len(runs)
        while True:
            # Pivot: the smallest "window-end key" over the active runs.
            # Every element <= pivot in ANY run lies within that run's
            # next (chunk+1)-wide window — runs are sorted-unique, so
            # elements past the window-end index strictly exceed its
            # key, which is >= pivot.  Hence one pass consumes exactly
            # the global prefix <= pivot and no key spans two chunks.
            pivot = None
            for (ks, _), c in zip(runs, cursors):
                if c < len(ks):
                    cand = ks.key_at(min(c + chunk, len(ks) - 1))
                    if pivot is None or cand < pivot:
                        pivot = cand
            if pivot is None:
                return
            parts_k: list = []
            parts_c: list = []
            for r, (ks, cs) in enumerate(runs):
                c = cursors[r]
                if c >= len(ks):
                    continue
                win = ks.read(c, chunk + 1)
                e = int(np.searchsorted(win, pivot, side="right"))
                if e == 0:
                    continue
                parts_k.append(win[:e])
                parts_c.append(cs.read(c, e))
                cursors[r] = c + e
            if len(parts_k) == 1:
                # Single surviving run for this range: it is already
                # sorted-unique — skip the concat/argsort/reduceat pass
                # (the common case once other runs are exhausted).
                yield parts_k[0], parts_c[0]
                continue
            allk = np.concatenate(parts_k)
            allc = np.concatenate(parts_c)
            del parts_k, parts_c
            order = np.argsort(allk, kind="stable")
            allk = allk[order]
            allc = allc[order]
            starts = np.r_[0, np.flatnonzero(allk[1:] != allk[:-1]) + 1]
            yield allk[starts], np.add.reduceat(allc, starts)

    def result_arrays(self):
        self._fold()
        if not self.run_files:
            return self.keys, self.counts
        ks: list = []
        cs: list = []
        for k_chunk, c_chunk in self.iter_merged_chunks():
            ks.append(k_chunk)
            cs.append(c_chunk)
        if not ks:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        return np.concatenate(ks), np.concatenate(cs)

    def cleanup_spill(self) -> None:
        """Remove all spill files and the directory (end of run)."""
        import shutil

        shutil.rmtree(self.spill_dir, ignore_errors=True)


class DenseFoldAccumulator:
    """SparseAccumulator drop-in for SMALL key spaces (k <= 10).

    At 4**k <= 1M bins the dense int64 table is <= 8 MB — folding each
    batch's (key, count) cells straight into it with the THREADED
    native histogram (io/native fold_pairs, ~7 ms per 32768-read batch
    on this 4-vCPU VM vs ~30 ms for NumPy's weighted bincount) beats
    the searchsorted sparse merge outright and IS the host half of the
    sorted spectrum route's device-side analog the reference kept in
    device memory (reference ``src/kmer_kernel.cu:87``).  Same
    interface as SparseAccumulator: add(hi, lo, counts) /
    result_arrays() / load_arrays().
    """

    def __init__(self, k: int):
        if not 1 <= k <= 10:
            raise ValueError("DenseFoldAccumulator supports k <= 10")
        self.table = np.zeros(4**k, dtype=np.int64)

    def add(self, hi, lo, counts) -> None:
        # hi is structurally zero for every k <= 15 pair row
        # (rows_to_triples); count<=0 cells (sentinels, padding) are
        # skipped inside the fold.
        self.add_pairs(lo, counts)

    def add_pairs(self, idx, counts) -> None:
        """Fold a drain-narrowed (idx, counts) pair directly — the
        streaming driver's fast path, skipping the triple packaging.
        The native fold consumes uint16/int32 idx and uint8/int16/int32
        counts as-is (io/native fold_pairs), so no widening copy ever
        touches the ~50 MB/batch pair buffers."""
        from ..io.native import fold_pairs_into

        fold_pairs_into(self.table, np.asarray(idx), np.asarray(counts))

    def result_arrays(self):
        keys = np.flatnonzero(self.table)
        return keys.astype(np.uint64), self.table[keys]

    def iter_merged_chunks(self, chunk: int | None = None):
        keys, counts = self.result_arrays()
        chunk = chunk or (1 << 24)
        for s in range(0, len(keys), chunk):
            yield keys[s : s + chunk], counts[s : s + chunk]

    def load_arrays(self, keys, counts) -> None:
        self.table[:] = 0
        self.table[np.asarray(keys, dtype=np.int64)] = np.asarray(
            counts, dtype=np.int64
        )


def decode_key(key: int, k: int) -> str:
    """Integer k-mer code → base string (for output/debugging)."""
    bases = "ACGT"
    return "".join(bases[(key >> (2 * (k - 1 - i))) & 3] for i in range(k))
