"""Ragged reads → fixed-shape device batches.

XLA traces and compiles each distinct shape once; the reference's dynamic
per-chunk buffer sizing (``src/main.cu:160-206`` SelectChunk) becomes
padding to a small set of static shapes here, so every chunk of a large
run reuses one compiled executable.

Layout: ``codes[B, L]`` int8 with 0..3 = bases and -1 = invalid/padding,
``lengths[B]`` int32.  Padding with -1 makes window validity purely local:
a window is valid iff all its codes are ≥ 0 — no separate length masking
is needed in the kernels (pad bytes poison any window that overlaps them,
which is exactly the separator semantics of the reference's flat ``-1``
delimited array, ``src/fastaIO.h:74-102``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np

__all__ = [
    "ReadBatch",
    "pad_reads",
    "pad_reads_flat",
    "iter_batches",
    "len_bucket",
    "round_up",
    "auto_batch_size",
]

PAD = -1

# Padded bases per device batch targeted by auto batch sizing.  It is a
# memory bound first: reads/batch scale INVERSELY with read length, so a
# batch of long contigs holds about as many padded bases (and per-window
# key/pair streams on the device) as a batch of short reads, while short
# reads still get batches large enough to amortize the fixed per-dispatch
# host cost.  The value has not been tuned on the H100.
AUTO_BATCH_TARGET_BASES = 8 << 20


def auto_batch_size(read_len_hint: int | None) -> int:
    """Reads/batch for a read-length hint (the CLI/bench default).

    AUTO_BATCH_TARGET_BASES // len_bucket(hint), clamped to [512, 65536]
    and rounded to a 512 multiple.  Contig-class rows (bucket > 64 kb)
    drop the 512-read floor, which would override the padded-bases
    bound by up to 32x: they clamp to [8, ...] in 8-multiples.  Without
    a hint (unreadable input, stdin) the historical 8192 stands.
    """
    if not read_len_hint:
        return 8192
    bucket = len_bucket(max(int(read_len_hint), 1))
    b = AUTO_BATCH_TARGET_BASES // bucket
    if bucket > 65536:
        return max(8, (b // 8) * 8)
    return max(512, min(65536, (b // 512) * 512))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ReadBatch:
    """A fixed-shape batch of encoded reads.

    codes:    [B, L] int8, 0..3 valid, -1 invalid/pad.
    lengths:  [B] int32 true read lengths (0 for padding rows).
    n_reads:  number of real (non-padding) rows.
    """

    codes: np.ndarray
    lengths: np.ndarray
    n_reads: int
    # Input byte offset just past this batch's last record, when the
    # source supports it (plain uncompressed files); enables O(1)
    # checkpoint resume by seek instead of re-streaming.
    end_offset: int | None = None

    @property
    def batch_size(self) -> int:
        return self.codes.shape[0]

    @property
    def max_len(self) -> int:
        return self.codes.shape[1]


def pad_reads(
    reads: Sequence[np.ndarray],
    batch_size: int | None = None,
    max_len: int | None = None,
    len_multiple: int = 128,
) -> ReadBatch:
    """Pack a ragged list of code arrays into one padded batch.

    Reads longer than ``max_len`` raise (callers split long reads upstream;
    the reference silently truncated reads at 1024 bases — a bug we do not
    reproduce, see SURVEY.md §2 #8).
    """
    n = len(reads)
    b = batch_size or n
    if n > b:
        raise ValueError(f"{n} reads > batch_size {b}")
    longest = max((len(r) for r in reads), default=0)
    ml = max_len or round_up(max(longest, 1), len_multiple)
    if longest > ml:
        raise ValueError(f"read of length {longest} exceeds max_len {ml}")
    codes = np.full((b, ml), PAD, dtype=np.int8)
    lengths = np.zeros(b, dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
        lengths[i] = len(r)
    return ReadBatch(codes=codes, lengths=lengths, n_reads=n)


def pad_reads_flat(
    flat: np.ndarray,
    lengths: np.ndarray,
    batch_size: int | None = None,
    max_len: int | None = None,
    len_multiple: int = 128,
) -> ReadBatch:
    """Vectorised :func:`pad_reads` for a FLAT code buffer + lengths.

    ``flat`` is the concatenation of the reads' codes in order (the
    native chunked parser's output layout, io/native); ``lengths`` their
    per-read lengths.  Row-major boolean scatter places each read into
    its padded row without a Python per-read loop — the difference is
    ~100x at streaming scale.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(lengths)
    b = batch_size or n
    if n > b:
        raise ValueError(f"{n} reads > batch_size {b}")
    longest = int(lengths.max(initial=0))
    ml = max_len or round_up(max(longest, 1), len_multiple)
    if longest > ml:
        raise ValueError(f"read of length {longest} exceeds max_len {ml}")
    if int(lengths.sum()) != len(flat):
        raise ValueError("lengths do not sum to the flat buffer size")
    from ..io.native import HAVE_PACK_NATIVE, _fastaio

    flat = np.ascontiguousarray(flat, dtype=np.int8)
    if HAVE_PACK_NATIVE:
        # memcpy/memset per record in C — multi-GB/s.  The arrays pass
        # through the buffer protocol (no serialisation copies); the
        # result view stays read-only, which every consumer honours
        # (device transfer copies anyway).
        packed = _fastaio.pack_records(
            flat, np.ascontiguousarray(lengths), b, ml
        )
        codes = np.frombuffer(packed, dtype=np.int8).reshape(b, ml)
    else:
        codes = np.full((b, ml), PAD, dtype=np.int8)
        # mask rows are prefixes, so the True positions in row-major
        # order are exactly the reads' codes laid end to end.
        mask = np.arange(ml, dtype=np.int64)[None, :] < lengths[:, None]
        codes[:n][mask] = flat
    out_lengths = np.zeros(b, dtype=np.int32)
    out_lengths[:n] = lengths
    return ReadBatch(codes=codes, lengths=out_lengths, n_reads=n)


def len_bucket(n: int, base: int = 128) -> int:
    """Smallest base·2^j >= n: bounds compiled shapes to O(log L)."""
    b = base
    while b < n:
        b *= 2
    return b


def iter_batches(
    reads: Iterable[np.ndarray],
    batch_size: int,
    max_len: int | None = None,
) -> Iterator[ReadBatch]:
    """Chunk a read stream into fixed-shape batches (analog of the
    reference's chunk partitioner, ``src/main.cu:160-206``).

    With ``max_len=None`` each batch pads to the geometric length
    bucket of ITS OWN longest read — one 20 kb contig among short reads
    then widens only its own batch, not the whole run (the set of
    compiled shapes stays O(log L))."""
    buf: list[np.ndarray] = []

    def flush():
        ml = max_len if max_len is not None else len_bucket(
            max(max(len(r) for r in buf), 1)
        )
        return pad_reads(buf, batch_size, ml)

    for r in reads:
        buf.append(np.asarray(r, dtype=np.int8))
        if len(buf) == batch_size:
            yield flush()
            buf = []
    if buf:
        yield flush()
