"""Native (C++) host ingest + output formatting, with pure-Python fallback.

``parse_encode_bytes`` / ``format_rows_bytes`` dispatch to the compiled
``_fastaio`` extension when present (build: ``python setup.py build_ext
--inplace`` at the repo root) and otherwise to the NumPy implementations
in ``cfrk_tpu.io.fasta`` / ``cfrk_tpu.format``.  Both paths are pinned
byte-identical by tests/test_native.py.

This mirrors the split in the reference, whose ingest and writer were
plain C (``src/fastaIO.h``, ``src/main.cu:26-62``) while the compute
core was device code.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "HAVE_NATIVE",
    "HAVE_STREAM_NATIVE",
    "HAVE_PACK_NATIVE",
    "HAVE_QUAL_NATIVE",
    "parse_encode_bytes",
    "read_fasta_encoded_native",
    "iter_record_blocks_native",
    "format_rows_bytes",
    "format_pairs_bytes",
    "format_dense_pairs_bytes",
    "fold_pairs_into",
    "HAVE_FOLD_NATIVE",
    "format_kmer_tsv_bytes",
    "HAVE_KMER_TSV_NATIVE",
]

try:
    from . import _fastaio  # type: ignore[attr-defined]

    HAVE_NATIVE = True
except ImportError:  # extension not built — pure-Python fallback
    _fastaio = None
    HAVE_NATIVE = False

# A stale prebuilt .so from an older checkout imports fine but lacks the
# newer entry points; gate each fast path on the symbols it needs so
# stale builds degrade to the pure-Python path instead of crashing.
HAVE_STREAM_NATIVE = HAVE_NATIVE and hasattr(_fastaio, "parse_encode_stream")
HAVE_PACK_NATIVE = HAVE_NATIVE and hasattr(_fastaio, "pack_records")
HAVE_FOLD_NATIVE = HAVE_NATIVE and hasattr(_fastaio, "fold_pairs")
HAVE_KMER_TSV_NATIVE = HAVE_NATIVE and hasattr(_fastaio, "format_kmer_tsv")


def format_kmer_tsv_bytes(keys, counts, k: int, min_count: int = 1):
    """Threaded native ``KMERSTRING\\tcount\\n`` rows for a sparse
    spectrum chunk (byte-identical to the Python decode_key writer), or
    None when the extension lacks the symbol (caller falls back)."""
    import numpy as np

    if not HAVE_KMER_TSV_NATIVE:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    if keys.size != counts.size:
        raise ValueError("keys/counts size mismatch")
    return _fastaio.format_kmer_tsv(
        keys, counts, keys.size, int(k), int(min_count)
    )


def _probe_qual_support() -> bool:
    """True when the built extension accepts the min_qual_byte argument
    (older .so builds predate it: parse_encode was METH_O)."""
    if not HAVE_NATIVE:
        return False
    try:
        _fastaio.parse_encode(b"", 0)
        return True
    except TypeError:
        return False


HAVE_QUAL_NATIVE = _probe_qual_support()


def parse_encode_bytes(data: bytes, min_qual: int = 0) -> list[np.ndarray]:
    """Parse a raw (already-decompressed) FASTA buffer into encoded reads.

    ``min_qual`` masks FASTQ bases below that Phred+33 quality to the
    invalid code (no-op for FASTA)."""
    native_ok = _fastaio is not None and (not min_qual or HAVE_QUAL_NATIVE)
    if native_ok:
        codes_b, lens_b = _fastaio.parse_encode(
            data, 33 + min_qual if min_qual else 0
        )
        codes = np.frombuffer(codes_b, dtype=np.int8)
        lengths = np.frombuffer(lens_b, dtype=np.int64)
        offsets = np.concatenate(([0], np.cumsum(lengths)))
        return [
            codes[offsets[i] : offsets[i + 1]] for i in range(len(lengths))
        ]
    import io as _io

    from ..fasta import encode_seq, iter_reads

    # iter_reads sniffs FASTA vs FASTQ from the first record byte, the
    # same dispatch the C++ parse_encode does — the fallback must accept
    # the same inputs as the extension.
    return [encode_seq(s) for _, s in iter_reads(_io.BytesIO(data), min_qual)]


def iter_record_blocks_native(
    path,
    start_offset: int | None = None,
    block_size: int = 64 << 20,
    limit_offset: int | None = None,
    decompress: bool = False,
    min_qual: int = 0,
):
    """Stream (flat_codes int8, lengths int64, end_offsets int64) blocks
    through the chunked C++ parser (plain uncompressed files only).

    Each yielded block covers the records COMPLETED within ~block_size
    bytes of input; ``end_offsets`` are absolute file positions just past
    each record — the checkpoint seek points (same contract as
    io.fasta.iter_encoded_with_offsets).  Incomplete trailing records
    carry over to the next block; a record larger than the block doubles
    the read size until it fits.  This replaces the per-line Python
    ``readline`` loop for streaming-scale ingest (the reference's ingest
    was a single C pass, reference src/fastaIO.h:24-102).

    ``limit_offset``: stop BEFORE the first record whose start position
    is >= limit (a FASTA record's start equals the previous record's
    end offset, so byte-range host sharding covers every record exactly
    once when ranges abut at aligned boundaries — see
    parallel/distributed.align_to_record).

    ``decompress=True`` streams a gzip input through the same chunked
    parser (decompression overlaps downstream packing in the lookahead
    thread).  Offsets are then positions in the DECOMPRESSED stream:
    monotonic, but NOT seekable resume points — callers must checkpoint
    by record count instead (pipeline/stream.py does).  ``start_offset``
    / ``limit_offset`` are rejected, matching the no-random-access
    contract of a gzip stream.

    ``path`` may also be an open binary stream (e.g. stdin for pipe
    ingest): it is read sequentially and closed at EOF; offsets are
    stream positions (not seekable resume points for a pipe), and
    ``start_offset``/``decompress`` must be unset.
    """
    if not HAVE_STREAM_NATIVE or (min_qual and not HAVE_QUAL_NATIVE):
        # Also covers a stale prebuilt .so that predates
        # parse_encode_stream (or its min_qual_byte argument) — fail
        # with the contract error, not a TypeError/AttributeError from
        # inside the lookahead thread.
        raise RuntimeError("native extension not built (or stale build)")
    from concurrent.futures import ThreadPoolExecutor

    qthr = 33 + min_qual if min_qual else 0

    if hasattr(path, "read"):  # already-open stream (stdin pipe ingest)
        if start_offset or decompress:
            raise ValueError("a stream input has no random access")
        opened = path
    elif decompress:
        from ..bgzf import open_maybe_bgzf

        # bgzf inputs (bgzip'd FASTQ — the common config-5 framing)
        # inflate blocks on a thread pool; plain gzip stays single
        # stream (no boundaries without inflating).  Offsets for bgzf
        # are DECOMPRESSED positions and ARE resume points: BgzfReader
        # seeks them from block metadata alone.
        opened = open_maybe_bgzf(path)
        seekable = hasattr(getattr(opened, "raw", None), "seek_decompressed")
        if (start_offset or limit_offset is not None) and not seekable:
            opened.close()
            raise ValueError(
                "byte offsets cannot address a gzip stream; "
                "decompress the input first (or recompress with bgzip "
                "— bgzf offsets are decompressed positions and work "
                "for both resume and byte-range sharding)"
            )
    else:
        opened = open(path, "rb")
    with opened as f, ThreadPoolExecutor(1) as pool:
        if start_offset:
            if decompress:
                f.raw.seek_decompressed(start_offset)
            else:
                f.seek(start_offset)
        base = start_offset or 0
        carry = b""
        fastq = None
        bs = block_size

        def read_parse(carry, bs, fastq):
            """Read + C-parse one block (GIL released in the parser);
            runs one block AHEAD of the consumer so downstream packing
            overlaps the parse."""
            data = f.read(bs)
            final = len(data) == 0
            buf = carry + data if carry else data
            if not buf:
                return None
            fq = buf.lstrip(b"\r\n")[:1] == b"@" if fastq is None else fastq
            return (
                buf, fq, final,
                _fastaio.parse_encode_stream(buf, fq, final, qthr),
            )

        rec_start = base  # start position of the next record to yield
        fut = pool.submit(read_parse, carry, bs, fastq)
        while True:
            got = fut.result()
            if got is None:
                return
            buf, fastq, final, (codes_b, lens_b, offs_b, consumed) = got
            if not final:
                if consumed == 0:
                    bs *= 2  # record larger than the block: widen
                carry = buf[consumed:]
                fut = pool.submit(read_parse, carry, bs, fastq)
            lens = np.frombuffer(lens_b, dtype=np.int64)
            if len(lens):
                codes = np.frombuffer(codes_b, dtype=np.int8)
                offs = np.frombuffer(offs_b, dtype=np.int64) + base
                if limit_offset is not None:
                    # record i starts at offs[i-1] (rec_start for i=0):
                    # keep records starting BEFORE the limit.
                    starts = np.concatenate(([rec_start], offs[:-1]))
                    keep = int(np.searchsorted(starts, limit_offset, "left"))
                    if keep < len(lens):
                        nbytes = int(lens[:keep].sum())
                        if keep:
                            yield codes[:nbytes], lens[:keep], offs[:keep]
                        return
                    rec_start = int(offs[-1])
                yield codes, lens, offs
            if final:
                return
            base += consumed


def read_fasta_encoded_native(path, min_qual: int = 0) -> list[np.ndarray]:
    """Read + encode a FASTA file (gzip ok) through the native parser."""
    from ..fasta import _open_maybe_gzip

    with _open_maybe_gzip(path) as f:
        return parse_encode_bytes(f.read(), min_qual)


def format_pairs_bytes(
    idx: np.ndarray, counts: np.ndarray, *, first: bool = True
) -> bytes:
    """Format sparse per-read (idx, counts) pair rows as `.cfrk` bytes
    (cells with count <= 0 skipped; see format.format_rows_pairs).

    64-bit indices (k > 15 combined codes) use the C uint64 variant."""
    idx = np.asarray(idx)
    wide = idx.dtype.itemsize > 4
    if wide:
        idx = np.ascontiguousarray(idx, dtype=np.uint64)
    else:
        idx = np.ascontiguousarray(idx, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    if idx.shape != counts.shape or idx.ndim != 2:
        raise ValueError("idx/counts must be equal-shape 2-D")
    if _fastaio is not None:
        n_rows, n_cols = idx.shape
        fmt = _fastaio.format_pairs64 if wide else _fastaio.format_pairs
        return fmt(idx.tobytes(), counts.tobytes(), n_rows, n_cols, first)
    from ...format import format_rows_pairs

    if idx.shape[0] == 0:
        return b""  # match the C path: no rows, no bytes
    body = b"\n".join(format_rows_pairs(idx, counts))
    return body if first else b"\n" + body


def format_dense_pairs_bytes(
    idx: np.ndarray, counts: np.ndarray, fk: int, *, first: bool = True
) -> bytes:
    """DENSE `.cfrk` rows (all ``fk`` bins per row) from sparse per-read
    (idx, counts) pair matrices — byte-identical to ``format_rows_bytes``
    on the densified matrix, without the caller materialising it.  Rows
    must be ascending in idx with count<=0 cells as padding (the
    sort-based sparse ops' contract)."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    if idx.shape != counts.shape or idx.ndim != 2:
        raise ValueError("idx/counts must be equal-shape 2-D")
    if _fastaio is not None and hasattr(_fastaio, "format_dense_pairs"):
        n_rows, n_cols = idx.shape
        return _fastaio.format_dense_pairs(
            idx.tobytes(), counts.tobytes(), n_rows, n_cols, int(fk), first
        )
    # Fallback (and stale-.so) path: densify in NumPy, reuse the dense
    # formatter.  Same bytes, more host memory — CI/debug only.
    if idx.shape[0] == 0:
        return b""
    dense = np.zeros((idx.shape[0], int(fk)), dtype=np.int32)
    rows = np.repeat(np.arange(idx.shape[0]), idx.shape[1])
    flat_i = idx.ravel()
    flat_c = counts.ravel()
    keep = flat_c > 0
    dense[rows[keep], flat_i[keep]] = flat_c[keep]
    return format_rows_bytes(dense, first=first)


def fold_pairs_into(table: np.ndarray, idx: np.ndarray, counts: np.ndarray) -> None:
    """Accumulate (idx, count) cells into a dense int64 ``table`` in place.

    The host fold of the sorted spectrum route for k <= 10: ``idx`` /
    ``counts`` are the drain-narrowed pair matrices (any shape, same
    size); cells with count <= 0 (sentinels, padding) are skipped.
    Native path: threaded typed loop with private tables (~10-20x
    NumPy's float-weights bincount); fallback: masked bincount.
    """
    if table.dtype != np.int64 or not table.flags.writeable:
        raise ValueError("table must be a writable int64 array")
    if (
        idx.ndim == 2
        and idx.shape == counts.shape
        and not idx.flags.c_contiguous
        and idx.flags.f_contiguous
        and counts.flags.f_contiguous
    ):
        # Column-major inputs: a histogram is cell-order-invariant, so
        # transposing BOTH views (zero-copy — .T of an F-array is
        # C-contiguous) keeps the (idx, count) pairing without the
        # strided copy ascontiguousarray would make.
        idx = idx.T
        counts = counts.T
    idx = np.ascontiguousarray(idx)
    counts = np.ascontiguousarray(counts)
    if idx.size != counts.size:
        raise ValueError("idx/counts size mismatch")
    if idx.dtype == np.uint32:
        # lo keys are < 2**31 for every k <= 15; the uint32 sentinel
        # reinterprets negative and is skipped by the bounds check
        # (its count is 0 anyway) — zero-copy view, not a cast.
        idx = idx.view(np.int32)
    if idx.dtype not in (np.uint16, np.int32):
        idx = idx.astype(np.int32, copy=False)
    if counts.dtype not in (np.uint8, np.int16, np.int32, np.int64):
        counts = counts.astype(np.int32, copy=False)
    if HAVE_FOLD_NATIVE:
        # Arrays pass through the buffer protocol — no serialization
        # copies on the per-batch hot path.
        _fastaio.fold_pairs(
            idx, idx.dtype.itemsize,
            counts, counts.dtype.itemsize,
            idx.size, table,
        )
        return
    fi = idx.reshape(-1).astype(np.int64, copy=False)
    fc = counts.reshape(-1).astype(np.int64, copy=False)
    keep = (fc > 0) & (fi >= 0) & (fi < table.size)
    table += np.bincount(
        fi[keep], weights=fc[keep], minlength=table.size
    ).astype(np.int64)


def format_rows_bytes(counts: np.ndarray, *, first: bool = True) -> bytes:
    """Format a ``[n, 4**k]`` count block as `.cfrk` bytes.

    ``first=False`` prefixes a newline (continuation of a started file).
    """
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    if _fastaio is not None:
        n_rows, n_cols = counts.shape
        return _fastaio.format_rows(counts.tobytes(), n_rows, n_cols, first)
    from ...format import format_rows

    if counts.shape[0] == 0:
        return b""  # match the C path: no rows, no bytes
    body = b"\n".join(format_rows(counts))
    return body if first else b"\n" + body
