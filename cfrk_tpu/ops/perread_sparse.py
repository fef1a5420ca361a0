"""Sparse per-read k-mer counting for 8 < k <= 31 (sort-based).

A dense per-read table at k=15 would be 4**15 = 1 GiB *per read*; the
reference simply refused such configurations with a device-OOM exit
(reference ``src/kmer_main.cu:51-56``).  Since a read of length L holds
at most L-k+1 distinct k-mers, the per-read result is naturally sparse:
sort each read's window indices and run-length encode, entirely
on-device with static shapes (``lax.sort`` along the window axis — the
same sort-as-hash-table design as ops/sparse.py, but per row).

Output pairs rows with the ``--nonzero`` `.cfrk` row format (ascending
``idx:count`` cells), which is exactly what sorted RLE produces.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .encode import window_indices

__all__ = [
    "count_perread_sparse",
    "count_perread_sparse_large",
    "count_perread_rows",
    "compact_pairs",
    "valid_pair_prefix",
    "pairs_to_host",
    "MAX_SPARSE_PERREAD_K",
]


def count_perread_rows(codes, k: int, canonical: bool = False):
    """Per-read sparse histogram rows — the one dispatcher every driver
    (in-memory, streaming, sharded local function) routes through.

    Returns the sorted-RLE row layout of :func:`count_perread_sparse`
    ((idx, counts) for k <= 15) or :func:`count_perread_sparse_large`
    ((hi, lo, counts) for 16 <= k <= 31): XLA's row sort followed by
    the shared RLE, at any row width.
    """
    if k <= 15:
        return count_perread_sparse(codes, k, canonical)
    return count_perread_sparse_large(codes, k, canonical)


def compact_pairs(idx: jax.Array, counts: jax.Array, k: int):
    """Narrow a (idx, counts) pair's dtypes before the device→host fetch.

    For k <= 8 every REAL index fits uint16 (< 4**8 = 65536); the
    sentinel 4**k wraps to 0, but it only appears on count-0 cells,
    which every consumer (the pair formatters) skips — so the wrap is
    unobservable.  Counts are bounded by windows/read: uint8 below 256
    (short reads — the common case), int16 below 2**15.  Every byte cut
    here is device-to-host transfer saved on each batch.
    :func:`pairs_to_host` widens back to int32 for the formatter.
    """
    if k <= 8:
        idx = idx.astype(jnp.uint16)
    w = counts.shape[-1]
    if w < 256:
        counts = counts.astype(jnp.uint8)
    elif w < 2**15:
        counts = counts.astype(jnp.int16)
    return idx, counts

MAX_SPARSE_PERREAD_K = 15


def rle_rows(keys: tuple, is_real: jax.Array, sentinels: tuple):
    """Run-length-encode SORTED key rows (the shared RLE core).

    keys: tuple of [B, W] arrays forming one lexicographic key;
    is_real: [B, W] bool, False for sentinel/invalid positions (must be
    sorted to the row tails); sentinels: per-key scalar written at
    non-run-start positions.  Returns ``(*masked_keys, counts)``:
    position j of a row holds a distinct key and its count iff it is
    the first element of its run, else the sentinel with count 0.
    """
    b, w = keys[0].shape
    neq = keys[0][:, 1:] != keys[0][:, :-1]
    for kk in keys[1:]:
        neq = neq | (kk[:, 1:] != kk[:, :-1])
    first = jnp.ones((b, w), dtype=bool).at[:, 1:].set(neq) & is_real
    pos = jax.lax.broadcasted_iota(jnp.int32, (b, w), 1)
    boundary = jnp.where(first | ~is_real, pos, w)
    suffix_min = jnp.flip(
        jax.lax.associative_scan(jnp.minimum, jnp.flip(boundary, -1), axis=-1),
        -1,
    )
    nxt_after = jnp.concatenate(
        [suffix_min[:, 1:], jnp.full((b, 1), w, jnp.int32)], axis=-1
    )
    counts = jnp.where(first, nxt_after - pos, 0).astype(jnp.int32)
    masked = tuple(
        jnp.where(first, kk, s) for kk, s in zip(keys, sentinels)
    )
    return *masked, counts


@partial(jax.jit, static_argnums=(1, 2))
def count_perread_sparse(codes: jax.Array, k: int, canonical: bool = False):
    """Per-read sparse histograms.

    codes: [B, L] int8 → (idx, counts), both [B, W] int32 with
    W = L-k+1.  Each row is sorted ascending; position j holds a distinct
    k-mer index and its count iff it is the first element of its run;
    all other positions hold the sentinel ``4**k`` with count 0.
    """
    if not 1 <= k <= MAX_SPARSE_PERREAD_K:
        raise ValueError(f"k must be in [1, {MAX_SPARSE_PERREAD_K}]")
    sent = jnp.int32(4**k)
    idx = window_indices(codes, k, canonical)  # [B, W], -1 invalid
    x = jnp.where(idx < 0, sent, idx)
    x = jax.lax.sort(x, dimension=-1)
    idx_out, counts = rle_rows((x,), x != sent, (sent,))
    return idx_out, counts


@partial(jax.jit, static_argnums=(1, 2))
def count_perread_sparse_large(codes: jax.Array, k: int, canonical: bool = False):
    """Per-read sparse histograms for large k (16..31).

    codes: [B, L] int8 → (hi, lo, counts), each [B, W] int32/uint32 with
    W = L-k+1.  Keys use the (hi, lo) split of ops/sparse.py (hi = first
    k-15 bases, lo = last 15); rows are sorted lexicographically, RLE'd
    as in :func:`count_perread_sparse`, invalid/run-tail positions carry
    the uint32 sentinel with count 0.  The combined 2k-bit code is
    ``hi * 4**15 + lo`` (fits uint64 for k <= 31).
    """
    from .sparse import INVALID_SENTINEL, kmer_keys

    hi, lo = kmer_keys(codes, k, canonical)  # [B, W] uint32, sentinel invalid
    hi, lo = jax.lax.sort((hi, lo), dimension=-1, num_keys=2)
    return rle_rows(
        (hi, lo), lo != INVALID_SENTINEL, (INVALID_SENTINEL, INVALID_SENTINEL)
    )


def narrow_for_fetch(device_out, k: int):
    """Apply the device→host dtype narrowing policy to a sparse per-read
    result: :func:`compact_pairs` for a (idx, counts) pair, int16 count
    narrowing for a (hi, lo, counts) triple (per-row counts are bounded
    by windows/read = ``counts.shape[-1]``).  EVERY driver drain — the
    streaming and in-memory paths, mesh or single device — must route
    through this one function so the narrowing policy cannot drift
    between them; :func:`pairs_to_host` widens back on host."""
    if len(device_out) == 2:
        return compact_pairs(*device_out, k)
    hi, lo, cnt = device_out
    w = cnt.shape[-1]
    if w < 256:  # counts bounded by windows/read: uint8 for short reads
        cnt = cnt.astype(jnp.uint8)
    elif w < 2**15:
        cnt = cnt.astype(jnp.int16)
    return hi, lo, cnt


def valid_pair_prefix(rows, w: int):
    """Slice per-read RLE pair rows to their first ``w`` columns before
    a D2H fetch.  Exact for any sorted-RLE row layout: a row's real
    keys sort ahead of the sentinels, so every run-start (the only
    cells with count > 0) sits within the first ``n_real <= w``
    positions — columns past ``w`` are structurally (sentinel, 0).
    The spectrum fold drains use it to cut D2H and host-fold traffic
    by the pad fraction (256/143 ≈ 1.8x at k=9/150 bp); per-read
    ``.cfrk`` drains keep the full rows (their formatters are already
    count-masked, but the exact-layout tests pin the padded shape)."""
    return tuple(a[..., :w] for a in rows)


def pairs_to_host(device_out, n_reads: int):
    """Normalise a sparse per-read device result to host (idx, counts).

    Accepts either the small-k (idx, counts) pair or the large-k
    (hi, lo, counts) triple; for the latter the combined 64-bit code is
    ``hi * 4**LO_BASES + lo`` (sentinel rows keep count 0 and are
    skipped by the formatter).
    """
    import numpy as np

    from .sparse import LO_BASES

    if len(device_out) == 2:
        idx, counts = device_out
        # Widen compact_pairs dtypes back: the native formatters take
        # int32 buffers (and uint16 must not sign-confuse anyone).
        return (
            np.asarray(idx)[:n_reads].astype(np.int32, copy=False),
            np.asarray(counts)[:n_reads].astype(np.int32, copy=False),
        )
    hi, lo, counts = device_out
    hi = np.asarray(hi)[:n_reads].astype(np.uint64)
    lo = np.asarray(lo)[:n_reads].astype(np.uint64)
    combined = (hi << np.uint64(2 * LO_BASES)) | lo
    # Widen narrow_for_fetch's int16 back on host (as for the pair case).
    return combined, np.asarray(counts)[:n_reads].astype(np.int32, copy=False)
