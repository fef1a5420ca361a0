"""Sharded sparse spectra: all_to_all bucket routing for large k.

BASELINE.json config 4 ("k=31 canonical k-mers with sharded hash table +
all-to-all bucket routing, multi-host").  Each device:

1. extracts its local reads' (hi, lo) keys (ops/sparse.py);
2. assigns every key a bucket = owner device (top bits of the key, so
   the global output is ordered by device rank);
3. sorts locally by (bucket, hi, lo) and counts per-bucket occupancy;
4. exchanges fixed-capacity bucket boxes with ``all_to_all``;
5. re-sorts what it received and run-length-encodes — each device now
   holds the exact global counts for its own key range.

Fixed-shape discipline: all_to_all needs equal-sized boxes, so each
bucket box has capacity ``slack * W_local / n_devices``; overflow is
detected and reported (an ``overflowed`` flag per device) rather than
silently dropped.  With random genomes the bucket distribution is
near-uniform; callers raise capacity for skewed data.

This is the equivalent of the reference's *absent*
distributed layer — the reference only ever sharded whole files across
processes (reference ``swift/cfrk.swf:14-20``).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.sparse import INVALID_SENTINEL, LO_BASES, kmer_keys, _rle

__all__ = ["sparse_spectrum_sharded", "sparse_spectrum_sharded_retry"]


def _bucket_of(hi: jax.Array, lo: jax.Array, k: int, n_dev: int) -> jax.Array:
    """Owner device of a key: the top log2(n_dev) bits of the 2k-bit code.

    Keeping key ranges contiguous per device means concatenating the
    per-device outputs yields one globally sorted spectrum.
    """
    bits = (n_dev - 1).bit_length() if n_dev > 1 else 0
    if bits == 0:
        # One device owns everything; avoid a >= 32-bit shift below
        # (undefined for uint32 operands).
        return jnp.zeros(lo.shape, dtype=jnp.int32)
    if k > LO_BASES:
        hi_bits = 2 * (k - LO_BASES)
        if hi_bits >= bits:
            b = (hi >> jnp.uint32(hi_bits - bits)).astype(jnp.int32)
        else:
            # hi alone has fewer bits than the bucket needs (k = 16..17
            # on an 8+ device mesh): borrow the remainder from the top
            # of lo so all n_dev buckets are populated — still the top
            # ``bits`` bits of the combined 2k-bit code, so per-device
            # key ranges stay contiguous.
            take = bits - hi_bits
            b = (
                (hi << jnp.uint32(take))
                | (lo >> jnp.uint32(2 * LO_BASES - take))
            ).astype(jnp.int32)
    else:
        b = (lo >> jnp.uint32(max(2 * k - bits, 0))).astype(jnp.int32)
    return jnp.minimum(b, n_dev - 1)


@lru_cache(maxsize=None)
def _sparse_sharded_fn(mesh: Mesh, k: int, canonical: bool, slack: float):
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]

    # For k <= LO_BASES the hi key half is structurally 0 for every
    # valid key (sentinel exactly when lo is): drop it from the sorts
    # AND the all_to_all — one third less exchange traffic and half
    # the re-sort operands — and reconstruct it after the RLE.
    small = k <= LO_BASES

    def local(codes_blk):
        hi, lo = kmer_keys(codes_blk, k, canonical)
        hi, lo = hi.reshape(-1), lo.reshape(-1)
        n_local = lo.shape[0]
        cap = int(slack * n_local / n_dev) if n_dev > 1 else n_local
        cap = max(((cap + 7) // 8) * 8, 8)

        bucket = jnp.where(
            lo == INVALID_SENTINEL, n_dev, _bucket_of(hi, lo, k, n_dev)
        ).astype(jnp.int32)
        # Sort by (bucket, hi, lo): buckets become contiguous, invalid last.
        if small:
            bucket, lo = jax.lax.sort((bucket, lo), num_keys=2)
        else:
            bucket, hi, lo = jax.lax.sort((bucket, hi, lo), num_keys=3)

        if n_dev > 1:
            # Slot each key into its bucket box at a fixed offset.
            pos = jnp.arange(n_local, dtype=jnp.int32)
            bucket_start = jnp.searchsorted(
                bucket, jnp.arange(n_dev, dtype=jnp.int32), side="left"
            ).astype(jnp.int32)
            offset = pos - bucket_start[jnp.minimum(bucket, n_dev - 1)]
            bucket_count = (
                jnp.searchsorted(
                    bucket, jnp.arange(n_dev, dtype=jnp.int32), side="right"
                ).astype(jnp.int32)
                - bucket_start
            )
            overflowed = jnp.any(bucket_count > cap)

            box_lo = jnp.full((n_dev, cap), INVALID_SENTINEL, dtype=jnp.uint32)
            # Out-of-box entries get out-of-bounds targets and are dropped
            # by scatter mode='drop' (never write a bogus in-bounds slot).
            in_box = (bucket < n_dev) & (offset < cap)
            tgt_b = jnp.where(in_box, bucket, n_dev)
            tgt_o = jnp.where(in_box, offset, cap)
            box_lo = box_lo.at[tgt_b, tgt_o].set(lo, mode="drop")

            # Exchange: device d receives every device's box for bucket d.
            box_lo = jax.lax.all_to_all(box_lo, axis, 0, 0, tiled=True)
            lo = box_lo.reshape(-1)

            if small:
                lo = jax.lax.sort(lo)
            else:
                box_hi = jnp.full(
                    (n_dev, cap), INVALID_SENTINEL, dtype=jnp.uint32
                )
                box_hi = box_hi.at[tgt_b, tgt_o].set(hi, mode="drop")
                box_hi = jax.lax.all_to_all(box_hi, axis, 0, 0, tiled=True)
                hi = box_hi.reshape(-1)
                hi, lo = jax.lax.sort((hi, lo), num_keys=2)
            overflowed = jax.lax.pmax(overflowed.astype(jnp.int32), axis) > 0
        else:
            overflowed = jnp.zeros((), dtype=bool)

        if small:
            from ..ops.perread_sparse import rle_rows

            ulo, counts = rle_rows(
                (lo[None, :],),
                (lo != INVALID_SENTINEL)[None, :],
                (INVALID_SENTINEL,),
            )
            ulo, counts = ulo[0], counts[0]
            uhi = jnp.where(counts > 0, jnp.uint32(0), INVALID_SENTINEL)
        else:
            uhi, ulo, counts = _rle(hi, lo)
        return uhi, ulo, counts, overflowed[None]

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=P(axis, None),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
        )
    )


@lru_cache(maxsize=None)
def _flat_mesh(mesh: Mesh) -> Mesh:
    """Bucket routing uses exactly ONE mesh axis.  A multi-axis mesh
    (e.g. the CLI's (dp, tp) spectrum mesh rerouted here for mid k)
    would shard rows over axis 0 only and REPLICATE the whole exchange
    over the other axes — correct results, half the chips doing
    duplicate work.  Flatten every device onto one axis instead."""
    if len(mesh.axis_names) == 1:
        return mesh
    import numpy as np

    return Mesh(
        np.asarray(mesh.devices).reshape(-1), (mesh.axis_names[0],)
    )


def sparse_spectrum_sharded(
    codes: jax.Array,
    k: int,
    mesh: Mesh,
    *,
    canonical: bool = False,
    slack: float = 2.0,
):
    """Global sparse spectrum via all_to_all bucket routing.

    codes: [B, L] int8, B divisible by the mesh size.  A multi-axis
    mesh is flattened so ALL devices route buckets.  Returns
    (hi, lo, counts, overflowed): the first three sharded over the mesh
    axis (concatenated = globally sorted unique k-mers with counts),
    ``overflowed`` a per-device bool (True = bucket box overflow, counts
    incomplete — retry with higher slack, or use
    :func:`sparse_spectrum_sharded_retry` which does it for you).
    """
    mesh = _flat_mesh(mesh)
    return _sparse_sharded_fn(mesh, k, canonical, slack)(codes)


def sparse_spectrum_sharded_retry(
    codes: jax.Array,
    k: int,
    mesh: Mesh,
    *,
    canonical: bool = False,
    slack: float = 2.0,
):
    """:func:`sparse_spectrum_sharded` with automatic overflow recovery.

    Doubles the bucket-box slack and re-runs whenever any device reports
    overflow (skewed k-mer distributions, e.g. low-complexity genomes).
    Terminates: at slack >= n_devices every box can hold a device's
    whole key stream, so overflow is impossible.  Returns
    (hi, lo, counts, slack_used) — callers carry ``slack_used`` forward
    so later batches of the same stream start at the working capacity
    instead of re-discovering it (each slack value compiles once).
    """
    import numpy as np

    mesh = _flat_mesh(mesh)
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    s = slack
    while True:
        hi, lo, counts, overflowed = sparse_spectrum_sharded(
            codes, k, mesh, canonical=canonical, slack=s
        )
        if s >= n_dev or not bool(np.any(np.asarray(overflowed))):
            return hi, lo, counts, s
        s = min(s * 2.0, float(n_dev))
