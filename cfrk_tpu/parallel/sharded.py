"""Sharded (multi-device) counting: shard_map over a (dp, tp) mesh.

Replaces — and goes beyond — the reference's Swift/K file-shard scale-out
(reference ``swift/cfrk.swf:14-20``), which never exchanged data between
processes:

* ``count_perread_sharded`` — per-read mode.  Reads are sharded over
  ``dp``; each device counts its rows independently.  Zero collectives,
  exactly the reference's communication pattern, but inside one SPMD
  program so several cards look like one device to the driver.
* ``spectrum_sharded`` — global-spectrum mode (new capability).  Each
  device computes a local dense table; tables are summed with ``psum``
  over ``dp``.  With tp > 1 the summed table is ``psum_scatter``-ed over
  ``tp`` so each device keeps only 4**k / tp bins — the result lives
  sharded (bins over tp), avoiding 4**k replication at large k.

Both are ordinary jitted functions of sharded arrays: XLA inserts the
collectives (NCCL over NVLink on a multi-GPU host), overlapping them
with compute where possible.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.perread import count_perread
from ..ops.spectrum import spectrum
from .mesh import DP_AXIS, TP_AXIS, batch_sharding

__all__ = [
    "count_perread_sharded",
    "count_perread_sparse_sharded",
    "spectrum_sharded",
    "shard_batch",
]


def shard_batch(codes, mesh: Mesh):
    """Place a host [B, L] batch onto the mesh, rows sharded over dp.

    B must be divisible by the dp size (pad with -1 rows upstream —
    padding rows produce all-zero counts and are sliced off by callers).
    """
    return jax.device_put(codes, batch_sharding(mesh))


@lru_cache(maxsize=None)
def _perread_sharded_fn(mesh: Mesh, k: int, canonical: bool, impl: str):
    """One cached jit wrapper per (mesh, config): repeated streaming calls
    reuse the traced/compiled executable instead of re-jitting.  Each
    device counts its own row block — the zero-collective dp semantics
    this op promises."""

    def local(codes_blk):
        return count_perread(codes_blk, k, canonical=canonical, impl=impl)

    spec = P((DP_AXIS, TP_AXIS), None)
    return jax.jit(
        shard_map(
            local, mesh=mesh, in_specs=spec, out_specs=spec,
        )
    )


def count_perread_sharded(
    codes: jax.Array,
    k: int,
    mesh: Mesh,
    *,
    canonical: bool = False,
    impl: str = "auto",
) -> jax.Array:
    """Per-read dense counts with rows sharded over the dp axis.

    codes: [B, L] int8 (device-put with ``shard_batch`` or host array).
    Returns [B, 4**k] int32 sharded the same way.  Data-parallel per-read
    counting requires no cross-device communication at all.
    """
    return _perread_sharded_fn(mesh, k, canonical, impl)(codes)


@lru_cache(maxsize=None)
def _perread_sparse_sharded_fn(mesh: Mesh, k: int, canonical: bool):
    """Sparse per-read rows (sort + RLE per row, ops/perread_sparse)
    with rows sharded over the mesh — per-row work needs no collectives,
    exactly like the dense per-read op."""
    from ..ops.perread_sparse import count_perread_rows

    def local(codes_blk):
        return count_perread_rows(codes_blk, k, canonical)

    spec = P((DP_AXIS, TP_AXIS), None)
    n_out = 2 if k <= 15 else 3
    return jax.jit(
        shard_map(
            local, mesh=mesh, in_specs=spec, out_specs=(spec,) * n_out,
        )
    )


def count_perread_sparse_sharded(
    codes: jax.Array,
    k: int,
    mesh: Mesh,
    *,
    canonical: bool = False,
):
    """Per-read SPARSE rows (8 < k <= 31) with rows sharded over the mesh.

    codes: [B, L] int8, B divisible by the mesh size.  Returns the same
    row-sorted RLE layout as ``ops.perread_sparse``: an (idx, counts)
    pair for k <= 15 or an (hi, lo, counts) triple for k <= 31, each
    [B, W] and sharded rows-over-devices.  Zero collectives — the row
    sorts run inside each device's block.
    """
    return _perread_sparse_sharded_fn(mesh, k, canonical)(codes)


@lru_cache(maxsize=None)
def _spectrum_sharded_fn(mesh: Mesh, k: int, canonical: bool, impl: str):
    tp = mesh.shape[TP_AXIS]
    four_k = 4**k
    if four_k % tp:
        raise ValueError(f"4**{k} bins not divisible by tp={tp}")

    def local(codes_blk):
        # Every device holds a distinct row slice (rows sharded over
        # dp AND tp) and computes a full local table from it.
        tbl = spectrum(codes_blk, k, canonical=canonical, impl=impl)
        if tp > 1:
            tbl = jax.lax.psum(tbl, DP_AXIS)
            # Sum the tp partials while scattering bins over tp: each
            # device keeps 4**k / tp bins of the global table.
            tbl = jax.lax.psum_scatter(tbl, TP_AXIS, scatter_dimension=0, tiled=True)
        else:
            # psum over both axes so the replication over the (size-1)
            # tp axis is statically known to shard_map's checker.
            tbl = jax.lax.psum(tbl, (DP_AXIS, TP_AXIS))
        return tbl

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=P((DP_AXIS, TP_AXIS), None),
            out_specs=P(TP_AXIS) if tp > 1 else P(),
        )
    )


def spectrum_sharded(
    codes: jax.Array,
    k: int,
    mesh: Mesh,
    *,
    canonical: bool = False,
    impl: str = "auto",
) -> jax.Array:
    """Global spectrum over all reads on a (dp, tp) mesh.

    Returns the [4**k] int32 table sharded bins-over-tp (replicated over
    dp).  Local per-device dense tables are merged with ``psum`` over dp and
    ``psum_scatter`` over tp.
    """
    return _spectrum_sharded_fn(mesh, k, canonical, impl)(codes)
