"""Sequence parallelism over very long reads (contigs).

The reference hard-capped read length at blockDim.x = 1024 bases — positions
beyond that were silently dropped (reference ``src/kmer_kernel.cu:83-85``).
The answer here for long sequences is to shard the POSITION axis over
the mesh: each device holds a contiguous slice of every read, computes the
windows that *start* inside its slice, and the per-read histograms are
summed with ``psum``.

Windows that straddle a slice boundary need the first ``k-1`` codes of the
right neighbour's slice — a halo exchange done with one ``ppermute`` along
the ring (k-1 ≤ 30 bytes per read: negligible traffic).  The last device
receives a halo of ``-1`` padding, which poisons the windows that would run
off the end of the read — exactly the validity semantics of the local path.

This is the k-mer analog of blockwise/ring scanning over the sequence axis
in long-context attention.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.perread import count_perread
from ..ops.spectrum import spectrum

__all__ = [
    "make_seq_mesh",
    "SP_AXIS",
    "count_perread_seqpar",
    "spectrum_seqpar",
    "spectrum_seqpar_triples",
]

SP_AXIS = "sp"


def make_seq_mesh(devices=None) -> Mesh:
    """1-D mesh over the sequence (position) axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (SP_AXIS,))


def _check_slice_width(codes: jax.Array, k: int, mesh: Mesh) -> None:
    """The one-hop halo fetches k-1 columns from the immediate right
    neighbour only; a per-device slice narrower than k-1 would silently
    drop windows spanning two slice boundaries.  Refuse loudly."""
    n = mesh.shape[SP_AXIS]
    length = codes.shape[-1]
    if length % n:
        raise ValueError(f"position axis {length} not divisible by sp={n}")
    if n > 1 and length // n < k - 1:
        raise ValueError(
            f"per-device slice {length // n} < k-1={k - 1}: windows would "
            f"span >2 slices; use fewer devices or longer reads"
        )


def _halo_extend(codes_blk: jax.Array, k: int) -> jax.Array:
    """Append the right neighbour's first k-1 columns (ring ppermute).

    The wrap-around halo the last device receives from device 0 is replaced by
    -1 padding so end-of-read windows stay invalid.
    """
    n = jax.lax.axis_size(SP_AXIS)
    i = jax.lax.axis_index(SP_AXIS)
    halo = codes_blk[:, : k - 1]
    # send my leading columns to my LEFT neighbour: perm maps src -> dst.
    halo = jax.lax.ppermute(halo, SP_AXIS, [(j, (j - 1) % n) for j in range(n)])
    halo = jnp.where(i == n - 1, jnp.full_like(halo, -1), halo)
    return jnp.concatenate([codes_blk, halo], axis=-1)


@lru_cache(maxsize=None)
def _seqpar_fn(mesh: Mesh, k: int, canonical: bool, impl: str, mode: str):
    """Cached jit wrapper per (mesh, config) — streaming calls reuse it."""
    op = count_perread if mode == "perread" else spectrum

    def local(codes_blk):
        ext = _halo_extend(codes_blk, k) if k > 1 else codes_blk
        part = op(ext, k, canonical=canonical, impl=impl)
        return jax.lax.psum(part, SP_AXIS)

    return jax.jit(
        shard_map(
            local, mesh=mesh, in_specs=P(None, SP_AXIS), out_specs=P(),
        )
    )


def count_perread_seqpar(
    codes: jax.Array,
    k: int,
    mesh: Mesh,
    *,
    canonical: bool = False,
    impl: str = "auto",
) -> jax.Array:
    """Per-read counts with the position axis sharded over ``sp``.

    codes: [B, L] int8, L divisible by the sp size.  Returns [B, 4**k]
    int32, replicated (each device ends with the full per-read histograms).
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    _check_slice_width(codes, k, mesh)
    return _seqpar_fn(mesh, k, canonical, impl, "perread")(codes)


def spectrum_seqpar(
    codes: jax.Array,
    k: int,
    mesh: Mesh,
    *,
    canonical: bool = False,
    impl: str = "auto",
) -> jax.Array:
    """Global spectrum with the position axis sharded over ``sp``."""
    _check_slice_width(codes, k, mesh)
    return _seqpar_fn(mesh, k, canonical, impl, "spectrum")(codes)


@lru_cache(maxsize=None)
def _seqpar_triples_fn(mesh: Mesh, k: int, canonical: bool):
    from ..ops.perread_sparse import count_perread_rows

    def local(codes_blk):
        # Same halo discipline as the dense path: windows starting in
        # this slice may extend k-1 columns into the right neighbour.
        ext = _halo_extend(codes_blk, k) if k > 1 else codes_blk
        # Each device sorts + RLEs ITS OWN slice's windows; no
        # collective merge — the host accumulator sums duplicate
        # keys across slices exactly like across batches.
        return count_perread_rows(ext, k, canonical)

    n_out = 2 if k <= 15 else 3
    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=P(None, SP_AXIS),
            out_specs=(P(None, SP_AXIS),) * n_out,
        )
    )


def spectrum_seqpar_triples(
    codes: jax.Array,
    k: int,
    mesh: Mesh,
    *,
    canonical: bool = False,
):
    """Sorted-route spectrum with the position axis sharded over ``sp``.

    Routes position-sharded long contigs through per-slice sort+RLE
    (the sorted-spectrum route) instead of a dense scatter table.  Returns the
    per-read-rows layout of ops/perread_sparse ((idx, counts) for
    k <= 15, (hi, lo, counts) above), shape [B, n_slices * W_slice],
    windows concatenated slice-major — feed
    ``ops.sparse.rows_to_triples`` / the SparseAccumulator, which merge
    duplicate keys across slices exactly like across batches.
    """
    _check_slice_width(codes, k, mesh)
    return _seqpar_triples_fn(mesh, k, canonical)(codes)
