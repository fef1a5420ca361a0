"""Window extraction: padded code batches → k-mer index components (JAX).

Replaces the reference's ``ComputeIndex`` kernel (``src/kmer_kernel.cu:21-49``),
which ran one CUDA thread per symbol with a k-long ``powf`` loop.  Here the
same computation is k static shifted slices combined with shift/mask integer
arithmetic — fully vectorised and fused by XLA.

The key representation choice: a k-mer index is carried as a ``(hi, lo)``
pair of int32s, ``hi`` = the first ``ceil(k/2)`` bases, ``lo`` = the rest.

* it keeps every component under 2*15 = 30 bits, so k up to 31 never needs
  64-bit integers (JAX's x64 mode stays off);
* the one-hot cross-check routes contract one-hot(hi) × one-hot(lo) as a
  batched OUTER-PRODUCT matmul (see perread.py);
* large-k bucket routing shards tables by ``hi`` bits (see parallel/).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "split_k",
    "WindowComponents",
    "window_components",
    "window_indices",
    "canonical_components",
]


def split_k(k: int) -> tuple[int, int]:
    """Split k into (kh, kl) with kh = ceil(k/2): index = hi * 4**kl + lo."""
    kh = (k + 1) // 2
    return kh, k - kh


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WindowComponents:
    """Per-window k-mer index components for a padded batch.

    hi:    [..., W] int32 in [0, 4**kh)  — first ceil(k/2) bases.
    lo:    [..., W] int32 in [0, 4**kl)  — remaining bases (0 when kl == 0).
    rc_hi: [..., W] int32 — same split of the reverse-complement index.
    rc_lo: [..., W] int32
    valid: [..., W] bool  — all k codes in 0..3 (excludes N/pad windows).
    """

    hi: jax.Array
    lo: jax.Array
    rc_hi: jax.Array
    rc_lo: jax.Array
    valid: jax.Array


@partial(jax.jit, static_argnums=(1,), inline=True)
def window_components(codes: jax.Array, k: int) -> WindowComponents:
    """Compute all window index components of a padded code batch.

    codes: [..., L] int8 (0..3 valid, -1 invalid/pad).  Windows start at
    every position p in [0, L-k]; validity is purely local (pad = -1
    poisons overlapping windows), matching reference separator semantics.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    if k > 15:
        # kh = ceil(k/2) > 15 would overflow the int32 Horner below; the
        # uint32 (hi, lo) split for k up to 31 lives in ops/sparse.py
        # (kmer_keys), which splits at 15 bases instead of k/2.
        raise ValueError("window_components supports k <= 15; use "
                         "ops.sparse.kmer_keys for k up to 31")
    length = codes.shape[-1]
    w = length - k + 1
    if w <= 0:
        raise ValueError(f"read length {length} < k={k}")
    kh, kl = split_k(k)

    c = codes.astype(jnp.int32)
    # k static shifted views of the same buffer; XLA fuses these slices.
    views = [jax.lax.slice_in_dim(c, i, i + w, axis=-1) for i in range(k)]

    valid = views[0] >= 0
    for v in views[1:]:
        valid &= v >= 0

    def horner(vs):
        acc = jnp.zeros_like(vs[0])
        for v in vs:
            acc = (acc << 2) | jnp.maximum(v, 0)
        return acc

    hi = horner(views[:kh])
    lo = horner(views[kh:]) if kl else jnp.zeros_like(hi)
    # Reverse complement: base i of rc is 3 - base[k-1-i].
    rviews = [3 - jnp.maximum(v, 0) for v in reversed(views)]
    rc_hi = horner(rviews[:kh])
    rc_lo = horner(rviews[kh:]) if kl else jnp.zeros_like(rc_hi)
    return WindowComponents(hi=hi, lo=lo, rc_hi=rc_hi, rc_lo=rc_lo, valid=valid)


@partial(jax.jit, static_argnums=(1,), inline=True)
def canonical_components(codes: jax.Array, k: int):
    """(hi, lo, valid) of CANONICAL window indices (k <= 8).

    min(fwd, revcomp) breaks the independent hi/lo split, so the
    canonical full index is computed and re-split — shared by the
    per-read and spectrum matmul paths.
    """
    kh, kl = split_k(k)
    fl = 4**kl
    idx = window_indices(codes, k, canonical=True)
    valid = idx >= 0
    idxc = jnp.maximum(idx, 0)
    return idxc >> (2 * kl), idxc & (fl - 1), valid


@partial(jax.jit, static_argnums=(1, 2), inline=True)
def window_indices(codes: jax.Array, k: int, canonical: bool = False) -> jax.Array:
    """Full int32 window indices (k <= 15), -1 for invalid windows.

    canonical=True returns min(index, revcomp(index)) — strand-neutral.
    """
    if k > 15:
        raise ValueError("full indices need k <= 15 in int32; use components")
    kh, kl = split_k(k)
    wc = window_components(codes, k)
    idx = (wc.hi << (2 * kl)) | wc.lo
    if canonical:
        rc = (wc.rc_hi << (2 * kl)) | wc.rc_lo
        idx = jnp.minimum(idx, rc)
    return jnp.where(wc.valid, idx, -1)
