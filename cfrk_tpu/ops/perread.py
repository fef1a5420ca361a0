"""Per-read dense k-mer histograms (XLA path).

Replaces the reference's ``ComputeFreqNew`` kernel (``src/kmer_kernel.cu:73-90``),
which used one CUDA block per read and ``atomicAdd`` into that read's row.
The default route is the same design through XLA: ``.at[].add`` into a
``[B, 4**k]`` table, which the GPU backend lowers to atomic adds.  For
k <= 3 (4**k <= 64 bins) a compare-and-sum is used instead, and a
one-hot contraction

    counts[b, hi, lo] = Σ_w one_hot(hi[b, w]) ⊗ one_hot(lo[b, w])

is kept as an explicit ``impl='matmul'`` cross-check.  Its float32
accumulation is exact: one-hot operands are 0/1 (exact in TF32 too) and
every bin stays below 2**24 — larger window counts reroute to scatter.

The reference could only express per-read dense counting; for k where
4**k * batch exceeds memory it aborted (``src/kmer_main.cu:51-56``).  Here
k <= 8 is supported per-read (65,536 bins); larger k belongs to the
spectrum / sparse paths (see ops/spectrum.py, ops/perread_sparse.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .encode import (
    canonical_components,
    split_k,
    window_components,
    window_indices,
)

__all__ = ["count_perread", "resolve_perread_impl", "MAX_PERREAD_K"]

MAX_PERREAD_K = 8


@partial(jax.jit, static_argnums=(1, 2), inline=True)
def _count_compare(codes: jax.Array, k: int, canonical: bool) -> jax.Array:
    """Compare path for tiny k: counts[b, v] = Σ_w (idx[b, w] == v)."""
    idx = window_indices(codes, k, canonical)  # [B, W], -1 invalid
    bins = jnp.arange(4**k, dtype=jnp.int32)
    eq = idx[..., None] == bins  # [B, W, 4^k] — 4^k <= 64, cheap
    return jnp.sum(eq, axis=-2, dtype=jnp.int32)


@partial(jax.jit, static_argnums=(1, 2), inline=True)
def _count_scatter(codes: jax.Array, k: int, canonical: bool) -> jax.Array:
    """Scatter-add path (atomic adds on the GPU), exact everywhere.
    Invalid windows redirect to column 4**k and are dropped."""
    idx = window_indices(codes, k, canonical)  # [B, W], -1 invalid
    b, w = idx.shape
    flat = jnp.where(idx < 0, 4**k, idx)
    rows = jnp.broadcast_to(jnp.arange(b, dtype=jnp.int32)[:, None], (b, w))
    counts = jnp.zeros((b, 4**k), dtype=jnp.int32)
    return counts.at[rows, flat].add(1, mode="drop")


@partial(jax.jit, static_argnums=(1, 2), inline=True)
def _count_matmul(codes: jax.Array, k: int, canonical: bool) -> jax.Array:
    """Batched one-hot outer-product matmul over windows."""
    kh, kl = split_k(k)
    fh, fl = 4**kh, 4**kl
    if canonical:
        hi, lo, valid = canonical_components(codes, k)
    else:
        wc = window_components(codes, k)
        hi, lo, valid = wc.hi, wc.lo, wc.valid
    oh_hi = jax.nn.one_hot(hi, fh, dtype=jnp.float32)
    oh_hi = oh_hi * valid[..., None].astype(jnp.float32)
    oh_lo = jax.nn.one_hot(lo, fl, dtype=jnp.float32)
    counts = jnp.einsum(
        "bwh,bwl->bhl", oh_hi, oh_lo, preferred_element_type=jnp.float32
    )
    b = codes.shape[0]
    return counts.reshape(b, fh * fl).astype(jnp.int32)


def resolve_perread_impl(k: int, w: int, impl: str = "auto") -> str:
    """The device route for a dense per-read batch of ``w`` windows/read.

    Depends on k and the row width only: ``compare`` for 4**k <= 64,
    ``scatter`` above.  An explicit ``matmul`` whose float32 bins could
    pass 2**24 reroutes to the int32 scatter.
    """
    if impl == "auto":
        return "compare" if 4**k <= 64 else "scatter"
    if impl == "matmul" and w >= 2**24:
        return "scatter"
    return impl


def count_perread(
    codes: jax.Array,
    k: int,
    *,
    canonical: bool = False,
    impl: str = "auto",
    out_dtype=None,
) -> jax.Array:
    """Dense per-read histograms: codes [B, L] int8 → counts [B, 4**k].

    impl: 'auto' | 'compare' | 'scatter' | 'matmul' | 'host' (the NumPy
    oracle; traced callers get 'scatter' instead).
    out_dtype: int32 (default) or int16 — int16 halves the output bytes
        and is safe when windows/read < 2**15 (counts are bounded by the
        window count).
    """
    out_dtype = jnp.dtype(out_dtype) if out_dtype is not None else jnp.int32
    w = codes.shape[-1] - k + 1
    if out_dtype == jnp.int16 and w >= 2**15:
        raise ValueError("int16 counts unsafe for >= 2**15 windows/read")
    if k > MAX_PERREAD_K:
        raise ValueError(
            f"per-read dense counting supports k <= {MAX_PERREAD_K} "
            f"(4**{k} bins/read); use spectrum or bucketed modes"
        )
    if codes.ndim != 2:
        raise ValueError(f"codes must be [B, L], got {codes.shape}")
    impl = resolve_perread_impl(k, w, impl)
    if impl == "host" and isinstance(codes, jax.core.Tracer):
        # 'host' cannot run under a trace (sharded/seqpar paths jit
        # their dispatch); the traceable scatter computes the same.
        impl = "scatter"
    if impl == "compare":
        return _count_compare(codes, k, canonical).astype(out_dtype)
    if impl == "scatter":
        return _count_scatter(codes, k, canonical).astype(out_dtype)
    if impl == "matmul":
        return _count_matmul(codes, k, canonical).astype(out_dtype)
    if impl == "host":
        import numpy as np

        # Sort composite (read, bin) keys and length-encode the runs —
        # O(B·W log B·W) on the windows, never on the B·4**k bins.
        idx = np.asarray(window_indices(codes, k, canonical))
        b, w = idx.shape
        rows = np.broadcast_to(np.arange(b, dtype=np.int64)[:, None], (b, w))
        valid = idx >= 0
        comp = rows[valid] * (4**k) + idx[valid]
        comp.sort(kind="stable")
        starts = np.r_[0, np.flatnonzero(comp[1:] != comp[:-1]) + 1]
        runs = np.diff(np.r_[starts, len(comp)])
        counts = np.zeros((b, 4**k), dtype=out_dtype)
        if len(comp):
            counts.reshape(-1)[comp[starts]] = runs.astype(out_dtype)
        return jnp.asarray(counts)
    raise ValueError(f"unknown impl {impl!r}")
