"""Global k-mer spectrum (one table over all reads).

The reference has no global-spectrum mode at all — its only aggregate is
per-read (SURVEY.md §5: no inter-process data exchange anywhere).  This is
new capability demanded by BASELINE.json configs 3-5.

Two dense implementations:

* ``matmul`` (auto for k <= 6): the one-hot outer-product contraction
  of perread.py, over reads AND windows — a single
  ``[4**kh, W_total] @ [W_total, 4**kl]`` matmul.
* ``scatter`` (auto for 7 <= k <= 15): XLA scatter-add into a flat
  ``4**k`` table (atomic adds on the GPU — the reference's
  ``ComputeFreqNew`` design, summed over reads).  Invalid windows are
  redirected to index 4**k and dropped by the out-of-bounds
  ``mode='drop'`` semantics, so there is no branch.

Device tables are int32 (per-batch counts are far below 2**31); the
streaming pipeline accumulates across batches into an int64 host table.
Sharded multi-chip spectra live in parallel/sharded.py (psum over the
mesh); k > 15 uses bucket routing (parallel/bucket.py).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from .encode import (
    canonical_components,
    split_k,
    window_components,
    window_indices,
)

__all__ = ["spectrum", "resolve_spectrum_impl", "MAX_DENSE_SPECTRUM_K"]

MAX_DENSE_SPECTRUM_K = 15

@partial(jax.jit, static_argnums=(1, 2), inline=True)
def _spectrum_scatter(codes: jax.Array, k: int, canonical: bool) -> jax.Array:
    idx = window_indices(codes, k, canonical)  # [..., W], -1 invalid
    four_k = 4**k
    flat = jnp.where(idx < 0, four_k, idx).reshape(-1)  # OOB → dropped
    table = jnp.zeros((four_k,), dtype=jnp.int32)
    return table.at[flat].add(1, mode="drop")


@partial(jax.jit, static_argnums=(1, 2), inline=True)
def _spectrum_matmul(codes: jax.Array, k: int, canonical: bool) -> jax.Array:
    kh, kl = split_k(k)
    fh, fl = 4**kh, 4**kl
    if canonical:
        hi, lo, valid = canonical_components(codes, k)
    else:
        wc = window_components(codes, k)
        hi, lo, valid = wc.hi, wc.lo, wc.valid
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    valid = valid.reshape(-1)
    oh_hi = jax.nn.one_hot(hi, fh, dtype=jnp.float32) * valid[:, None].astype(jnp.float32)
    oh_lo = jax.nn.one_hot(lo, fl, dtype=jnp.float32)
    table = jnp.einsum("wh,wl->hl", oh_hi, oh_lo, preferred_element_type=jnp.float32)
    return table.reshape(fh * fl).astype(jnp.int32)


def resolve_spectrum_impl(k: int, n_windows: int, impl: str = "auto") -> str:
    """The device route for a dense-spectrum batch of ``n_windows``
    windows: ``matmul`` for k <= 6, ``scatter`` above.  float32 one-hot
    bins are exact only below 2**24, so a matmul batch with that many
    windows reroutes to the int32 scatter."""
    if impl == "auto":
        impl = "matmul" if k <= 6 else "scatter"
    if impl == "matmul" and n_windows >= 2**24:
        return "scatter"
    return impl


def spectrum(
    codes: jax.Array,
    k: int,
    *,
    canonical: bool = False,
    impl: str = "auto",
) -> jax.Array:
    """Global dense spectrum: codes [..., L] int8 → counts [4**k] int32."""
    if impl == "sort":
        raise ValueError(
            "impl='sort' is a driver-level route (spectrum_file / "
            "stream_spectrum_file accumulate sparsely and densify once); "
            "spectrum() itself is dense per batch"
        )
    if k > MAX_DENSE_SPECTRUM_K:
        raise ValueError(
            f"dense spectrum supports k <= {MAX_DENSE_SPECTRUM_K}; "
            "use the bucketed sparse mode (parallel/bucket.py) for larger k"
        )
    n_windows = math.prod(codes.shape[:-1]) * max(codes.shape[-1] - k + 1, 0)
    impl = resolve_spectrum_impl(k, n_windows, impl)
    if impl == "scatter":
        return _spectrum_scatter(codes, k, canonical)
    if impl == "matmul":
        return _spectrum_matmul(codes, k, canonical)
    raise ValueError(f"unknown impl {impl!r}")
