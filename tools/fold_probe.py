"""Device-side pair→table fold candidates for the sorted spectrum route.

The sorted spectrum route ships its RLE pairs to a host fold every
batch; the candidate device folds measured here would keep the 4^k table
device-resident (the analog of the reference's device-memory accumulate,
``src/kmer_kernel.cu:87``).  Variants (all: rowsort pairs → 4^k table):

    scatter   zeros(4^k).at[idx].add(cnt)    (XLA scatter-add)
    segsum    jax.ops.segment_sum            (same lowering, recorded)
    onehot    split hi/lo one-hot outer product on the pairs
              (the one-hot contraction fold, fed by pairs)
    sortfold  global lax.sort of the flat pairs + RLE + 1-unique scatter
    none      row sort alone (the device-side floor the fold adds to)

plus `kernel` = the auto dense-spectrum route straight from the reads
(zero D2H, the route the fold must beat).  Every step consumes a
one-scalar checksum.

    python tools/fold_probe.py --variant scatter --steps 32
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--len", dest="read_len", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument(
        "--variant", default="scatter",
        choices=["scatter", "segsum", "onehot", "sortfold", "none",
                 "kernel"],
    )
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from cfrk_tpu.ops.encode import split_k
    from cfrk_tpu.ops.perread_sparse import count_perread_rows

    k, L, B = args.k, args.read_len, args.batch
    four_k = 4**k
    sent = four_k

    def fold_scatter(idx, cnt):
        t = jnp.zeros(four_k + 1, jnp.int32)  # +1 absorbs the sentinel
        return t.at[idx.ravel()].add(cnt.ravel())[:four_k]

    def fold_segsum(idx, cnt):
        return jax.ops.segment_sum(
            cnt.ravel(), idx.ravel(), num_segments=four_k + 1
        )[:four_k]

    def fold_onehot(idx, cnt):
        kh, kl = split_k(k)
        fh, fl = 4**kh, 4**kl
        flat_i = idx.ravel()
        flat_c = cnt.ravel().astype(jnp.bfloat16)
        hi = (flat_i // fl).astype(jnp.int32)
        lo = (flat_i % fl).astype(jnp.int32)
        oh_hi = (
            hi[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, fh), 1)
        ).astype(jnp.bfloat16) * flat_c[:, None]
        oh_lo = (
            lo[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, fl), 1)
        ).astype(jnp.bfloat16)
        t = jax.lax.dot_general(
            oh_hi, oh_lo, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return t.reshape(-1).astype(jnp.int32)

    def fold_sortfold(idx, cnt):
        # Global sort + RLE: per-run totals via cumsum differences, then
        # two scatters whose LIVE indices are unique (<= 4^k runs); the
        # dead lanes park on the sentinel slot with a 0 contribution.
        flat_i = idx.ravel()
        flat_c = cnt.ravel()
        si, sc = jax.lax.sort((flat_i, flat_c), dimension=0, num_keys=1)
        csum = jnp.cumsum(sc)
        first = jnp.concatenate([jnp.ones(1, bool), si[1:] != si[:-1]])
        last = jnp.concatenate([first[1:], jnp.ones(1, bool)])
        before = jnp.concatenate([jnp.zeros(1, csum.dtype), csum[:-1]])
        t = jnp.zeros(four_k + 1, jnp.int32)
        t = t.at[jnp.where(last, si, sent)].add(jnp.where(last, csum, 0))
        t = t.at[jnp.where(first, si, sent)].add(
            jnp.where(first, -before, 0)
        )
        return t[:four_k]

    folds = {
        "scatter": fold_scatter,
        "segsum": fold_segsum,
        "onehot": fold_onehot,
        "sortfold": fold_sortfold,
    }

    if args.variant == "kernel":
        from cfrk_tpu.ops.spectrum import spectrum as _sp

        def step(codes):
            return jnp.sum(_sp(codes, k) & 3)
    elif args.variant == "none":

        def step(codes):
            i, c = count_perread_rows(codes, k)
            return jnp.sum(c & 3, dtype=jnp.int32)
    else:
        fold = folds[args.variant]

        def step(codes):
            i, c = count_perread_rows(codes, k)
            t = fold(i, c)
            return jnp.sum(t & 3, dtype=jnp.int32)

    rng = np.random.default_rng(0)
    xs = jnp.asarray(
        rng.integers(0, 4, size=(4, B, L)).astype(np.int8)
    )
    sj = jax.jit(step)
    _ = int(np.asarray(sj(xs[0])))

    def run(xs):
        def body(cacc, i):
            return cacc + sj(xs[i % 4]), ()

        cacc, _ = jax.lax.scan(body, jnp.int32(0), jnp.arange(args.steps))
        return cacc

    fn = jax.jit(run)
    _ = int(np.asarray(fn(xs)))
    best = float("inf")
    for _r in range(3):
        t0 = time.perf_counter()
        chk = int(np.asarray(fn(xs)))
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({
        "variant": args.variant, "k": k,
        "steps": args.steps,
        "step_ms": round(best / args.steps * 1e3, 3),
        "mbases_per_s": round(B * L * args.steps / best / 1e6, 1),
        "chk": chk,
    }))


if __name__ == "__main__":
    main()
