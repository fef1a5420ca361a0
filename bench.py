"""Device benchmark of the production per-read rows route on one GPU.

Times ``ops.perread_sparse.count_perread_rows`` — the route every
``.cfrk`` output, the k=31 sparse mode and the sorted spectrum ride — at
the CLI's auto batch for 150 bp reads (32768 reads):

* k=8, 150 bp (BASELINE config 2): XLA's row sort + RLE into
  (idx, count) pairs;
* k=31 canonical, 152 bp (BASELINE config 4's per-batch core): the
  2-key (hi, lo) variant.

Each case compiles once, warms up, and reports the median ms per call
over distinct inputs, each call ended by ``block_until_ready``.  Prints
the card's name and power limit (``nvidia-smi``), then ONE JSON line.
Fails when JAX finds no GPU.

    python bench.py
"""

from __future__ import annotations

import json

import numpy as np

BATCH = 32768  # pipeline.batch.auto_batch_size(150)
CASES = ((8, 150, False), (31, 152, True))
DISTINCT = 4


def _case(k: int, read_len: int, canonical: bool) -> dict:
    import jax.numpy as jnp

    from cfrk_tpu.ops.perread_sparse import count_perread_rows
    from cfrk_tpu.runtime.device import compile_and_time

    rng = np.random.default_rng(k)
    xs = [
        (jnp.asarray(
            rng.integers(0, 4, size=(BATCH, read_len)).astype(np.int8)
        ),)
        for _ in range(DISTINCT)
    ]
    _, out, compile_s, ms = compile_and_time(
        lambda x: count_perread_rows(x, k, canonical), xs
    )
    assert int(np.asarray(out[-1]).sum()) == BATCH * (read_len - k + 1)
    return {
        "k": k,
        "read_len": read_len,
        "canonical": canonical,
        "reads": BATCH,
        "compile_s": compile_s,
        "ms_per_batch": ms,
        "bases_per_s": BATCH * read_len / (ms / 1e3),
    }


def main() -> None:
    from cfrk_tpu.runtime.compile_cache import setup_compile_cache
    from cfrk_tpu.runtime.device import card_identity, require_gpu

    setup_compile_cache()
    devs = require_gpu()
    card = card_identity()
    print(card, flush=True)
    k8, k31 = (_case(*c) for c in CASES)
    print(json.dumps({
        "metric": "per-read rows route throughput, 1 GPU",
        "value": k8["bases_per_s"],
        "unit": "bases/s",
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
        "card": card,
        "k8": k8,
        "k31": k31,
    }))


if __name__ == "__main__":
    main()
