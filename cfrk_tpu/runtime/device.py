"""The card a measurement runs on, and device timing.

Shared by ``bench.py`` and ``chip_smoke.py``: both refuse to run
anywhere but on an NVIDIA GPU, name the card and its power limit beside
every number, and time jitted device work the same way.
"""

from __future__ import annotations

import statistics
import subprocess
import time

__all__ = ["require_gpu", "card_identity", "compile_and_time"]


def require_gpu():
    """The visible GPU devices; raises ``RuntimeError`` on any other
    platform (a measurement never falls back to the CPU)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU, but JAX found {len(devs)} "
            f"{devs[0].platform} device(s) ({devs[0].device_kind})"
        )
    return devs


def card_identity() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    as the tool prints it (one line per card), or why it could not run.
    A card below its full power limit runs slower under load, so this
    line goes beside every number taken on it."""
    cmd = [
        "nvidia-smi", "--query-gpu=name,power.limit",
        "--format=csv,noheader",
    ]
    try:
        out = subprocess.run(
            cmd, capture_output=True, text=True, timeout=60, check=True
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out


def compile_and_time(fn, args_list, reps: int = 10):
    """Compile ``jax.jit(fn)`` for ``args_list[0]`` and time it.

    Returns ``(compiled, first_output, compile_s, median_ms)``: the
    compile time on the host clock, and the median of ``reps`` calls
    after one warm-up, each ended by ``block_until_ready``, cycling the
    distinct inputs of ``args_list`` so no call can reuse another's
    result.
    """
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args_list[0]).compile()
    compile_s = time.perf_counter() - t0
    first = jax.block_until_ready(compiled(*args_list[0]))
    times = []
    for r in range(reps):
        args = args_list[r % len(args_list)]
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return compiled, first, compile_s, statistics.median(times) * 1e3
