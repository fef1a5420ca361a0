"""Test configuration: the CPU with a virtual 8-device mesh, or the card.

A plain run (``python -m pytest tests/``) holds JAX to the CPU backend
with 8 virtual devices, which validates every sharded path without
cards.  Tests that need a GPU carry the ``gpu`` marker and skip there.
On a machine with a card,

    python -m pytest tests/ -m gpu

selects exactly those tests and leaves JAX on its default platform.
Whether a card is present is decided inside the ``gpu_device`` fixture,
never at import, so every xdist worker collects the same tests.
"""

import os

import numpy as np
import pytest


def pytest_configure(config):
    if config.getoption("markexpr", "") != "gpu":
        _hold_to_cpu()
    _ensure_native_extension()


def _hold_to_cpu() -> None:
    # Before any backend exists: the platform and device count are read
    # when JAX first initialises its backends.
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    # Test workers compile concurrently; no persistent cache between them.
    jax.config.update("jax_enable_compilation_cache", False)


def _ensure_native_extension() -> None:
    """Build the C extension in place if it is missing (fresh checkout:
    the .so is gitignored).  Best-effort — tests that REQUIRE the
    extension still assert HAVE_NATIVE, so a broken toolchain fails
    loudly there rather than silently testing only the fallback."""
    import subprocess

    try:
        from cfrk_tpu.io.native import HAVE_NATIVE

        if HAVE_NATIVE:
            return
    except ImportError:
        return
    from cfrk_tpu.io.build_native import build_extension

    try:
        build_extension(timeout=300)
    except (OSError, subprocess.SubprocessError):
        return
    # Re-import with the freshly built .so.  A plain reload is NOT
    # enough: the failed first import left `_fastaio = None` as a
    # package attribute, and `from . import _fastaio` resolves that
    # stale attribute instead of importing the new extension.  Drop the
    # cached modules (every consumer imports the package lazily, so the
    # fresh module object takes effect everywhere) and invalidate the
    # FileFinder caches that would otherwise hide the just-written .so.
    import importlib
    import sys as _sys

    for name in ("cfrk_tpu.io.native._fastaio", "cfrk_tpu.io.native"):
        _sys.modules.pop(name, None)
    importlib.invalidate_caches()
    importlib.import_module("cfrk_tpu.io.native")


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU, or a skip: tests marked ``gpu`` run on the card."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_ragged_reads(rng, n, max_len=300, p_invalid=0.02, min_len=1):
    """Random encoded reads with sprinkled invalid symbols."""
    reads = []
    for _ in range(n):
        ln = int(rng.integers(min_len, max_len + 1))
        r = rng.integers(0, 4, size=ln).astype(np.int8)
        mask = rng.random(ln) < p_invalid
        r[mask] = -1
        reads.append(r)
    return reads
