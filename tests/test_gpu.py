"""The device routes compiled for the card, against the reference.

Marked ``gpu``: they skip on the CPU and run on a machine with an NVIDIA
GPU with

    python -m pytest tests/ -m gpu
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("k,canonical", [(8, False), (15, True), (31, True)])
def test_rows_route_on_gpu(gpu_device, k, canonical):
    import jax.numpy as jnp

    import chip_smoke as cs
    from cfrk_tpu.ops.perread_sparse import count_perread_rows

    codes = cs._codes(np.random.default_rng(k), 512, 256, 150)
    x = jnp.asarray(codes)
    assert x.devices() == {gpu_device}
    cs.check_rows(count_perread_rows(x, k, canonical),
                  cs.reference_indices(codes, k, canonical), k)


@pytest.mark.parametrize("k,impl", [(3, "auto"), (8, "auto"), (6, "matmul")])
def test_dense_perread_on_gpu(gpu_device, k, impl):
    import chip_smoke as cs
    from cfrk_tpu.ops.perread import count_perread
    from cfrk_tpu.ops.reference import count_perread_np

    codes = cs._codes(np.random.default_rng(k), 256, 150, 150)
    got = np.asarray(count_perread(codes, k, impl=impl))
    np.testing.assert_array_equal(got, count_perread_np(list(codes), k))


@pytest.mark.parametrize("k", [6, 10])
def test_spectrum_on_gpu(gpu_device, k):
    import chip_smoke as cs
    from cfrk_tpu.ops.spectrum import spectrum

    codes = cs._codes(np.random.default_rng(k), 256, 150, 150)
    cs.check_spectrum(spectrum(codes, k), cs.reference_indices(codes, k, False), k)


def test_cli_stream_golden_on_gpu(gpu_device, tmp_path):
    """The reference's own command line at k=2, streamed on the card,
    reproduces the golden bytes."""
    from cfrk_tpu.cli import main

    data = REPO / "tests" / "data"
    manifest = json.loads((data / "goldens.json").read_text())
    for name, meta in sorted(manifest["files"].items()):
        out = tmp_path / (name + ".cfrk")
        assert main([str(data / name), str(out), str(manifest["k"]),
                     "--stream", "--devices", "1"]) == 0
        assert hashlib.sha256(out.read_bytes()).hexdigest() == meta["sha256"]
