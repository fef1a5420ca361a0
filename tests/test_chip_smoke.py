"""chip_smoke.py's phases on the CPU at tiny sizes, and its refusals.

On the card the script runs at full size (see its docstring); here the
same phase functions run on small shapes so that their control flow and
their checks are exercised without a GPU.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def _tiny(case):
    """A kernel case cut to CPU size: few rows, short rows, k <= 10 for
    the dense spectrum (a k=15 table is 4 GB)."""
    name, route, k, canonical, rows, length, valid_len = case
    if route == "spectrum":
        k = min(k, 10)
    return (name, route, k, canonical, min(rows, 6), min(length, 300),
            min(valid_len, 300))


@pytest.mark.parametrize("case", cs.KERNEL_CASES, ids=[c[0] for c in cs.KERNEL_CASES])
def test_phase_kernels_case(case):
    timings = cs.phase_kernels([_tiny(case)], reps=2)
    assert list(timings) == [case[0]] and timings[case[0]] > 0


def test_reference_indices_match_per_read_reference(rng):
    from cfrk_tpu.ops.reference import canonical_indices_np, window_indices_np

    codes = cs._codes(rng, 5, 90, 70)
    for k, canonical in ((3, False), (31, True)):
        got = cs.reference_indices(codes, k, canonical)
        fn = canonical_indices_np if canonical else window_indices_np
        want = np.stack([fn(r, k) for r in codes])
        np.testing.assert_array_equal(got, want)


def test_check_rows_rejects_a_wrong_count(rng):
    import jax.numpy as jnp

    from cfrk_tpu.ops.perread_sparse import count_perread_rows

    codes = cs._codes(rng, 4, 64, 64)
    ref = cs.reference_indices(codes, 5, False)
    idx, cnt = (np.asarray(a) for a in count_perread_rows(jnp.asarray(codes), 5))
    cs.check_rows((idx, cnt), ref, 5)
    bad = cnt.copy()
    r, c = np.argwhere(bad > 0)[0]
    bad[r, c] += 1
    with pytest.raises(AssertionError):
        cs.check_rows((idx, bad), ref, 5)


def test_sum_fields_and_valid_windows(tmp_path):
    p = tmp_path / "x.cfrk"
    p.write_bytes(b"0:12 1:0 2:3 \n0:1 1:105 2:0 ")
    assert cs.sum_fields(str(p), b":", b" ") == (121, 1)
    t = tmp_path / "x.tsv"
    t.write_bytes(b"AAC\t7\nACG\t10\n")
    assert cs.sum_fields(str(t), b"\t", b"\n") == (17, 2)
    codes = np.array([[0, 1, -1, 2, 3, 3], [0, 0, 0, 0, 0, 0]], np.int8)
    assert cs.valid_windows(codes, 2) == 3 + 5
    assert cs.valid_windows(codes, 3) == 1 + 4


def test_fasta_codes_and_head(tmp_path):
    src = tmp_path / "r.fasta"
    seq_a, seq_b = b"ACGTN" * 30, b"T" * 150
    src.write_bytes(b">a\n" + seq_a + b"\n>b\n" + seq_b + b"\n")
    codes = cs.fasta_codes(str(src))
    assert codes.shape == (2, 150)
    assert codes[0, :5].tolist() == [0, 1, 2, 3, -1]
    assert (codes[1] == 3).all()
    head = tmp_path / "h.fasta"
    cs.head_fasta(str(src), str(head), 1)
    assert head.read_bytes() == b">a\n" + seq_a + b"\n"


def test_phase_cli_tiny(tmp_path, monkeypatch):
    """Every leg through cli.main, prefix byte-compared with the plain
    reference and full-size mass checks (k=15 spectrum cut to k=6)."""
    monkeypatch.setitem(cs.LEG_K, "d", 6)
    cs.phase_cli(str(tmp_path), reads=240, spectrum_reads=160, prefix=90,
                 timings={"rows_k8_cli": 1.0})


def test_phase_four_on_virtual_devices(tmp_path, monkeypatch):
    """The four-card legs on four virtual CPU devices: byte-identical to
    the one-device runs, including the table-parallel spectrum."""
    monkeypatch.setitem(cs.LEG_K, "d", 6)
    cs.phase_four(str(tmp_path), reads=160, devices=4)


def test_native_build_into_directory(tmp_path):
    from cfrk_tpu.io.build_native import build_extension

    path = build_extension(str(tmp_path))
    assert os.path.exists(path) and path.startswith(str(tmp_path))


def _run_script(cwd, env_extra=None):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_main_refuses_cpu():
    r = _run_script(REPO)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert '"ok": true' not in r.stdout


def test_main_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_script(tmp_path, {"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
