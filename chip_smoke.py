"""Smoke run of the CLI's main path on an NVIDIA GPU.

    python chip_smoke.py           # one card: device, native, kernels, cli
    python chip_smoke.py --four    # four cards: device, native, four

Phases, in order (any failure exits non-zero before the result line):

* ``device``  — the GPU JAX sees (never the CPU), the JAX version, the
  compile cache and ``XLA_FLAGS``, and the card's name and power limit
  as ``nvidia-smi`` prints them;
* ``native``  — builds the C++ ingest/formatter extension from the
  committed source and requires it (the pure-Python fallback is never
  measured unawares);
* ``kernels`` — compiles every device route at real widths, checks each
  against ``cfrk_tpu/ops/reference.py`` with tolerance zero, and prints
  compile seconds, median ms per call, ``memory_analysis()`` and, for
  the row sorts, which sort XLA chose;
* ``cli``     — a seeded FASTA the size of one shard of the reference's
  own deployment (SRR3223884: 2.5 GB in 4 shards, ~4M reads x 150 bp)
  through ``cfrk_tpu.cli.main`` in this process: four legs, each timed
  with its ``--stats`` stages and device peak memory, checked at full
  size (rows, count mass) and byte for byte against the plain reference
  on a 20k-read prefix;
* ``four``    (``--four`` only) — the mesh legs on four cards, each
  byte-compared with the one-card output of the same input.

Everything runs in ONE process: a JAX process reserves most of a card's
memory, so a second one could not use it.  The last line of stdout is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "smoke_work")  # listed in .gitignore

READ_LEN = 150
SHARD_READS = 4_000_000  # one of the reference deployment's 4 shards
SPECTRUM_READS = 1_000_000  # BASELINE config 3
PREFIX_READS = 20_000
FOUR_READS = 1_000_000

# (name, route, k, canonical, rows, length, valid_len).  Rows of width
# 256 holding 150 bases are the CLI's own batches (150 bp reads pad to
# the 256 length bucket; 32768 reads is the auto batch), so their times
# sit beside the legs that dispatch them.
KERNEL_CASES = [
    ("rows_k8_150", "rows", 8, False, 32768, 150, 150),
    ("rows_k31c_152", "rows", 31, True, 32768, 152, 152),
    ("rows_k2_cli", "rows", 2, False, 32768, 256, 150),
    ("rows_k8_cli", "rows", 8, False, 32768, 256, 150),
    ("rows_k31c_cli", "rows", 31, True, 32768, 256, 150),
    ("rows_k8_32kb", "rows", 8, False, 8, 32768, 32768),
    ("rows_k8_128kb", "rows", 8, False, 8, 131072, 131072),
    ("rows_k31c_128kb", "rows", 31, True, 8, 131072, 131072),
    ("rows_k8_1mb", "rows", 8, False, 8, 1 << 20, 1 << 20),
    ("perread_k8_scatter", "perread", 8, False, 8192, 150, 150),
    ("perread_k3_compare", "perread", 3, False, 8192, 150, 150),
    ("perread_k6_matmul", "perread-matmul", 6, False, 8192, 150, 150),
    ("spectrum_k6_matmul", "spectrum", 6, False, 8192, 150, 150),
    ("spectrum_k12_scatter", "spectrum", 12, False, 8192, 150, 150),
    ("spectrum_k15_scatter", "spectrum", 15, False, 8192, 150, 150),
    ("spectrum_k15_cli", "spectrum", 15, False, 32768, 256, 150),
]

# k of each CLI leg, by its letter.
LEG_K = {"a": 2, "b": 8, "c": 31, "d": 15}

# CLI leg -> the kernel case that is its per-batch device work.
LEG_KERNEL = {
    "a_k2_cfrk": "rows_k2_cli",
    "b_k8_nonzero": "rows_k8_cli",
    "c_k31_canonical_sparse": "rows_k31c_cli",
    "d_k15_spectrum": "spectrum_k15_cli",
}


def log(msg) -> None:
    print(msg if isinstance(msg, str) else json.dumps(msg), flush=True)


# ---------------------------------------------------------------- device


def phase_device(cache_dir: str, need: int) -> dict:
    import jax

    from cfrk_tpu.runtime.device import card_identity, require_gpu

    try:
        devs = require_gpu()
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: {e}")
    if len(devs) < need:
        raise SystemExit(f"chip_smoke: needs {need} GPUs, found {len(devs)}")
    log(f"device_kind={devs[0].device_kind} count={len(devs)} "
        f"jax={jax.__version__}")
    log(f"compile_cache={cache_dir} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(card_identity())
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


# ---------------------------------------------------------------- native


def phase_native() -> None:
    """Build the extension before anything imports it, then require it."""
    from cfrk_tpu.io.build_native import build_extension

    t0 = time.perf_counter()
    path = build_extension()
    log(f"native: built {os.path.relpath(path, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    from cfrk_tpu.io import native

    if not native.HAVE_NATIVE:
        raise RuntimeError("native extension did not load")


# ---------------------------------------------------------------- kernels


def _codes(rng, rows: int, length: int, valid_len: int) -> np.ndarray:
    """Random bases with ~0.2% N (-1), padded with -1 past valid_len."""
    codes = rng.integers(0, 4, size=(rows, length), dtype=np.int8)
    codes[rng.random((rows, length), dtype=np.float32) < 0.002] = -1
    codes[:, valid_len:] = -1
    return codes


def reference_indices(codes: np.ndarray, k: int, canonical: bool) -> np.ndarray:
    """[B, L-k+1] int64 window indices (-1 invalid) from the plain
    reference, applied to the rows laid end to end with one -1
    separator each (a window touching it is invalid, as at a row end)."""
    from cfrk_tpu.ops.reference import canonical_indices_np, window_indices_np

    b, length = codes.shape
    flat = np.concatenate(
        [codes, np.full((b, 1), -1, codes.dtype)], axis=1
    ).reshape(-1)
    fn = canonical_indices_np if canonical else window_indices_np
    idx = fn(flat, k)
    idx = np.concatenate([idx, np.full(k - 1, -1, idx.dtype)])
    return idx.reshape(b, length + 1)[:, : length - k + 1]


def _reference_runs(ref: np.ndarray):
    """(row, key, count) of every distinct valid window per row,
    row-major and ascending by key within a row."""
    rows, cols = np.nonzero(ref >= 0)
    keys = ref[rows, cols].astype(np.uint64)
    order = np.lexsort((keys, rows))
    rows, keys = rows[order], keys[order]
    first = np.ones(len(keys), bool)
    first[1:] = (rows[1:] != rows[:-1]) | (keys[1:] != keys[:-1])
    starts = np.flatnonzero(first)
    counts = np.diff(np.r_[starts, len(keys)])
    return rows[starts], keys[starts], counts


def check_rows(out, ref: np.ndarray, k: int) -> None:
    """The rows route's exact layout: each run start holds (key, count)
    at the position the counts before it in its row sum to; every other
    cell holds the sentinel with count 0; the runs equal the reference's."""
    from cfrk_tpu.ops.sparse import INVALID_SENTINEL, LO_BASES

    arrs = [np.asarray(a) for a in out]
    cnt = arrs[-1].astype(np.int64)
    run = cnt > 0
    if len(arrs) == 2:
        idx = arrs[0].astype(np.int64)
        keys_all = idx.astype(np.uint64)
        sentinel_ok = np.all(idx[~run] == 4**k)
    else:
        hi, lo = arrs[0].astype(np.uint64), arrs[1].astype(np.uint64)
        keys_all = (hi << np.uint64(2 * LO_BASES)) | lo
        sentinel_ok = np.all(arrs[0][~run] == INVALID_SENTINEL) and np.all(
            arrs[1][~run] == INVALID_SENTINEL
        )
    if not sentinel_ok or np.any(cnt[~run] != 0):
        raise AssertionError("non-run cells must hold (sentinel, 0)")
    rows, cols = np.nonzero(run)
    before = (np.cumsum(cnt, axis=1) - cnt)[rows, cols]
    if not np.array_equal(before, cols):
        raise AssertionError("run starts are not at their sorted positions")
    want = _reference_runs(ref)
    got = (rows, keys_all[rows, cols], cnt[rows, cols])
    for g, w, what in zip(got, want, ("rows", "keys", "counts")):
        if not np.array_equal(g, w):
            raise AssertionError(f"rows route {what} differ from the reference")


def check_spectrum(table, ref: np.ndarray, k: int) -> None:
    table = np.asarray(table)
    if table.shape != (4**k,):
        raise AssertionError(f"spectrum shape {table.shape}")
    keys, counts = np.unique(ref[ref >= 0], return_counts=True)
    nz = np.flatnonzero(table)
    if not (np.array_equal(nz, keys) and np.array_equal(table[nz], counts)):
        raise AssertionError("spectrum differs from the reference")


def _sort_choice(hlo: str) -> str:
    if "__cub$" in hlo or "DeviceRadixSort" in hlo:
        return "cub_custom_call"
    if " sort(" in hlo:
        return "xla_sort"
    return "none"


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    return {
        f: getattr(ma, f)
        for f in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
        )
        if hasattr(ma, f)
    }


def phase_kernels(cases=KERNEL_CASES, reps: int = 10, distinct: int = 2) -> dict:
    """Compile, time and check every case; returns {name: ms per call}."""
    import jax.numpy as jnp

    from cfrk_tpu.ops.perread import count_perread
    from cfrk_tpu.ops.perread_sparse import count_perread_rows
    from cfrk_tpu.ops.reference import count_perread_np
    from cfrk_tpu.ops.spectrum import spectrum
    from cfrk_tpu.runtime.device import compile_and_time

    timings = {}
    for name, route, k, canonical, rows, length, valid_len in cases:
        rng = np.random.default_rng(k * 7919 + length)
        host = [_codes(rng, rows, length, valid_len) for _ in range(distinct)]
        xs = [(jnp.asarray(h),) for h in host]
        if route == "rows":
            fn = lambda x, k=k, c=canonical: count_perread_rows(x, k, c)  # noqa: E731
        elif route == "perread":
            fn = lambda x, k=k: count_perread(x, k)  # noqa: E731
        elif route == "perread-matmul":
            fn = lambda x, k=k: count_perread(x, k, impl="matmul")  # noqa: E731
        else:
            fn = lambda x, k=k: spectrum(x, k)  # noqa: E731
        compiled, out, compile_s, ms = compile_and_time(fn, xs, reps)
        rec = {
            "case": name, "k": k, "canonical": canonical,
            "shape": [rows, length], "compile_s": compile_s,
            "median_ms": ms, "memory": _memory(compiled),
        }
        if route == "rows":
            rec["sort"] = _sort_choice(compiled.as_text())
            check_rows(out, reference_indices(host[0], k, canonical), k)
        elif route.startswith("perread"):
            want = count_perread_np(list(host[0]), k)
            if not np.array_equal(np.asarray(out), want):
                raise AssertionError(f"{name}: differs from the reference")
        else:
            check_spectrum(out, reference_indices(host[0], k, canonical), k)
        rec["exact"] = True
        log(rec)
        timings[name] = ms
        del out, xs, compiled
    return timings


# ---------------------------------------------------------------- cli


def make_fasta(path: str, reads: int, seed: int = 0) -> None:
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "make_synthetic.py"),
         path, "--reads", str(reads), "--read-len", str(READ_LEN),
         "--seed", str(seed)],
        check=True, capture_output=True, timeout=900,
    )


def head_fasta(src: str, dst: str, reads: int) -> None:
    """The first ``reads`` records of a two-line-per-record FASTA."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        for _ in range(2 * reads):
            line = f.readline()
            if not line:
                break
            g.write(line)


def fasta_codes(path: str) -> np.ndarray:
    """[n, READ_LEN] int8 codes (A0 C1 G2 T3, else -1) of a FASTA whose
    sequence lines all hold READ_LEN bases — parsed with NumPy alone,
    independently of the program's own parser."""
    data = np.fromfile(path, dtype=np.uint8)
    ends = np.flatnonzero(data == ord("\n"))
    starts = np.r_[0, ends[:-1] + 1]
    seq_starts = starts[1::2]
    if not np.all(ends[1::2] - seq_starts == READ_LEN):
        raise AssertionError("sequence lines are not all READ_LEN long")
    lut = np.full(256, -1, np.int8)
    for code, base in enumerate(b"ACGT"):
        lut[base] = code
    out = np.empty((len(seq_starts), READ_LEN), np.int8)
    step = 1 << 18
    for s in range(0, len(seq_starts), step):
        pos = seq_starts[s : s + step, None] + np.arange(READ_LEN)
        out[s : s + step] = lut[data[pos]]
    return out


def valid_windows(codes: np.ndarray, k: int) -> int:
    """Windows of k valid bases, summed over reads (NumPy)."""
    total = 0
    for s in range(0, len(codes), 1 << 18):
        bad = np.cumsum(codes[s : s + (1 << 18)] < 0, axis=1, dtype=np.int32)
        bad = np.concatenate([np.zeros((len(bad), 1), np.int32), bad], axis=1)
        total += int(np.count_nonzero(bad[:, k:] == bad[:, :-k]))
    return total


def sum_fields(path: str, after: bytes, end: bytes) -> tuple[int, int]:
    """(sum of the integers between each ``after`` byte and the next
    ``end`` byte, number of newline bytes) of a text file."""
    total = 0
    newlines = 0
    a_code, e_code = after[0], end[0]
    with open(path, "rb") as f:
        carry = b""
        while True:
            block = f.read(1 << 28)
            buf = carry + block
            if not buf:
                break
            cut = len(buf) if not block else buf.rfind(b"\n") + 1
            carry, buf = buf[cut:], buf[:cut]
            a = np.frombuffer(buf, np.uint8)
            newlines += int(np.count_nonzero(a == ord("\n")))
            first = np.flatnonzero(a == a_code) + 1
            term = np.flatnonzero(a == e_code)
            last = term[np.searchsorted(term, first)]
            n = last - first
            place = np.ones(len(first), np.int64)
            for j in range(int(n.max(initial=0))):
                live = n > j
                digit = a[last[live] - 1 - j].astype(np.int64) - ord("0")
                total += int((digit * place[live]).sum())
                place[live] *= 10
            if not block:
                break
    return total, newlines


def _expected_cfrk(codes, k: int, nonzero: bool) -> bytes:
    from cfrk_tpu.format import format_file_bytes, format_rows_nonzero
    from cfrk_tpu.ops.reference import count_perread_np

    if not nonzero:
        return format_file_bytes(count_perread_np(list(codes), k))
    rows = []
    for s in range(0, len(codes), 1000):
        rows += format_rows_nonzero(count_perread_np(list(codes[s : s + 1000]), k))
    return b"\n".join(rows)


def _expected_kmer_tsv(codes, k: int) -> bytes:
    ref = reference_indices(codes, k, canonical=True)
    keys, counts = np.unique(ref[ref >= 0], return_counts=True)
    shifts = (2 * np.arange(k - 1, -1, -1)).astype(np.int64)
    digits = (keys[:, None] >> shifts) & 3
    text = np.frombuffer(b"ACGT", np.uint8)[digits]
    return b"".join(
        row.tobytes() + b"\t%d\n" % c for row, c in zip(text, counts.tolist())
    )


def run_leg(name: str, argv: list, bases: int, kernel_ms=None) -> dict:
    """One ``cli.main`` run in this process, timed, with its stats."""
    import jax

    from cfrk_tpu.cli import main as cli_main

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"leg {name}: exit {rc}\n{err.getvalue()[-2000:]}")
    stats = [
        json.loads(line) for line in err.getvalue().splitlines()
        if line.startswith("{")
    ]
    rec = {
        "leg": name, "wall_s": wall, "bases_per_s": bases / wall,
        "stats": next((s for s in stats if "stages_s" in s), None),
        "peak_bytes_in_use": [
            (d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in jax.local_devices()
        ],
    }
    batches = (rec["stats"] or {}).get("batches")
    if kernel_ms is not None and batches:
        rec["wall_ms_per_batch"] = wall * 1e3 / batches
        rec["device_ms_per_batch"] = kernel_ms
        rec["device_share"] = kernel_ms * batches / (wall * 1e3)
    log(rec)
    return rec


def _legs(fasta: str, spec_fasta: str, out: str, devices: int) -> dict:
    """name -> (argv, output path); the CLI flags every leg shares last."""
    common = ["--devices", str(devices), "--stream", "--stats"]
    return {
        "a_k2_cfrk": (
            [fasta, f"{out}_a.cfrk", str(LEG_K["a"]), *common],
            f"{out}_a.cfrk",
        ),
        "b_k8_nonzero": (
            [fasta, "-k", str(LEG_K["b"]), "--nonzero",
             "-o", f"{out}_b.cfrk", *common],
            f"{out}_b.cfrk",
        ),
        "c_k31_canonical_sparse": (
            [fasta, "-k", str(LEG_K["c"]), "--canonical", "--mode", "sparse",
             "-o", f"{out}_c.tsv", *common],
            f"{out}_c.tsv",
        ),
        "d_k15_spectrum": (
            [spec_fasta, "-k", str(LEG_K["d"]), "--mode", "spectrum",
             "--spectrum-format", "npy", "-o", f"{out}_d.npy", *common],
            f"{out}_d.npy",
        ),
        "d_k15_spectrum_sort": (
            [spec_fasta, "-k", str(LEG_K["d"]), "--mode", "spectrum",
             "--impl", "sort", "--spectrum-format", "npy",
             "-o", f"{out}_ds.npy", *common],
            f"{out}_ds.npy",
        ),
    }


def check_prefix(legs: dict, codes: np.ndarray) -> None:
    """Byte-compare each prefix leg with the plain reference's output."""
    for name, (_, path) in legs.items():
        k = LEG_K[name[0]]
        if name.startswith("a"):
            want = _expected_cfrk(codes, k, nonzero=False)
        elif name.startswith("b"):
            want = _expected_cfrk(codes, k, nonzero=True)
        elif name.startswith("c"):
            want = _expected_kmer_tsv(codes, k)
        else:
            table = np.load(path)
            if table.dtype != np.int64:
                raise AssertionError(f"{name}: dtype {table.dtype}")
            check_spectrum(table, reference_indices(codes, k, False), k)
            log(f"prefix {name}: exact")
            continue
        with open(path, "rb") as f:
            got = f.read()
        if got != want:
            raise AssertionError(f"prefix {name}: bytes differ from the reference")
        log(f"prefix {name}: byte-identical ({len(got)} bytes)")


def check_full(name: str, path: str, codes: np.ndarray) -> None:
    """Row count and count mass of a full-size leg against NumPy."""
    want_mass = valid_windows(codes, LEG_K[name[0]])
    rows = len(codes)  # sparse and spectrum outputs have no per-read rows
    if name.startswith("d"):
        mass = int(np.load(path, mmap_mode="r").sum(dtype=np.int64))
    elif name.startswith("c"):
        mass, _ = sum_fields(path, b"\t", b"\n")
    else:
        mass, newlines = sum_fields(path, b":", b" ")
        rows = newlines + 1  # rows are joined by newlines, none trailing
    if rows != len(codes) or mass != want_mass:
        raise AssertionError(
            f"{name}: {rows} rows / mass {mass}, want {len(codes)} / {want_mass}"
        )
    log(f"full {name}: {rows} rows, count mass {mass} = valid windows")


def phase_cli(work: str, reads: int = SHARD_READS,
              spectrum_reads: int = SPECTRUM_READS,
              prefix: int = PREFIX_READS, timings=None) -> None:
    timings = timings or {}
    fasta = os.path.join(work, "reads.fasta")
    spec_fasta = os.path.join(work, "reads_spectrum.fasta")
    pre_fasta = os.path.join(work, "prefix.fasta")
    pre_spec = os.path.join(work, "prefix_spectrum.fasta")
    t0 = time.perf_counter()
    make_fasta(fasta, reads)
    head_fasta(fasta, spec_fasta, spectrum_reads)
    head_fasta(fasta, pre_fasta, prefix)
    head_fasta(fasta, pre_spec, prefix)
    log(f"cli: {reads} reads x {READ_LEN} bp, "
        f"{os.path.getsize(fasta)} bytes, made in {time.perf_counter() - t0:.1f} s")

    pre_codes = fasta_codes(pre_fasta)
    pre_legs = _legs(pre_fasta, pre_spec, os.path.join(work, "pre"), 1)
    for name, (argv, _) in pre_legs.items():
        run_leg(f"prefix_{name}", argv, prefix * READ_LEN)
    check_prefix(pre_legs, pre_codes)
    for _, path in pre_legs.values():
        os.remove(path)

    codes = fasta_codes(fasta)
    legs = _legs(fasta, spec_fasta, os.path.join(work, "full"), 1)
    for name, (argv, path) in legs.items():
        part = codes[:spectrum_reads] if name.startswith("d") else codes
        run_leg(name, argv, part.size, timings.get(LEG_KERNEL.get(name)))
        check_full(name, path, part)
        if name == "d_k15_spectrum_sort":
            same = np.array_equal(
                np.load(path, mmap_mode="r"),
                np.load(legs["d_k15_spectrum"][1], mmap_mode="r"),
            )
            if not same:
                raise AssertionError("spectrum --impl sort differs from auto")
            log("full d_k15_spectrum_sort: identical to the auto route")
            os.remove(legs["d_k15_spectrum"][1])
        if name != "d_k15_spectrum":
            os.remove(path)


# ---------------------------------------------------------------- four


def phase_four(work: str, reads: int = FOUR_READS, devices: int = 4) -> None:
    """Legs b, c, d (and d with --tp) on ``devices`` cards, each
    byte-compared with the one-card run of the same input."""
    import filecmp

    fasta = os.path.join(work, "reads.fasta")
    make_fasta(fasta, reads)
    one = _legs(fasta, fasta, os.path.join(work, "one"), 1)
    many = _legs(fasta, fasta, os.path.join(work, "many"), devices)
    tp_argv = many["d_k15_spectrum"][0] + ["--tp", str(devices)]
    tp_out = os.path.join(work, "many_tp.npy")
    tp_argv[tp_argv.index(many["d_k15_spectrum"][1])] = tp_out
    runs = [
        (name, many[name], one[name][1])
        for name in ("b_k8_nonzero", "c_k31_canonical_sparse", "d_k15_spectrum")
    ] + [("d_k15_spectrum_tp", (tp_argv, tp_out), one["d_k15_spectrum"][1])]
    bases = reads * READ_LEN
    for name in ("b_k8_nonzero", "c_k31_canonical_sparse", "d_k15_spectrum"):
        run_leg(f"one_{name}", one[name][0], bases)
    for name, (argv, path), ref in runs:
        run_leg(f"{devices}cards_{name}", argv, bases)
        if not filecmp.cmp(path, ref, shallow=False):
            raise AssertionError(f"{name}: {devices}-card output differs")
        log(f"{name}: {devices}-card output byte-identical to 1 card")
        os.remove(path)


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the four-card mesh legs (needs 4 GPUs)",
    )
    args = ap.parse_args(argv)

    from cfrk_tpu.runtime.compile_cache import setup_compile_cache

    cache_dir = setup_compile_cache()
    need = 4 if args.four else 1
    t_all = time.perf_counter()
    log("== phase device")
    info = phase_device(cache_dir, need)
    log("== phase native")
    phase_native()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        if args.four:
            log("== phase four")
            phase_four(WORK)
        else:
            log("== phase kernels")
            timings = phase_kernels()
            log("== phase cli")
            phase_cli(WORK, timings=timings)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"all phases ok in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
