"""BASELINE config-5 bounded-scale demonstration.

One end-to-end run of >= 10M synthetic reads (bgzf), driven through the
REAL CLI surface (`python -m cfrk_tpu ...` subprocesses), producing one
JSON document:

* ``perread_k8_nonzero`` — time-to-exact-.cfrk for the per-read pairs
  route (BASELINE metric 2 at scale), with per-stage breakdown and the
  output sha256.
* ``spectrum_k8`` — the zero-D2H dense spectrum (device-resident
  table), the ingest-bound ceiling of the host.
* ``sparse_k31_resume`` — canonical k=31 sparse spectrum run THREE
  ways: uninterrupted, SIGKILLed mid-run, and ``--resume``d; the
  resumed output must hash byte-identical to the uninterrupted one.

Reads are sampled from synthetic genomes (tools/make_synthetic.py) so
the k=31 key space is genome-sized, not |windows|-sized — random reads
would make every 31-mer distinct, which no real dataset does.

The parent process never imports JAX: each leg is a CLI child started
after the previous one exits, so exactly one process holds the card.
Run:  python tools/scale_demo.py --reads 10000000 --json-out scale.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PY = sys.executable


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _proc_rss_mb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024
    except OSError:
        pass
    return 0.0


def run_cli(args_list, kill_after: float | None = None,
            poll_rss: bool = False):
    """Run `python -m cfrk_tpu <args>`; returns (rc, wall_s, stats|None,
    child_maxrss_mb).  ``kill_after``: SIGKILL the exact child PID after
    that many seconds (the mid-run crash for the resume splice).
    ``poll_rss``: sample the child's /proc VmRSS every second and
    report ITS true peak instead of the cumulative RUSAGE_CHILDREN max
    (which cannot attribute a peak to one child)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [PY, "-m", "cfrk_tpu", *args_list],
        cwd=ROOT,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )
    killed = False
    peak_rss = 0.0
    if poll_rss:
        while proc.poll() is None:
            peak_rss = max(peak_rss, _proc_rss_mb(proc.pid))
            if kill_after is not None and (
                time.perf_counter() - t0 > kill_after
            ):
                proc.kill()
                killed = True
                break
            time.sleep(1.0)
    elif kill_after is not None:
        try:
            proc.wait(timeout=kill_after)
        except subprocess.TimeoutExpired:
            proc.kill()  # exact PID — never a pattern
            killed = True
    out, err = proc.communicate()
    wall = time.perf_counter() - t0
    stats = None
    for line in (err or "").splitlines():
        line = line.strip()
        if line.startswith("{") and '"stages_s"' in line:
            try:
                stats = json.loads(line)
            except ValueError:
                pass
    if proc.returncode not in (0,) and not killed:
        tail = "\n".join((err or "").splitlines()[-12:])
        raise RuntimeError(
            f"cfrk_tpu {' '.join(args_list)} -> rc {proc.returncode}\n{tail}"
        )
    rss_mb = (
        peak_rss
        if poll_rss
        else resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024
    )
    return proc.returncode, wall, stats, round(rss_mb, 1), killed


def run_leg(args_list, retries: int = 2):
    """run_cli with the framework's own recovery story as the retry:
    a transient failure is retried with ``--resume`` so the leg continues from its checkpoint
    instead of restarting.  Returns the run_cli tuple + retry count."""
    total_wall = 0.0
    attempt_args = list(args_list)
    for attempt in range(retries + 1):
        try:
            rc, wall, stats, rss, killed = run_cli(attempt_args)
            return rc, total_wall + wall, stats, rss, attempt
        except RuntimeError as e:
            total_wall += 0.0
            print(f"# leg attempt {attempt} failed: "
                  f"{str(e).splitlines()[0]}", flush=True)
            if attempt == retries:
                raise
            if "--resume" not in attempt_args:
                attempt_args = attempt_args + ["--resume"]
            time.sleep(10)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=10_000_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--genomes", type=int, default=8)
    ap.add_argument("--genome-len", type=int, default=2_500_000)
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: ./scale_scratch; needs "
                         "~35 GB for the 10M-read perread output)")
    ap.add_argument("--json-out", default="scale.json")
    ap.add_argument("--skip", default="",
                    help="comma list of legs to skip: perread,spectrum,sparse")
    ap.add_argument("--sparse-mem-mb", type=int, default=4096,
                    help="--mem-budget-mb for the sparse k=31 leg: the "
                         "accumulator spills sorted runs to disk past "
                         "budget/3 in-memory bytes, bounding host RSS "
                         "(0 = unbounded)")
    ap.add_argument("--scale-check-reads", type=int, default=20_000_000,
                    help="extra sparse leg at this read count (>= 2x "
                         "--reads) pinning the memory cap's "
                         "scale-invariance: peak RSS must stay flat "
                         "while wall scales with reads; also "
                         "integrity-checks the output count mass "
                         "against the synthetic N-rate model "
                         "(0 = skip)")
    ap.add_argument("--kill-frac", type=float, default=0.4,
                    help="SIGKILL the sparse leg at this fraction of its "
                         "uninterrupted wall time")
    args = ap.parse_args()
    skip = set(filter(None, args.skip.split(",")))

    wd = args.workdir or os.path.join(ROOT, "scale_scratch")
    os.makedirs(wd, exist_ok=True)
    fasta = os.path.join(wd, f"reads_{args.reads}.fasta.bgz")

    doc: dict = {
        "reads": args.reads,
        "read_len": args.read_len,
        "genomes": args.genomes,
        "genome_len": args.genome_len,
        "notes": [
            "ru_maxrss_mb is the max RSS over all finished CLI "
            "subprocesses up to that leg",
        ],
        "legs": {},
    }

    def log(msg):
        print(f"# {msg}", flush=True)

    if not os.path.exists(fasta):
        log(f"synthesizing {args.reads} reads -> {fasta}")
        t0 = time.perf_counter()
        subprocess.run(
            [PY, os.path.join(ROOT, "tools", "make_synthetic.py"), fasta,
             "--reads", str(args.reads), "--read-len", str(args.read_len),
             "--genomes", str(args.genomes),
             "--genome-len", str(args.genome_len), "--bgzf"],
            check=True, cwd=ROOT,
        )
        doc["synth_s"] = round(time.perf_counter() - t0, 1)
    doc["input_bytes_bgzf"] = os.path.getsize(fasta)

    # ---- leg 1: perread k=8 --nonzero (time-to-exact-.cfrk at scale)
    if "perread" not in skip:
        out = os.path.join(wd, "perread_k8.cfrk")
        log("perread k=8 --nonzero (pairs route)")
        _, wall, stats, rss, retries = run_leg(
            [fasta, "-k", "8", "-o", out, "--nonzero", "--stream",
             "--stats"],
        )
        doc["legs"]["perread_k8_nonzero"] = {
            "wall_s": round(wall, 1),
            "resume_retries": retries,
            "bases_per_s": round(args.reads * args.read_len / wall, 1),
            "out_bytes": os.path.getsize(out),
            "sha256": sha256_file(out),
            "stats": stats,
            "ru_maxrss_mb": rss,
        }
        os.remove(out)
        log(f"perread done in {wall:.0f}s")

    # ---- leg 2: spectrum k=8 (device-resident table, zero per-batch D2H)
    if "spectrum" not in skip:
        out = os.path.join(wd, "spectrum_k8.cfrk")
        log("spectrum k=8 (device-resident table)")
        _, wall, stats, rss, retries = run_leg(
            [fasta, "-k", "8", "-o", out, "--mode", "spectrum", "--stream",
             "--stats"],
        )
        doc["legs"]["spectrum_k8"] = {
            "wall_s": round(wall, 1),
            "resume_retries": retries,
            "bases_per_s": round(args.reads * args.read_len / wall, 1),
            "out_bytes": os.path.getsize(out),
            "sha256": sha256_file(out),
            "stats": stats,
            "ru_maxrss_mb": rss,
        }
        os.remove(out)
        log(f"spectrum done in {wall:.0f}s")

    # ---- leg 3: sparse k=31 canonical, uninterrupted vs kill+resume
    if "sparse" not in skip:
        budget = (
            ["--mem-budget-mb", str(args.sparse_mem_mb)]
            if args.sparse_mem_mb else []
        )
        out_full = os.path.join(wd, "sparse_full.tsv")
        log(f"sparse k=31 canonical (uninterrupted, budget={budget})")
        _, wall_full, stats_full, rss, retries_full = run_leg(
            [fasta, "-k", "31", "--canonical", "-o", out_full, "--mode",
             "sparse", "--stream", "--stats", *budget],
        )
        sha_full = sha256_file(out_full)
        leg = {
            "mem_budget_mb": args.sparse_mem_mb or None,
            "full": {
                "wall_s": round(wall_full, 1),
                "bases_per_s": round(
                    args.reads * args.read_len / wall_full, 1
                ),
                "out_bytes": os.path.getsize(out_full),
                "sha256": sha_full,
                "stats": stats_full,
                "ru_maxrss_mb": rss,
                "resume_retries": retries_full,
            },
        }
        os.remove(out_full)

        out_res = os.path.join(wd, "sparse_resumed.tsv")
        kill_at = max(30.0, wall_full * args.kill_frac)
        log(f"sparse kill at {kill_at:.0f}s then --resume")
        _, wall_killed, _, _, killed = run_cli(
            [fasta, "-k", "31", "--canonical", "-o", out_res, "--mode",
             "sparse", "--stream", "--stats", *budget],
            kill_after=kill_at,
        )
        if not killed:
            log("WARNING: run finished before the kill point; resume "
                "splice not exercised")
        _, wall_res, stats_res, rss2, retries_res = run_leg(
            [fasta, "-k", "31", "--canonical", "-o", out_res, "--mode",
             "sparse", "--stream", "--stats", "--resume", *budget],
        )
        sha_res = sha256_file(out_res)
        leg["killed_at_s"] = round(wall_killed, 1)
        leg["was_killed_midrun"] = killed
        leg["resumed"] = {
            "wall_s": round(wall_res, 1),
            "sha256": sha_res,
            "stats": stats_res,
            "ru_maxrss_mb": rss2,
            "resume_retries": retries_res,
        }
        leg["byte_equal"] = sha_res == sha_full
        doc["legs"]["sparse_k31_resume"] = leg
        os.remove(out_res)
        log(f"sparse byte_equal={leg['byte_equal']}")
        if killed and not leg["byte_equal"]:
            raise SystemExit("RESUME SPLICE MISMATCH — outputs differ")

    # ---- leg 4: memory-cap scale-invariance at >= 2x reads.  The
    # budgeted accumulator + append-only checkpoints + pread merge make
    # host memory O(budget): peak RSS must stay FLAT while wall scales
    # with reads.  Output integrity is checked against the synthetic
    # input's N-rate model (sum of counts == valid windows).
    if "sparse" not in skip and args.scale_check_reads and args.sparse_mem_mb:
        n2 = args.scale_check_reads
        fasta2 = os.path.join(wd, f"reads_{n2}.fasta.bgz")
        if not os.path.exists(fasta2):
            log(f"synthesizing {n2} reads -> {fasta2}")
            subprocess.run(
                [PY, os.path.join(ROOT, "tools", "make_synthetic.py"),
                 fasta2, "--reads", str(n2),
                 "--read-len", str(args.read_len),
                 "--genomes", str(args.genomes),
                 "--genome-len", str(args.genome_len), "--bgzf"],
                check=True, cwd=ROOT,
            )
        out2 = os.path.join(wd, "sparse_scalecheck.tsv")
        log(f"sparse k=31 scale check at {n2} reads (RSS-polled)")
        _, wall2, stats2, rss2, _ = run_cli(
            [fasta2, "-k", "31", "--canonical", "-o", out2, "--mode",
             "sparse", "--stream", "--stats",
             "--mem-budget-mb", str(args.sparse_mem_mb)],
            poll_rss=True,
        )
        mass = int(subprocess.run(
            ["awk", "-F", "\t", "{s+=$2} END {printf \"%.0f\", s}", out2],
            capture_output=True, text=True, check=True,
        ).stdout)
        model_script = (
            "import sys, numpy as np\n"
            "sys.path.insert(0, %r)\n"
            "from cfrk_tpu.io.bgzf import open_maybe_bgzf\n"
            "n = valid = 0\n"
            "with open_maybe_bgzf(sys.argv[1]) as f:\n"
            "    for i, line in enumerate(f):\n"
            "        if i >= 200000: break\n"
            "        if line.startswith(b'>'): continue\n"
            "        s = line.strip(); n += 1\n"
            "        b = np.frombuffer(s, np.uint8)\n"
            "        isn = ~np.isin(b, np.frombuffer(b'ACGT', np.uint8))\n"
            "        W = len(s) - 31 + 1\n"
            "        ok = np.ones(W, bool)\n"
            "        for p in np.flatnonzero(isn):\n"
            "            ok[max(0, p - 30):p + 1] = False\n"
            "        valid += int(ok.sum())\n"
            "print(valid / n)\n"
        ) % ROOT
        per_read = float(subprocess.run(
            [PY, "-c", model_script, fasta2],
            capture_output=True, text=True, check=True,
        ).stdout.strip())
        leg4 = {
            "reads": n2,
            "mem_budget_mb": args.sparse_mem_mb,
            "wall_s": round(wall2, 1),
            "stats": stats2,
            "peak_rss_mb": round(rss2),
            "out_bytes": os.path.getsize(out2),
            "count_mass": mass,
            "count_mass_model": round(per_read * n2),
            "notes": [
                "peak_rss_mb is THIS child's polled /proc VmRSS peak "
                "(finalize included) — compare with the base sparse "
                "leg's: flat peak at 2x reads demonstrates the memory "
                "cap's scale-invariance (the >= 100M extrapolation)",
                "count_mass vs the input N-rate model (sampled 100k "
                "reads) is an independent integrity check of the "
                "multi-GB output",
            ],
        }
        doc["legs"][f"sparse_k31_scale_check_{n2 // 1_000_000}m"] = leg4
        os.remove(out2)
        log(
            f"scale check done in {wall2:.0f}s, peak {rss2:.0f} MB, "
            f"mass {mass} vs model {round(per_read * n2)}"
        )

    import datetime

    doc["timestamp"] = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )
    with open(os.path.join(ROOT, args.json_out), "w") as f:
        json.dump(doc, f, indent=1)
    log(f"wrote {args.json_out}")


if __name__ == "__main__":
    main()
