"""Scaling-efficiency harness (BASELINE.json: "scaling eff. @ N hosts").

Weak-scaling sweep of the sharded per-read and global-spectrum paths:
for each device count n in a doubling ladder, run a fixed per-device
workload over an n-device (dp) mesh and report reads/s plus parallel
efficiency vs n=1.

On a multi-GPU host this measures real scaling over NVLink.  On a single
host it can still exercise the full SPMD code path via the virtual CPU
mesh (run with XLA_FLAGS=--xla_force_host_platform_device_count=8); the
efficiency numbers are then compile-path validation, not performance —
all virtual devices share the same cores.

Usage:
    python tools/scaling_bench.py [--k 8] [--reads-per-device 2048]
        [--read-len 150] [--mode perread|spectrum] [--cpu]

Prints one JSON line per mesh size.
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
    ap.add_argument(
        "--reads-per-device", type=int, default=None,
        help="default: 32768 for rows/spectrum (proper weak-scaling "
             "shapes, VERDICT r4 #6); 2048 for the dense perread mode "
             "(a 32768x4**8 dense row block is 8 GB/device — the dense "
             "emitter is matrix-bound by design, which is why the rows "
             "route exists)",
    )
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument(
        "--mode",
        choices=["perread", "spectrum", "rows"],
        default="perread",
        help="rows = sparse per-read pairs (the row-sort route)",
    )
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="force the virtual CPU mesh (8 devices)")
    ap.add_argument(
        "--json-out", default=None,
        help="write the ladder to FILE as one JSON document (the "
             "per-round SCALING_r*.json artifact; on a virtual CPU "
             "mesh it is labeled SPMD-validation, not performance)",
    )
    args = ap.parse_args()

    if args.cpu:
        # Append, never setdefault: with XLA_FLAGS already exported the
        # device-count flag would silently not apply and the "scaling"
        # ladder would degenerate to a single n=1 row.
        flag = "--xla_force_host_platform_device_count=8"
        prev = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in prev:
            os.environ["XLA_FLAGS"] = (prev + " " + flag).strip()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from cfrk_tpu.parallel import (
        count_perread_sharded,
        make_mesh,
        shard_batch,
        spectrum_sharded,
    )

    devices = jax.devices()
    ladder = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    rng = np.random.default_rng(0)
    rpd = args.reads_per_device or (2048 if args.mode == "perread" else 32768)
    base = None
    records = []

    def unsharded_step_fn(codes_dev):
        """Same total work on ONE device with no mesh/sharding — the
        SPMD-overhead baseline.  On a virtual CPU mesh every 'device'
        shares the host cores, so weak-scaling efficiency vs n=1 is
        1/n BY CONSTRUCTION (n x the work on the same cores) and says
        nothing about the SPMD path; sharded-vs-unsharded at the SAME
        total batch is the metric that isolates partitioning overhead
        there (VERDICT r4 #6)."""
        if args.mode == "perread":
            from cfrk_tpu.ops.perread import count_perread

            out = count_perread(codes_dev, args.k)
        elif args.mode == "rows":
            from cfrk_tpu.ops.perread_sparse import count_perread_rows

            out = count_perread_rows(codes_dev, args.k)[-1]
        else:
            from cfrk_tpu.ops.spectrum import spectrum

            out = spectrum(codes_dev, args.k)
        return int(jax.numpy.sum(out & 3))

    for n in ladder:
        mesh = make_mesh(devices[:n])
        b = rpd * n
        codes = rng.integers(0, 4, size=(b, args.read_len)).astype(np.int8)
        batch = shard_batch(jax.numpy.asarray(codes), mesh)

        def step(batch=batch, mesh=mesh):
            if args.mode == "perread":
                out = count_perread_sharded(batch, args.k, mesh)
            elif args.mode == "rows":
                from cfrk_tpu.parallel import count_perread_sparse_sharded

                out = count_perread_sparse_sharded(batch, args.k, mesh)[-1]
            else:
                out = spectrum_sharded(batch, args.k, mesh)
            # Scalar fetch = honest sync (see bench.py measurement notes).
            return int(jax.numpy.sum(out & 3))

        step()  # compile + warm
        t0 = time.perf_counter()
        for _ in range(args.steps):
            checksum = step()
        dt = (time.perf_counter() - t0) / args.steps

        # Unsharded same-total-work baseline on device 0.
        plain = jax.device_put(jax.numpy.asarray(codes), devices[0])
        unsharded_step_fn(plain)  # compile + warm
        t0 = time.perf_counter()
        for _ in range(args.steps):
            chk_u = unsharded_step_fn(plain)
        dt_u = (time.perf_counter() - t0) / args.steps
        assert chk_u == checksum, "sharded/unsharded checksum mismatch"

        reads_per_s = b / dt
        if base is None:
            base = reads_per_s
        eff = reads_per_s / (base * n)
        rec = {
            "devices": n,
            "mode": args.mode,
            "k": args.k,
            "reads": b,
            "reads_per_s": round(reads_per_s, 1),
            # Real weak scaling on several cards; 1/n-shaped by
            # construction on a shared-core virtual mesh (see above).
            "efficiency_vs_1dev": round(eff, 4),
            # SPMD overhead: sharded time vs one unsharded executable
            # on the SAME total batch — meaningful on ANY host.
            "efficiency_vs_unsharded": round(dt_u / dt, 4),
            "checksum": checksum,
        }
        records.append(rec)
        print(json.dumps(rec))
        sys.stdout.flush()

    if args.json_out:
        import datetime

        virtual = jax.default_backend() == "cpu"
        doc = {
            "platform": jax.default_backend(),
            "device_kind": getattr(devices[0], "device_kind", "?"),
            # Context for the virtual-mesh numbers: n virtual devices
            # share these physical cores, so efficiency_vs_1dev is
            # bounded by ~cores/n once n > cores — the
            # efficiency_vs_unsharded column is the one that isolates
            # SPMD overhead there.
            "host_cores": os.cpu_count(),
            "reads_per_device": rpd,
            "timestamp": datetime.datetime.now(datetime.timezone.utc)
            .strftime("%Y-%m-%dT%H:%M:%SZ"),
            # HONESTY LABEL: on a virtual CPU mesh every "device" shares
            # the same host cores — the ladder validates that the SPMD
            # paths compile + execute at every mesh size, and the
            # efficiency numbers are NOT performance.  On several
            # cards this same command measures real weak scaling (BASELINE "scaling eff. @ N hosts").
            "spmd_validation_only": virtual,
            "ladder": records,
        }
        import os as _os

        out = {"runs": []}
        if _os.path.exists(args.json_out):
            try:
                with open(args.json_out) as f:
                    out = json.load(f)
                if "runs" not in out:
                    out = {"runs": []}
            except (OSError, ValueError):
                out = {"runs": []}
        out["runs"] = [
            r for r in out["runs"] if r.get("ladder", [{}])[0].get("mode")
            != args.mode
        ] + [doc]
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"# wrote {args.json_out} ({len(out['runs'])} mode runs)")


if __name__ == "__main__":
    main()
