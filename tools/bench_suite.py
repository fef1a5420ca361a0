"""Benchmark suite over the BASELINE.json configs (one JSON line each).

Device cases (steady-state jitted scans cycling distinct batches, each
ending on a one-scalar fetch):

- perread_k8_dense    — dense per-read scatter route (k=8)
- perread_k8_rowsort  — per-read rows route (the `.cfrk` output route)
- perread_k8_short    — 70 bp reads through the rows route
- contig_k8_32kb / contig_k8_128kb — full-width row sorts of contigs
- spectrum_k8 / spectrum_k15 — dense spectrum (device-resident table)
- spectrum_k8_sort / spectrum_k15_sort — sorted spectrum, device side
- spectrum_k9_e2e     — sorted k=9 route with its host fold, overlapped
- sparse_k31          — canonical 2-key row sort (config 4's core)

Host / end-to-end cases:

- golden  — time-to-exact-.cfrk on the golden sample, hash-checked
- ingest  — chunked C++ parser over an on-disk synthetic FASTA
            (--ingest-reads to scale to >= 10M reads)
- stream / stream_spectrum — the full streaming driver with per-stage
  breakdowns

--json-out writes all records to one JSON document.
Run: python tools/bench_suite.py [--reads N] [--cpu] [--only a,b]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


RECORDS: list[dict] = []


def _emit(name: str, seconds: float, work: float, unit: str, extra=None) -> None:
    rec = {
        "bench": name,
        "wall_s": round(seconds, 4),
        "value": round(work / seconds, 1) if seconds > 0 else 0.0,
        "unit": unit,
    }
    if extra:
        rec.update(extra)
    RECORDS.append(rec)
    print(json.dumps(rec))
    sys.stdout.flush()


def _scan_case(step_val, xs, steps: int):
    """Steady-state step time of a jitted per-batch scalar-producing fn:
    jitted lax.scan cycling the DISTINCT batches of xs (a loop-invariant
    input would let XLA hoist the work out of the loop), timed ending on
    a one-scalar fetch.  Returns (seconds_total, checksum)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    distinct = xs.shape[0]

    def run(xs):
        def body(c, i):
            return c + step_val(xs[i % distinct]), ()

        c, _ = jax.lax.scan(body, jnp.int32(0), jnp.arange(steps))
        return c

    fn = jax.jit(run)
    _ = int(np.asarray(step_val(xs[0])))  # compile the bare step first
    _ = int(np.asarray(fn(xs)))  # compile scan + warm
    t0 = time.perf_counter()
    chk = int(np.asarray(fn(xs)))
    return time.perf_counter() - t0, chk


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--reads", type=int, default=None,
        help="reads per device batch (default: auto_batch_size per "
             "case read length — 32768 at 150 bp)",
    )
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument(
        "--ingest-reads", type=int, default=2_000_000,
        help="reads in the on-disk ingest bench (10_000_000 = config 5)",
    )
    ap.add_argument(
        "--stream-reads", type=int, default=100_000,
        help="reads through the full streaming driver bench",
    )
    ap.add_argument(
        "--only", default=None,
        help=(
            "comma-separated subset: golden,perread_k8,perread_k8_rowsort,"
            "perread_k8_short,contig_k8_32kb,contig_k8_128kb,spectrum_k8,"
            "spectrum_k15,spectrum_k8_sort,spectrum_k9_e2e,"
            "spectrum_k15_sort,sparse_k31,ingest,stream,stream_spectrum"
        ),
    )
    ap.add_argument(
        "--steps", type=int, default=512,
        help="scan steps per device case",
    )
    ap.add_argument(
        "--json-out", default=None,
        help="also write all records to FILE as one JSON document",
    )
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    only = set(args.only.split(",")) if args.only else None

    def want(name):
        return only is None or name in only

    from cfrk_tpu.pipeline.batch import auto_batch_size

    explicit_reads = args.reads
    if args.reads is None:
        args.reads = auto_batch_size(args.read_len)

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(args.reads, args.read_len)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.01] = -1
    x = jnp.asarray(codes)
    bases = args.reads * args.read_len

    # 1. golden: full pipeline on the reconstructed sample, hash-checked.
    if want("golden"):
        from cfrk_tpu.format import format_file_bytes
        from cfrk_tpu.io.fasta import read_fasta_encoded
        from cfrk_tpu.pipeline.count import count_reads

        data_dir = os.path.join(os.path.dirname(__file__), "..", "tests", "data")
        manifest = json.load(open(os.path.join(data_dir, "goldens.json")))
        # config-1 case: the SMALLEST golden sample (read count from the
        # manifest, not filename order — seq2 is 710 reads vs seq1's 7898)
        name, meta = min(
            manifest["files"].items(), key=lambda kv: kv[1]["n_reads"]
        )
        t0 = time.perf_counter()
        reads = read_fasta_encoded(os.path.join(data_dir, name))
        out = format_file_bytes(count_reads(reads, manifest["k"]))
        dt = time.perf_counter() - t0
        ok = hashlib.sha256(out).hexdigest() == meta["sha256"]
        n_bases = sum(len(r) for r in reads)
        _emit("golden_k2_exact", dt, n_bases, "bases/s", {"byte_exact": ok})
        assert ok, "golden mismatch!"

    # ---- device cases: steady-state scan step times.
    steps = args.steps
    n_xs = 4

    def rows_step(k, canonical=False):
        from cfrk_tpu.ops.perread_sparse import count_perread_rows

        def _step(a):
            out = count_perread_rows(a, k, canonical)
            return jnp.sum(out[-1] & 3, dtype=jnp.int32)

        return jax.jit(_step)

    def distinct(n_reads, read_len):
        return jnp.asarray(np.stack([
            rng.integers(0, 4, size=(n_reads, read_len)).astype(np.int8)
            for _ in range(n_xs)
        ]))

    xs = jnp.asarray(
        np.stack([codes] + [
            rng.integers(0, 4, size=codes.shape).astype(np.int8)
            for _ in range(n_xs - 1)
        ])
    )

    def emit_device(name, dt, chk, n_reads, read_len, extra=None):
        rec = {
            "checksum": chk,
            "reads": n_reads,
            "step_ms": round(dt / steps * 1e3, 3),
        }
        if extra:
            rec.update(extra)
        _emit(name, dt, n_reads * read_len * steps, "bases/s", rec)

    if want("perread_k8"):
        from cfrk_tpu.ops.perread import count_perread

        step = jax.jit(
            lambda a: jnp.sum(count_perread(a, 8) & 3, dtype=jnp.int32)
        )
        dt, chk = _scan_case(step, xs, steps)
        emit_device("perread_k8_dense", dt, chk, args.reads, args.read_len)

    if want("perread_k8_rowsort"):
        dt, chk = _scan_case(rows_step(8), xs, steps)
        emit_device("perread_k8_rowsort", dt, chk, args.reads, args.read_len)

    for name, rlen in (
        ("perread_k8_short", 70),
        ("contig_k8_32kb", 32700),
        ("contig_k8_128kb", 131041),
    ):
        if want(name):
            n = explicit_reads or auto_batch_size(rlen)
            dt, chk = _scan_case(rows_step(8), distinct(n, rlen), steps)
            emit_device(name, dt, chk, n, rlen)

    for ks in (8, 15):
        if want(f"spectrum_k{ks}"):
            from cfrk_tpu.ops.spectrum import spectrum

            step = jax.jit(
                lambda a, ks=ks: jnp.sum(spectrum(a, ks) & 3)
            )
            dt, chk = _scan_case(step, xs, steps)
            emit_device(f"spectrum_k{ks}_dense", dt, chk, args.reads,
                        args.read_len)
        if want(f"spectrum_k{ks}_sort"):
            dt, chk = _scan_case(rows_step(ks), xs, steps)
            emit_device(f"spectrum_k{ks}_sort_device", dt, chk, args.reads,
                        args.read_len)

    # The sorted k=9 route END-TO-END: device row-sort pairs + threaded
    # native host fold, overlapped exactly like stream_spectrum_file's
    # drain loop — the device-only number must not stand in for it.
    if want("spectrum_k9_e2e"):
        from cfrk_tpu.ops.perread_sparse import (
            count_perread_rows,
            narrow_for_fetch,
            valid_pair_prefix,
        )
        from cfrk_tpu.ops.sparse import DenseFoldAccumulator

        ks9 = 9
        w9 = args.read_len - ks9 + 1

        @jax.jit
        def pairs_step(a):
            return valid_pair_prefix(
                narrow_for_fetch(count_perread_rows(a, ks9), ks9), w9
            )

        dt_dev, _chk = _scan_case(rows_step(ks9), xs, steps)
        n_loop = 8
        acc = DenseFoldAccumulator(ks9)
        warm = [np.asarray(a) for a in pairs_step(xs[0])]  # compile+warm
        t_fetch = t_fold = 0.0
        pending: list = []

        def drain():
            nonlocal t_fetch, t_fold
            rows = pending.pop(0)
            tf = time.perf_counter()
            arrs = [np.asarray(a) for a in rows]
            t_fetch += time.perf_counter() - tf
            tf = time.perf_counter()
            acc.add_pairs(arrs[0], arrs[1])
            t_fold += time.perf_counter() - tf

        t0 = time.perf_counter()
        for i in range(n_loop):
            pending.append(pairs_step(xs[i % n_xs]))
            if len(pending) > 2:
                drain()
        while pending:
            drain()
        wall = time.perf_counter() - t0
        _emit(
            "spectrum_k9_auto_e2e", wall, n_loop * bases, "bases/s",
            {
                "device_step_ms": round(dt_dev / steps * 1e3, 3),
                "fetch_ms_per_batch": round(t_fetch / n_loop * 1e3, 3),
                "fold_ms_per_batch": round(t_fold / n_loop * 1e3, 3),
                "fetched_mb_per_batch": round(
                    sum(a.nbytes for a in warm) / 1e6, 1
                ),
                "distinct_kmers": int((acc.table > 0).sum()),
            },
        )

    if want("sparse_k31"):
        dt, chk = _scan_case(rows_step(31, canonical=True), xs, steps)
        emit_device("sparse_k31_canonical", dt, chk, args.reads,
                    args.read_len)

    # 5 + 6: on-disk streaming benches share one synthetic FASTA.
    import tempfile

    def synth_fasta(path, n_reads, read_len, seed=0):
        """Write a synthetic FASTA; returns total bases.  Vectorised
        block writes — generating 10M reads takes seconds, not minutes."""
        block = 100_000
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        g = np.random.default_rng(seed)
        total = 0
        with open(path, "wb") as f:
            for start in range(0, n_reads, block):
                n = min(block, n_reads - start)
                seqs = lut[g.integers(0, 4, size=(n, read_len))]
                rows = []
                for i in range(n):
                    rows.append(b">r%d\n" % (start + i))
                    rows.append(seqs[i].tobytes())
                    rows.append(b"\n")
                f.write(b"".join(rows))
                total += n * read_len
        return total

    if want("ingest"):
        from cfrk_tpu.pipeline.stream import stream_batches

        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "ingest.fasta")
            n_bases = synth_fasta(path, args.ingest_reads, args.read_len)
            file_bytes = os.path.getsize(path)
            t0 = time.perf_counter()
            reads = 0
            for b in stream_batches(path, 8, 8192):
                reads += b.n_reads
            dt = time.perf_counter() - t0
            assert reads == args.ingest_reads
            _emit(
                "ingest_stream_batches", dt, file_bytes, "bytes/s",
                {"reads": reads, "mbases_per_s": round(n_bases / dt / 1e6, 1)},
            )

    if want("stream_spectrum"):
        # Global-spectrum streaming at scale, end-to-end: FASTA on disk
        # -> dense k=8 table, device-resident accumulator, ONE ~512 KB
        # fetch at the end.
        from cfrk_tpu.pipeline.stream import stream_spectrum_file
        from cfrk_tpu.runtime.metrics import RunMetrics

        ks = 8
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "spect.fasta")
            n_bases = synth_fasta(path, args.stream_reads, args.read_len)
            # Pre-warm the exact dispatch the stream driver compiles
            # (same shape/dtype/config -> same executable) so the timed
            # region measures steady-state streaming, not the compile.
            from cfrk_tpu.ops.spectrum import spectrum as spectrum_op
            from cfrk_tpu.pipeline.batch import len_bucket

            tw0 = time.perf_counter()
            wlen = len_bucket(args.read_len)  # stream pads to this
            dummy = jnp.zeros((8192, wlen), dtype=jnp.int8)
            np.asarray(spectrum_op(dummy, ks))
            warm_s = time.perf_counter() - tw0
            t0 = time.perf_counter()
            m = RunMetrics(k=ks, mode="spectrum")
            table, m = stream_spectrum_file(
                path, ks, batch_size=8192, metrics=m,
            )
            dt = time.perf_counter() - t0
            _emit(
                f"stream_spectrum_k{ks}", dt, n_bases, "bases/s",
                {
                    "reads": m.reads,
                    "distinct_kmers": int((np.asarray(table) > 0).sum()),
                    "warm_s": round(warm_s, 3),
                    "stages_s": {
                        n: round(t, 3) for n, t in sorted(m.stages.items())
                    },
                },
            )

    if want("stream"):
        # Time-to-exact-.cfrk at scale (BASELINE metric 2).  k=2 is the
        # reference's own at-scale workload (swift/roda.sh: 2.5 GB SRA
        # dataset at k=2; ~40 B/read of output).  A dense k=8 per-read
        # .cfrk is 513 KB/read of text — 51 GB at the default read
        # count — so the k=8 variant uses the --nonzero sparse-row
        # format (~1.3 KB/read), which is what any real k=8 per-read
        # run uses.
        from cfrk_tpu.pipeline.batch import len_bucket
        from cfrk_tpu.pipeline.stream import stream_count_file

        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "stream.fasta")
            n_bases = synth_fasta(path, args.stream_reads, args.read_len)
            wlen = len_bucket(args.read_len)
            dummy = jnp.zeros((8192, wlen), dtype=jnp.int8)
            for tag, ks, nz in [
                ("stream_perread_k2_cfrk", 2, False),
                ("stream_perread_k8_nonzero", 8, True),
            ]:
                # Pre-warm the executable the stream dispatch compiles:
                # both rows go through the row-sorted sparse op
                # (stream_count_file's sparse_rows rule).
                tw0 = time.perf_counter()
                from cfrk_tpu.ops.perread_sparse import (
                    count_perread_rows,
                    narrow_for_fetch,
                )

                for a in narrow_for_fetch(
                    count_perread_rows(dummy, ks, False), ks
                ):
                    np.asarray(a)
                warm_s = time.perf_counter() - tw0
                out = os.path.join(td, f"out_{tag}.cfrk")
                t0 = time.perf_counter()
                m = stream_count_file(
                    path, out, ks, batch_size=8192, nonzero=nz
                )
                dt = time.perf_counter() - t0
                _emit(
                    tag, dt, n_bases, "bases/s",
                    {
                        "reads": m.reads,
                        "warm_s": round(warm_s, 3),
                        "stages_s": {
                            n: round(t, 3) for n, t in sorted(m.stages.items())
                        },
                        "out_bytes": os.path.getsize(out),
                    },
                )
                os.remove(out)

    if args.json_out:
        import datetime

        doc = {
            "platform": jax.default_backend(),
            "device_kind": jax.devices()[0].device_kind,
            "timestamp": datetime.datetime.now(datetime.timezone.utc)
            .strftime("%Y-%m-%dT%H:%M:%SZ"),
            "reads": args.reads,
            "read_len": args.read_len,
            "steps": args.steps,
            "cases": RECORDS,
        }
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"# wrote {args.json_out} ({len(RECORDS)} cases)")


if __name__ == "__main__":
    main()
