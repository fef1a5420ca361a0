"""Generate synthetic metagenome-like FASTA/FASTQ for benchmarks and demos.

The reference was exercised on a 2.5 GB SRA metagenome split into shards
(reference ``swift/roda.sh:3``); that dataset is not redistributable, so
streaming-scale runs (BASELINE.json config 5) use synthetic read sets:
reads are sampled from a small set of random "genomes" with mutations
and a configurable N rate, which produces realistic repeated-k-mer
structure (unlike iid bases).

Usage:
    python tools/make_synthetic.py out.fasta --reads 1000000 \
        --read-len 150 [--genomes 8] [--n-rate 0.002] [--fastq] [--gzip]
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--genomes", type=int, default=8)
    ap.add_argument("--genome-len", type=int, default=100_000)
    ap.add_argument("--mut-rate", type=float, default=0.01)
    ap.add_argument("--n-rate", type=float, default=0.002)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fastq", action="store_true")
    ap.add_argument("--gzip", action="store_true")
    ap.add_argument(
        "--bgzf", action="store_true",
        help="blocked gzip (bgzip framing): cfrk-tpu inflates bgzf "
             "blocks in parallel, plain --gzip single-threaded",
    )
    args = ap.parse_args()
    if args.bgzf and args.gzip:
        raise SystemExit("--bgzf and --gzip are mutually exclusive")

    rng = np.random.default_rng(args.seed)
    genomes = [
        rng.integers(0, 4, size=args.genome_len).astype(np.uint8)
        for _ in range(args.genomes)
    ]

    if args.read_len > args.genome_len:
        raise SystemExit(
            f"--read-len {args.read_len} exceeds --genome-len "
            f"{args.genome_len}: reads are sampled as genome windows"
        )
    if args.bgzf:
        from cfrk_tpu.io.bgzf import write_bgzf

        class _BgzfSink:
            """Buffer record text and emit whole bgzf blocks."""

            def __init__(self, path):
                self._f = open(path, "wb")
                self._buf = bytearray()

            def write(self, b):
                self._buf += b
                while len(self._buf) >= (1 << 20):
                    head = bytes(self._buf[: 1 << 20])
                    del self._buf[: 1 << 20]
                    self._write_blocks(head, final=False)

            def _write_blocks(self, data, final):
                import io as _io

                sink = _io.BytesIO()
                write_bgzf(sink, data)
                raw = sink.getvalue()
                if not final:
                    raw = raw[: -28]  # strip the EOF marker between flushes
                self._f.write(raw)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self._write_blocks(bytes(self._buf), final=True)
                self._f.close()

        opener = lambda path, mode: _BgzfSink(path)  # noqa: E731
    else:
        opener = gzip.open if args.gzip else open
    chunk = 10_000
    written = 0
    stacked = np.stack(genomes)
    offs = np.arange(args.read_len)
    with opener(args.out, "wb") as f:
        while written < args.reads:
            n = min(chunk, args.reads - written)
            gi = rng.integers(0, args.genomes, size=n)
            # +1: the final window genome[len-read_len:] is a valid start
            # (and read_len == genome_len must not raise).
            starts = rng.integers(
                0, args.genome_len - args.read_len + 1, size=n
            )
            reads = stacked[gi[:, None], starts[:, None] + offs]
            mut = rng.random(reads.shape) < args.mut_rate
            reads[mut] = rng.integers(0, 4, size=int(mut.sum()))
            seqs = BASES[reads]
            if args.n_rate > 0:
                seqs[rng.random(reads.shape) < args.n_rate] = ord("N")
            if args.fastq:
                qual = b"I" * args.read_len
                lines = [
                    b"@r%d\n%s\n+\n%s\n" % (written + j, row.tobytes(), qual)
                    for j, row in enumerate(seqs)
                ]
            else:
                lines = [
                    b">r%d\n%s\n" % (written + j, row.tobytes())
                    for j, row in enumerate(seqs)
                ]
            f.write(b"".join(lines))
            written += n
    print(f"wrote {written} reads to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
