"""Smoke tests for the tools/ scripts (subprocess, tiny sizes, CPU)."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"


def _run(args, timeout=240):
    return subprocess.run(
        [sys.executable] + args,
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=timeout,
        check=True,
    )


def test_make_synthetic_and_count(tmp_path):
    out = tmp_path / "syn.fasta.gz"
    r = _run(
        [str(TOOLS / "make_synthetic.py"), str(out), "--reads", "50",
         "--read-len", "80", "--gzip", "--seed", "3"]
    )
    assert "wrote 50 reads" in r.stderr
    from cfrk_tpu.io.fasta import read_fasta_encoded

    reads = read_fasta_encoded(out)
    assert len(reads) == 50
    assert all(len(x) == 80 for x in reads)


def test_make_synthetic_fastq(tmp_path):
    out = tmp_path / "syn.fastq"
    _run(
        [str(TOOLS / "make_synthetic.py"), str(out), "--reads", "10",
         "--fastq", "--read-len", "60"]
    )
    from cfrk_tpu.io.fasta import iter_fastq

    recs = list(iter_fastq(out))
    assert len(recs) == 10
    assert all(len(s) == 60 for _, s in recs)


def test_scaling_bench_cpu():
    r = _run(
        [str(TOOLS / "scaling_bench.py"), "--cpu", "--k", "3",
         "--reads-per-device", "64", "--steps", "1"],
        timeout=300,
    )
    lines = [json.loads(x) for x in r.stdout.strip().splitlines()]
    assert [d["devices"] for d in lines] == [1, 2, 4, 8]
    assert all(d["reads_per_s"] > 0 for d in lines)
    # Same data sharded differently must give the same checksum per read
    # count ratio (weak scaling doubles reads with devices).
    assert lines[1]["reads"] == 2 * lines[0]["reads"]


def test_bench_suite_cpu_golden_only():
    r = _run(
        [str(TOOLS / "bench_suite.py"), "--cpu", "--reads", "64",
         "--only", "golden,sparse_k31"],
        timeout=300,
    )
    lines = [json.loads(x) for x in r.stdout.strip().splitlines()]
    names = [d["bench"] for d in lines]
    assert names == ["golden_k2_exact", "sparse_k31_canonical"]
    assert lines[0]["byte_exact"] is True


def test_diff_cfrk(tmp_path):
    import numpy as np

    from cfrk_tpu.format import CfrkWriter

    counts = np.array([[0, 2, 0, 1], [3, 0, 0, 0]], dtype=np.int32)
    a = tmp_path / "a.cfrk"
    b = tmp_path / "b.cfrk"  # same counts, nonzero format
    c = tmp_path / "c.cfrk"  # different counts
    with CfrkWriter(str(a)) as w:
        w.write_batch(counts)
    with CfrkWriter(str(b), nonzero=True) as w:
        w.write_batch(counts)
    with CfrkWriter(str(c)) as w:
        w.write_batch(counts + np.array([[0, 0, 0, 1], [0, 0, 0, 0]]))

    def run(*args):
        r = subprocess.run(
            [sys.executable, str(TOOLS / "diff_cfrk.py"), *args],
            capture_output=True, text=True, cwd=REPO,
        )
        return r.returncode, r.stdout.strip()

    assert run(str(a), str(a)) == (0, "byte-identical")
    rc, msg = run(str(a), str(b))
    assert rc == 1  # formats differ byte-wise
    assert run(str(a), str(b), "--semantic") == (0, "semantically equal (2 reads)")
    rc, msg = run(str(a), str(c), "--semantic")
    assert rc == 1 and "1/2 reads differ" in msg


def test_merge_outputs_perread(tmp_path):
    """Splicing .cfrk parts reproduces the single-run bytes exactly."""
    import numpy as np

    from cfrk_tpu.format import format_file_bytes, parse_cfrk

    rng = np.random.default_rng(0)
    a = rng.integers(0, 9, size=(3, 16)).astype(np.int32)
    b = rng.integers(0, 9, size=(2, 16)).astype(np.int32)
    pa, pb = tmp_path / "a.cfrk", tmp_path / "b.cfrk"
    pa.write_bytes(format_file_bytes(a))
    pb.write_bytes(format_file_bytes(b))
    out = tmp_path / "all.cfrk"
    _run([str(TOOLS / "merge_outputs.py"), "--mode", "perread",
          "-o", str(out), str(pa), str(pb)])
    assert out.read_bytes() == format_file_bytes(np.concatenate([a, b]))
    assert parse_cfrk(out.read_bytes()).shape == (5, 16)


def test_merge_outputs_spectrum_npy_tsv(tmp_path):
    import numpy as np

    t1 = np.array([0, 5, 0, 2], dtype=np.int64)
    t2 = np.array([1, 0, 0, 7], dtype=np.int64)
    for fmt, write in [
        ("npy", lambda p, t: np.save(open(p, "wb"), t)),
        ("tsv", lambda p, t: open(p, "w").write(
            "".join(f"{i}\t{int(v)}\n" for i, v in enumerate(t) if v))),
    ]:
        ps = []
        for name, t in [("p1", t1), ("p2", t2)]:
            p = tmp_path / f"{name}.{fmt}"
            write(str(p), t)
            ps.append(str(p))
        out = tmp_path / f"all.{fmt}"
        _run([str(TOOLS / "merge_outputs.py"), "--mode", "spectrum",
              "--format", fmt, "-o", str(out)] + ps)
        if fmt == "npy":
            got = np.load(out)
            assert np.array_equal(got, t1 + t2)
        else:
            lines = out.read_text().strip().splitlines()
            got = {int(l.split("\t")[0]): int(l.split("\t")[1]) for l in lines}
            want = {i: int(v) for i, v in enumerate(t1 + t2) if v}
            assert got == want


def test_merge_outputs_sparse_streaming(tmp_path):
    from cfrk_tpu.ops.sparse import decode_key

    # overlapping sorted k-mer TSVs; counts must sum per k-mer
    k = 5
    rows1 = {decode_key(c, k): n for c, n in [(3, 2), (9, 1), (40, 5)]}
    rows2 = {decode_key(c, k): n for c, n in [(9, 4), (40, 1), (99, 7)]}
    ps = []
    for name, rows in [("s1", rows1), ("s2", rows2)]:
        p = tmp_path / f"{name}.kmers.tsv"
        p.write_text("".join(f"{km}\t{n}\n" for km, n in sorted(rows.items())))
        ps.append(str(p))
    out = tmp_path / "all.kmers.tsv"
    _run([str(TOOLS / "merge_outputs.py"), "--mode", "sparse",
          "-o", str(out)] + ps)
    got = dict(
        line.split("\t") for line in out.read_text().strip().splitlines()
    )
    want = {km: str(rows1.get(km, 0) + rows2.get(km, 0))
            for km in set(rows1) | set(rows2)}
    assert got == want
    assert list(got) == sorted(got)  # still in key order


def test_merge_sorted_key_counts():
    import numpy as np

    from cfrk_tpu.ops.sparse import merge_sorted_key_counts

    k1 = np.array([1, 5, 9], dtype=np.uint64)
    c1 = np.array([2, 3, 4], dtype=np.int64)
    k2 = np.array([5, 9, 12], dtype=np.uint64)
    c2 = np.array([10, 1, 1], dtype=np.int64)
    keys, cnts = merge_sorted_key_counts([(k1, c1), (k2, c2)])
    assert keys.tolist() == [1, 5, 9, 12]
    assert cnts.tolist() == [2, 13, 5, 1]
    keys, cnts = merge_sorted_key_counts([])
    assert len(keys) == 0 and len(cnts) == 0


def test_merge_outputs_sparse_gzip(tmp_path):
    """Gzipped sparse shard outputs merge transparently, gz in + gz out."""
    import gzip

    p1 = tmp_path / "s1.kmers.tsv.gz"
    p2 = tmp_path / "s2.kmers.tsv"
    with gzip.open(p1, "wt") as f:
        f.write("AAACA\t2\nAAGTT\t1\n")
    p2.write_text("AAACA\t3\nCCCCC\t4\n")
    out = tmp_path / "all.kmers.tsv.gz"
    _run([str(TOOLS / "merge_outputs.py"), "--mode", "sparse",
          "-o", str(out), str(p1), str(p2)])
    with gzip.open(out, "rt") as f:
        got = dict(line.split("\t") for line in f.read().strip().splitlines())
    assert got == {"AAACA": "5", "AAGTT": "1", "CCCCC": "4"}


def test_query_spectrum_dense_npy(tmp_path):
    import numpy as np

    dense = np.zeros(256, dtype=np.int64)  # k=4
    dense[0] = 7      # AAAA
    dense[27] = 3     # 27 = 0b_00_01_10_11 -> ACGT
    dense[255] = 11   # TTTT
    p = tmp_path / "spect.npy"
    np.save(open(p, "wb"), dense)
    import subprocess

    try:  # AAAC is absent -> exit 1 (presence-gate contract), output intact
        r = _run([str(TOOLS / "query_spectrum.py"), str(p), "--stats",
                  "--top", "2", "--k", "4", "ACGT", "AAAC"])
        raise AssertionError("expected exit 1 for a missing k-mer")
    except subprocess.CalledProcessError as e:
        assert e.returncode == 1
        r = e
    lines = r.stdout.strip().splitlines()
    assert "distinct\t3" in lines and "total\t21" in lines
    assert "max\t11\tTTTT" in lines and "unique\t0" in lines
    top = [l for l in lines if l.split("\t")[0] in ("TTTT", "AAAA")]
    assert top == ["TTTT\t11", "AAAA\t7"]  # descending
    assert "ACGT\t3" in lines and "AAAC\t0" in lines


def test_query_spectrum_sparse_tsv_gz(tmp_path):
    import gzip

    p = tmp_path / "out.kmers.tsv.gz"
    with gzip.open(p, "wt") as f:
        f.write("AACGT\t4\nGGGGG\t2\n")
    import subprocess

    try:  # CCCCC is absent -> exit 1, both lookups still printed
        _run([str(TOOLS / "query_spectrum.py"), str(p), "GGGGG", "CCCCC"])
        raise AssertionError("expected exit 1 for a missing k-mer")
    except subprocess.CalledProcessError as e:
        assert e.returncode == 1
        assert e.stdout.splitlines() == ["GGGGG\t2", "CCCCC\t0"]
    # k inferred from the strings: wrong-length query is an error
    try:
        _run([str(TOOLS / "query_spectrum.py"), str(p), "AAAA"])
        raise AssertionError("expected nonzero exit")
    except subprocess.CalledProcessError as e:
        assert "length 4" in e.stderr


def test_query_spectrum_hist(tmp_path):
    import numpy as np

    dense = np.zeros(256, dtype=np.int64)  # k=4
    dense[[0, 1, 2]] = 1     # three singletons
    dense[[10, 11]] = 4      # two k-mers seen 4x
    dense[20] = 250          # clipped into the MAX+ bucket
    p = tmp_path / "spect.npy"
    np.save(open(p, "wb"), dense)
    r = _run([str(TOOLS / "query_spectrum.py"), str(p), "--hist", "100"])
    assert r.stdout.splitlines() == ["1\t3", "4\t2", "100+\t1"]
    # default MAX via bare --hist (const=100): same table
    r = _run([str(TOOLS / "query_spectrum.py"), str(p), "--hist"])
    assert r.stdout.splitlines() == ["1\t3", "4\t2", "100+\t1"]


def test_query_spectrum_index_tsv_and_cfrk(tmp_path):
    import numpy as np

    from cfrk_tpu.format import format_file_bytes

    p = tmp_path / "spect.tsv"
    p.write_text("1\t5\n100\t2\n")  # index-keyed (digit first char)
    r = _run([str(TOOLS / "query_spectrum.py"), str(p), "--stats"])
    assert "distinct\t2" in r.stdout and "total\t7" in r.stdout
    dense = np.zeros((1, 16), dtype=np.int64)
    dense[0, 5] = 9
    pc = tmp_path / "spect.cfrk"
    pc.write_bytes(format_file_bytes(dense))
    r = _run([str(TOOLS / "query_spectrum.py"), str(pc), "--k", "2", "CC"])
    assert r.stdout.strip() == "CC\t9"

