"""Independent ground truth ABOVE k=2 (VERDICT r4 #8).

The reference's goldens pin k=2 only (reference ``test/test.sh:13,17``);
everything above rests on this repo's own oracles, which all share the
``window_indices`` / ``kmer_keys`` lineage.  These tests derive counts a
THIRD way, from raw sequence STRINGS with a pure-Python dict counter
that imports nothing from ``cfrk_tpu.ops``:

* windows are string slices; validity is alphabet membership;
* the numeric code is ``int(window.translate(ACGT->0123), 4)``;
* canonical uses min(w, revcomp(w)) — string order equals numeric
  order because A<C<G<T alphabetically.

Inputs are the reconstructed reference FASTAs (real golden-consistent
data, tests/data/), sampled rows at k=8 and k=31 so the whole check
stays in milliseconds.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

DATA = os.path.join(os.path.dirname(__file__), "data")
_COMP = str.maketrans("ACGT", "TGCA")
_DIGITS = str.maketrans("ACGT", "0123")


def _read_fasta_strings(path):
    """Raw parse: headers stripped, multi-line sequences concatenated.
    Deliberately NOT cfrk_tpu.io — the oracle must share nothing."""
    with gzip.open(path, "rt") as f:
        text = f.read()
    seqs = []
    for block in text.split(">")[1:]:
        lines = block.splitlines()
        seqs.append("".join(lines[1:]).upper())
    return seqs


def _string_counts(seq: str, k: int, canonical: bool = False) -> dict:
    """{numeric_code: count} of one sequence, by string slicing alone."""
    out: dict = {}
    for i in range(len(seq) - k + 1):
        w = seq[i : i + k]
        if any(c not in "ACGT" for c in w):
            continue
        if canonical:
            rc = w.translate(_COMP)[::-1]
            if rc < w:
                w = rc
        code = int(w.translate(_DIGITS), 4)
        out[code] = out.get(code, 0) + 1
    return out


def _encode(seq: str) -> np.ndarray:
    # The system-under-test side may use package encoding; only the
    # ORACLE must stay independent.
    from cfrk_tpu.io.fasta import encode_seq

    return encode_seq(seq.encode())


def test_perread_k8_matches_string_oracle():
    seqs = _read_fasta_strings(os.path.join(DATA, "seq1.fasta.gz"))
    sample = seqs[:5] + seqs[1000:1005] + seqs[-5:]
    from cfrk_tpu.pipeline.count import count_reads

    counts = count_reads([_encode(s) for s in sample], 8)
    for row, seq in zip(counts, sample):
        want = _string_counts(seq, 8)
        (nz,) = np.nonzero(row)
        got = {int(i): int(row[i]) for i in nz}
        assert got == want


def test_perread_rows_k8_pairs_match_string_oracle():
    """The pairs route (what .cfrk output actually consumes)."""
    seqs = _read_fasta_strings(os.path.join(DATA, "seq2.fasta.gz"))
    sample = seqs[:8] + seqs[350:358]
    from cfrk_tpu.ops.perread_sparse import count_perread_rows, pairs_to_host
    from cfrk_tpu.pipeline.batch import pad_reads

    batch = pad_reads([_encode(s) for s in sample], len(sample), 384)
    idx, cnt = pairs_to_host(
        count_perread_rows(np.asarray(batch.codes), 8), len(sample)
    )
    for r, seq in enumerate(sample):
        m = cnt[r] > 0
        got = dict(zip(idx[r][m].tolist(), cnt[r][m].tolist()))
        assert got == _string_counts(seq, 8)


def test_sparse_k31_canonical_matches_string_oracle():
    seqs = _read_fasta_strings(os.path.join(DATA, "seq1.fasta.gz"))
    sample = seqs[2000:2030]
    want: dict = {}
    for s in sample:
        for code, c in _string_counts(s, 31, canonical=True).items():
            want[code] = want.get(code, 0) + c

    from cfrk_tpu.ops.sparse import SparseAccumulator, rows_to_triples
    from cfrk_tpu.ops.perread_sparse import count_perread_rows
    from cfrk_tpu.pipeline.batch import pad_reads

    batch = pad_reads([_encode(s) for s in sample], len(sample), 384)
    acc = SparseAccumulator()
    acc.add(*rows_to_triples(
        count_perread_rows(np.asarray(batch.codes), 31, True), 31
    ))
    keys, cnts = acc.result_arrays()
    got = dict(zip(keys.tolist(), cnts.tolist()))
    assert got == want


def test_spectrum_k9_matches_string_oracle():
    """k=9: the first k past the dense per-read range."""
    seqs = _read_fasta_strings(os.path.join(DATA, "seq2.fasta.gz"))
    sample = seqs[:64]
    want: dict = {}
    for s in sample:
        for code, c in _string_counts(s, 9).items():
            want[code] = want.get(code, 0) + c

    from cfrk_tpu.pipeline.count import spectrum_file  # noqa: F401
    from cfrk_tpu.ops.spectrum import spectrum
    from cfrk_tpu.pipeline.batch import pad_reads

    batch = pad_reads([_encode(s) for s in sample], len(sample), 384)
    table = np.asarray(spectrum(np.asarray(batch.codes), 9))
    (nz,) = np.nonzero(table)
    got = {int(i): int(table[i]) for i in nz}
    assert got == want
