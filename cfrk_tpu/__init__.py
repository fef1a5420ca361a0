"""cfrk-tpu: a k-mer counting framework in JAX, run on NVIDIA GPUs.

A from-scratch rebuild of the capabilities of ``hpc-fci-mackenzie/cfrk``
(a CUDA per-read k-mer counter): host-side FASTA ingest and 2-bit
packing, fixed-shape padded batches, XLA scatter-add and row-sort
histogram routes, shard_map scale-out over device meshes, and the exact
``.cfrk`` output format of the reference.

Quick start::

    import cfrk_tpu
    counts = cfrk_tpu.count_file("reads.fasta", k=2)      # [n_reads, 4**k]
    cfrk_tpu.write_cfrk("out.cfrk", counts)

or, CLI-compatible with the reference binary::

    python -m cfrk_tpu reads.fasta out.cfrk 2
"""

from .format import CfrkWriter, format_file_bytes, parse_cfrk
from .io.fasta import encode_seq, iter_fasta, read_fasta, read_fasta_encoded
from .ops.encode import window_components, window_indices
from .ops.perread import count_perread
from .ops.perread_sparse import count_perread_sparse
from .ops.spectrum import spectrum
from .pipeline.batch import ReadBatch, iter_batches, pad_reads
from .pipeline.count import (
    count_file,
    count_file_sparse_rows,
    sparse_spectrum_file,
    spectrum_file,
    write_cfrk,
)
from .pipeline.stream import (
    stream_count_file,
    stream_sparse_spectrum_file,
    stream_spectrum_file,
)
from .runtime import RunMetrics, StreamCheckpoint, run_workflow
from .version import __version__

__all__ = [
    "__version__",
    "CfrkWriter",
    "format_file_bytes",
    "parse_cfrk",
    "encode_seq",
    "iter_fasta",
    "read_fasta",
    "read_fasta_encoded",
    "window_components",
    "window_indices",
    "count_perread",
    "count_perread_sparse",
    "spectrum",
    "ReadBatch",
    "iter_batches",
    "pad_reads",
    "count_file",
    "count_file_sparse_rows",
    "sparse_spectrum_file",
    "spectrum_file",
    "write_cfrk",
    "stream_count_file",
    "stream_sparse_spectrum_file",
    "stream_spectrum_file",
    "RunMetrics",
    "StreamCheckpoint",
    "run_workflow",
]
