"""Device mesh construction for multi-chip / multi-host runs.

The reference's only scale-out was one OS process per FASTA shard via a
Swift/K workflow (reference ``swift/cfrk.swf:14-20``) — zero inter-process
communication.  The replacement here is a single SPMD program over a
``jax.sharding.Mesh``; XLA lowers its collectives to NCCL, over NVLink
within a host and the network across hosts.

Axes:

* ``dp`` — data parallel over reads.  Per-read counting needs ZERO
  communication on this axis (mirrors the reference's shard model).
* ``tp`` — table parallel over the 4**k spectrum bins.  Global spectra
  are reduce-scattered over ``tp`` so each device holds 4**k / tp bins.

Sequence parallelism over very long reads (contigs) uses its own 1-D mesh
(see ``seqpar.py``).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "DP_AXIS", "TP_AXIS", "batch_sharding", "table_sharding"]

DP_AXIS = "dp"
TP_AXIS = "tp"


def make_mesh(
    devices=None,
    *,
    tp: int = 1,
) -> Mesh:
    """Build a (dp, tp) mesh over the given (default: all) devices.

    ``tp`` is the table-parallel degree; dp = n_devices // tp.  With the
    default tp=1 everything is pure data parallelism, which is the
    zero-communication mode matching the reference's per-shard layout.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    arr = np.asarray(devices).reshape(n // tp, tp)
    return Mesh(arr, (DP_AXIS, TP_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a [B, L] code batch: rows over BOTH mesh axes.

    Reads are embarrassingly parallel, so every device — including the
    tp columns — takes a distinct row slice; no device does redundant
    ingest work.  B must be divisible by dp * tp.
    """
    return NamedSharding(mesh, P((DP_AXIS, TP_AXIS), None))


def table_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a [4**k] spectrum table: bins over tp."""
    return NamedSharding(mesh, P(TP_AXIS))
