"""Multi-host initialisation and host-sharded input planning.

The reference's multi-node story was "run a separate process per FASTA
shard" (reference ``swift/cfrk.swf:14-20``).  Here the equivalent is one
jax process per host (or per card) inside a single SPMD program:

* :func:`maybe_initialize_distributed` wires ``jax.distributed`` from
  the standard coordinator env vars (no-op on a single host / when
  already initialised);
* :func:`host_shard` deals a file list across hosts so per-read mode
  (zero collectives) reads disjoint inputs per host — the Swift/K
  sharding pattern, without the scheduler;
* global-spectrum / sparse modes then merge across hosts through the
  regular mesh collectives (psum / psum_scatter / all_to_all; XLA
  hands them to NCCL).
"""

from __future__ import annotations

import os

__all__ = [
    "maybe_initialize_distributed",
    "host_shard",
    "align_to_record",
    "host_byte_range",
]

_COORD_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)


def maybe_initialize_distributed(force: bool = False) -> bool:
    """Initialise ``jax.distributed`` when a coordinator is configured.

    Returns True if initialisation ran.  Safe to call unconditionally:
    without coordinator env vars (and force=False) it is a no-op, so
    single-host runs need no changes.

    On managed clusters (SLURM, Open MPI) ``initialize()`` auto-detects
    everything.  For manual launches the standard triplet is read from
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` and passed explicitly (jax only auto-detects on
    recognised cluster environments).  When ``LOCAL_RANK`` is set too
    (several processes on one host), process ``LOCAL_RANK`` takes the
    host's card of that index and no other: a JAX process reserves most
    of each card it opens, so two processes must never share one.
    """
    import jax

    if not force and not any(os.environ.get(v) for v in _COORD_VARS):
        return False
    kwargs = {}
    addr = next(
        (os.environ[v] for v in _COORD_VARS if os.environ.get(v)), None
    )
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if addr and nproc is not None and pid is not None:
        kwargs = dict(
            coordinator_address=addr,
            num_processes=int(nproc),
            process_id=int(pid),
        )
    elif addr and (nproc is not None or pid is not None):
        # A partial triplet means a manual launch with a typo'd/missing
        # variable; silently falling through to auto-detect would fail
        # with an unrelated error (or probe cluster envs forever).
        missing = [
            name
            for name, val in (
                ("JAX_NUM_PROCESSES", nproc),
                ("JAX_PROCESS_ID", pid),
            )
            if val is None
        ]
        raise ValueError(
            f"{_COORD_VARS[0]} is set but {' and '.join(missing)} "
            "is missing — a manual multi-process launch needs all of "
            "JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID"
        )
    local_rank = os.environ.get("LOCAL_RANK")
    if local_rank is not None:
        kwargs["local_device_ids"] = [int(local_rank)]
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        msg = str(e)
        if "already initialized" in msg or "only be called once" in msg:
            return False
        raise
    return True


def _input_geometry(path):
    """(total_size, open_at(offset) -> readable) in the coordinate
    system byte ranges use: raw file bytes for plain inputs,
    DECOMPRESSED positions for bgzf (block metadata makes them
    seekable; see io/bgzf.py).  Plain gzip has no random access and is
    rejected by the callers' rangeable checks."""
    from ..io.bgzf import decompressed_size, is_bgzf, open_maybe_bgzf

    if is_bgzf(path):
        size = decompressed_size(path)

        def open_at(offset: int):
            f = open_maybe_bgzf(path)
            f.raw.seek_decompressed(offset)
            return f

        return size, open_at

    def open_at_plain(offset: int):
        f = open(path, "rb")
        f.seek(offset)
        return f

    return os.path.getsize(path), open_at_plain


def align_to_record(path, target: int) -> int:
    """Smallest FASTA record-start offset >= target (plain or bgzf
    files; offsets are decompressed positions for bgzf).

    A record starts at a '>' that begins a line, i.e. at position 0 or
    just after a newline; scanning for b"\\n>" from target-1 finds it.
    Used to split ONE large file into per-host byte ranges that cover
    every record exactly once: host i streams records whose start lies
    in [align(size*i/n), size*(i+1)/n) — no record can start between a
    raw cut and its aligned position, so abutting raw cuts partition
    the record set exactly.
    """
    if target <= 0:
        return 0
    size, open_at = _input_geometry(path)
    if target >= size:
        return size
    pos = target - 1  # include a preceding '\n' at target-1
    with open_at(pos) as f:
        prev = b""
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return size
            buf = prev + chunk
            i = buf.find(b"\n>")
            if i >= 0:
                return pos - len(prev) + i + 1
            pos += len(chunk)
            prev = buf[-1:]


def host_byte_range(
    path, process_index: int | None = None, process_count: int | None = None
) -> tuple[int, int]:
    """This host's (start, limit) byte range of a single shared FASTA.

    ``start`` is record-aligned; ``limit`` is the raw cut — consumers
    stop before the first record STARTING at or past it (the next
    host's aligned start), so ranges partition the records exactly.
    """
    import jax

    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    size, _ = _input_geometry(path)
    start = align_to_record(path, size * pi // pc)
    limit = size * (pi + 1) // pc if pi + 1 < pc else size
    return start, limit


def host_shard(paths: list, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """The subset of ``paths`` this host owns (round-robin deal).

    Per-read counting needs no cross-host data exchange, so each host
    streams only its own files — the multi-host analog of the
    reference's one-process-per-shard layout.
    """
    import jax

    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [p for i, p in enumerate(paths) if i % pc == pi]
