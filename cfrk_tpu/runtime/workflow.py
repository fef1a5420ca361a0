"""Multi-file workflow orchestration — the Swift/K layer.

The reference scaled out by fanning independent `cfrk` processes over
FASTA shards with a Swift/K script (``swift/cfrk.swf:14-20``) configured
for ``maxParallelTasks=2``, ``executionRetries=0``, ``lazyErrors=true``
(``swift/swift.conf:27,137,41``), and measured runs only through Swift's
provenance sqlite (``swift/provenance.sh``, ``swift/query.sh:3`` —
``select script_run_id, duration``).

Here one process owns the accelerator, so file-level parallelism is a
thread pool: device work naturally serialises on the XLA stream while
host parse/format/write of other files overlaps it.  Each task gets
Swift-style retries and lazy-error semantics, and every attempt is
appended to a JSONL provenance log with its duration — the sqlite
analog, queryable via :func:`query_provenance`.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

__all__ = [
    "WorkflowTask",
    "WorkflowResult",
    "run_workflow",
    "query_provenance",
]


@dataclasses.dataclass
class WorkflowTask:
    """One input→output unit (a Swift/K ``app CFRK`` invocation analog)."""

    input: str
    output: str
    ok: bool = False
    attempts: int = 0
    duration_s: float = 0.0
    reads: int = 0
    error: str | None = None


@dataclasses.dataclass
class WorkflowResult:
    tasks: list
    wall_s: float

    @property
    def ok(self) -> bool:
        return all(t.ok for t in self.tasks)

    @property
    def failed(self) -> list:
        return [t for t in self.tasks if not t.ok]


class _Provenance:
    """Append-only JSONL provenance log (thread-safe)."""

    def __init__(self, path: str | None):
        self._path = path
        self._lock = threading.Lock()

    def record(self, task: WorkflowTask, attempt: int, ok: bool,
               duration_s: float, error: str | None) -> None:
        if not self._path:
            return
        line = json.dumps({
            "ts": time.time(),
            "input": task.input,
            "output": task.output,
            "attempt": attempt,
            "ok": ok,
            "duration_s": round(duration_s, 4),
            "error": error,
        })
        with self._lock:
            with open(self._path, "a") as f:
                f.write(line + "\n")


def query_provenance(path: str) -> list[dict]:
    """All recorded attempts with durations (``swift/query.sh:3`` analog)."""
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out


def run_workflow(
    pairs: list[tuple[str, str]],
    count_one,
    *,
    max_parallel_tasks: int = 2,
    retries: int = 0,
    lazy_errors: bool = True,
    provenance_path: str | None = None,
) -> WorkflowResult:
    """Run ``count_one(input, output) -> n_reads`` over many file pairs.

    max_parallel_tasks: concurrent tasks (Swift/K ``maxParallelTasks``).
    retries:            re-attempts per failed task (``executionRetries``).
    lazy_errors:        keep going after failures, report at the end
                        (``lazyErrors``); False raises on first failure.
    provenance_path:    JSONL log of every attempt with duration.
    """
    prov = _Provenance(provenance_path)
    tasks = [WorkflowTask(input=str(i), output=str(o)) for i, o in pairs]
    t_start = time.perf_counter()
    abort = threading.Event()

    # Elastic recovery: a count_one that accepts ``retrying`` (like
    # count_one_factory's) is told when an attempt is a re-run, so a
    # crashed STREAMING task resumes from its surviving checkpoint
    # instead of redoing the whole file.  Plain 2-arg callables keep
    # Swift/K's restart-from-scratch semantics.
    import inspect

    try:
        accepts_retrying = "retrying" in inspect.signature(count_one).parameters
    except (TypeError, ValueError):  # builtins / C callables
        accepts_retrying = False

    def run_task(task: WorkflowTask) -> None:
        for attempt in range(retries + 1):
            if abort.is_set():
                # Never clobber a real traceback from an earlier attempt.
                if task.error is None:
                    task.error = "aborted"
                return
            task.attempts = attempt + 1
            t0 = time.perf_counter()
            try:
                kw = {"retrying": attempt > 0} if accepts_retrying else {}
                task.reads = int(count_one(task.input, task.output, **kw) or 0)
                task.duration_s = time.perf_counter() - t0
                task.ok = True
                prov.record(task, attempt, True, task.duration_s, None)
                return
            except Exception:
                dt = time.perf_counter() - t0
                task.duration_s = dt
                task.error = traceback.format_exc(limit=8)
                prov.record(task, attempt, False, dt, task.error)
        if not lazy_errors:
            abort.set()

    with ThreadPoolExecutor(max_workers=max(1, max_parallel_tasks)) as ex:
        list(ex.map(run_task, tasks))

    result = WorkflowResult(tasks=tasks, wall_s=time.perf_counter() - t_start)
    if not lazy_errors and not result.ok:
        # Report a task with a REAL traceback, not an aborted placeholder.
        first = next(
            (t for t in result.failed if t.error and t.error != "aborted"),
            result.failed[0],
        )
        raise RuntimeError(
            f"workflow task failed ({first.input}):\n{first.error}"
        )
    return result


def count_one_factory(
    k: int,
    *,
    mode: str = "perread",
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int = 8192,
    stream: bool = False,
    spectrum_format: str = "cfrk",
    max_len: int | None = None,
    nonzero: bool = False,
    resume: bool = False,
    checkpoint_every: int | None = None,
    min_count: int = 1,
    mesh=None,
    seqpar: bool = False,
    slack: float = 2.0,
    min_qual: int = 0,
):
    """Build a ``count_one(input, output)`` callable for :func:`run_workflow`
    from CLI-level options (shared by the CLI and programmatic users).
    Every per-file option of the single-input CLI path is honoured here,
    so multi-file runs behave identically per file."""

    def count_one(inp: str, out: str, retrying: bool = False) -> int:
        # A retry after a mid-stream crash resumes from the surviving
        # checkpoint (run_workflow sets retrying=True on re-attempts);
        # a stale/mismatched checkpoint falls back to a fresh start.
        res = resume or retrying
        if mode == "perread":
            if stream:
                from ..pipeline.stream import stream_count_file

                m = stream_count_file(
                    inp, out, k, canonical=canonical, impl=impl,
                    batch_size=batch_size, nonzero=nonzero,
                    resume=res, checkpoint_every=checkpoint_every or 1,
                    mesh=mesh, seqpar=seqpar, min_qual=min_qual,
                )
                return m.reads
            if k > 8 and not nonzero:
                raise ValueError(
                    f"per-read k={k} > 8 requires nonzero=True"
                )
            # Same sparse-rows routing rule as cli._run_inputs and
            # stream_count_file: rows ship as pairs, not the dense
            # matrix, whenever the kernel choice is ours (dense output
            # densifies inside the native formatter's bin walk).
            if (nonzero and k > 8) or (impl == "auto" and not seqpar):
                if seqpar:
                    # Same refusal as cli._run_inputs — silently dropping
                    # seqpar would break "multi-file runs behave
                    # identically per file".
                    raise ValueError(
                        "seqpar does not compose with per-read k > 8 "
                        "(per-row sort needs the whole row on one device)"
                    )
                from ..pipeline.count import count_file_sparse_rows

                return count_file_sparse_rows(
                    inp, out, k, canonical=canonical,
                    batch_size=batch_size, max_len=max_len,
                    mesh=mesh, min_qual=min_qual, nonzero=nonzero,
                )
            from ..format import CfrkWriter
            from ..pipeline.count import count_file

            counts = count_file(
                inp, k, canonical=canonical, impl=impl,
                batch_size=batch_size, max_len=max_len,
                mesh=mesh, seqpar=seqpar, min_qual=min_qual,
            )
            with CfrkWriter(out, nonzero=nonzero) as w:
                w.write_batch(counts)
            return counts.shape[0]
        if mode == "sparse":

            if stream:
                from ..pipeline.stream import stream_sparse_spectrum_file

                # cleanup=False: the resume checkpoint must survive until
                # the REAL output file below exists — a crash during the
                # output write would otherwise lose all streaming
                # progress (same ordering as cli._run_inputs).
                keys, cnts, m = stream_sparse_spectrum_file(
                    inp, k, canonical=canonical, batch_size=batch_size,
                    out_path=out, resume=res,
                    checkpoint_every=checkpoint_every or 64,
                    cleanup=False, mesh=mesh, slack=slack,
                    min_qual=min_qual, seqpar=seqpar,
                )
                n = m.reads
            else:
                from ..pipeline.count import sparse_spectrum_file

                table = sparse_spectrum_file(
                    inp, k, canonical=canonical, batch_size=batch_size,
                    max_len=max_len, mesh=mesh, slack=slack,
                    min_qual=min_qual, seqpar=seqpar,
                )
                n = 0
                keys = sorted(table)
                cnts = [table[key] for key in keys]
            from ..cli import _write_sparse

            _write_sparse(out, keys, cnts, k, spectrum_format, min_count)
            if stream:
                from .checkpoint import cleanup_checkpoint

                cleanup_checkpoint(out)
            return n
        # spectrum
        if stream:
            from ..pipeline.stream import stream_spectrum_file

            # cleanup=False + cleanup_checkpoint(out) after the write,
            # as above: keep resume progress until the output exists.
            table, m = stream_spectrum_file(
                inp, k, canonical=canonical, impl=impl,
                batch_size=batch_size, out_path=out, resume=res,
                checkpoint_every=checkpoint_every or 16,
                cleanup=False, mesh=mesh, seqpar=seqpar,
                min_qual=min_qual,
            )
            n = m.reads
        else:
            from ..pipeline.count import spectrum_file

            table = spectrum_file(
                inp, k, canonical=canonical, impl=impl,
                batch_size=batch_size, max_len=max_len,
                mesh=mesh, seqpar=seqpar, min_qual=min_qual,
            )
            n = 0
        from ..cli import _write_spectrum

        _write_spectrum(out, table, spectrum_format, min_count)
        if stream:
            from .checkpoint import cleanup_checkpoint

            cleanup_checkpoint(out)
        return n

    return count_one
