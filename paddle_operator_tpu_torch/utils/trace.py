"""Tracing and profiling of the port: its copy of
``paddle_operator_tpu/utils/trace.py``, with the device profiler on
``torch.profiler``.

* :class:`SpanContext` and the process's incident context
  (:func:`set_incident_context`): the operator mints a context at an
  incident and hands it to the pod as ``TPUJOB_TRACE_CONTEXT``; the
  runner adopts it, and every trace record it emits until its first good
  step carries ``incident=<id>``. The encoding is the reference's, so
  either package decodes the other's.
* :class:`Tracer`: spans and events as JSON lines (``{"name", "t0",
  "m0", "dur_ms", "depth", "attrs"}``, after one ``clock_anchor``
  record), rotated by size, with an in-memory ring (:attr:`Tracer.events`).
  Off (no file) it costs one attribute test. :func:`tracer` is the
  process's, from ``TPUJOB_TRACE_FILE``; in a world of several workers
  on one host each writes its own file (:func:`worker_trace_path`).
* :class:`StageTimes`: per-stage host seconds of the input pipeline and
  the loop.
* :class:`profile_steps`: a ``torch.profiler`` window over training
  steps, from ``TPUJOB_PROFILE_DIR`` and ``TPUJOB_PROFILE_STEPS``
  (``start:stop``, default ``10:13``), with CPU and CUDA activities,
  written as a Chrome trace into the directory.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

log = logging.getLogger("tpujob.trace")

_local = threading.local()


@dataclass(frozen=True)
class SpanContext:
    """Cross-process incident span context: ``v1;<incident_id>;<cause>;
    <namespace>/<name>``, carried operator -> runner by the pod's
    ``TPUJOB_TRACE_CONTEXT``. Every trace record a process emits while
    the incident is live carries ``incident=<incident_id>``, so the
    per-process JSONL files rebuild one causal tree offline."""

    incident_id: str
    cause: str = ""
    job: str = ""  # "namespace/name": the owning TpuJob

    def encode(self) -> str:
        return "v1;%s;%s;%s" % (self.incident_id, self.cause, self.job)

    @classmethod
    def decode(cls, text: Optional[str]) -> Optional["SpanContext"]:
        """Parse an encoded context; None for anything unparseable (a
        mangled annotation degrades to uncorrelated tracing)."""
        if not text:
            return None
        parts = text.split(";")
        if len(parts) != 4 or parts[0] != "v1" or not parts[1]:
            return None
        return cls(incident_id=parts[1], cause=parts[2], job=parts[3])


# The process's incident context: the runner adopts the operator's from
# its environment, and every trace record until the first good step after
# the recovery is stamped with it.
_ambient_lock = threading.Lock()
_ambient_ctx: Optional[SpanContext] = None


def set_incident_context(ctx: Optional[SpanContext]) -> None:
    global _ambient_ctx
    with _ambient_lock:
        _ambient_ctx = ctx


def clear_incident_context() -> None:
    set_incident_context(None)


def current_incident_context() -> Optional[SpanContext]:
    with _ambient_lock:
        return _ambient_ctx


class _Span:
    """Attribute bag yielded by :meth:`Tracer.span`: a caller can attach
    what it learns mid-span before the record is written."""

    __slots__ = ("attrs",)

    def __init__(self, attrs: Dict[str, Any]) -> None:
        self.attrs = attrs

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)


class _NullSpan:
    """The span of a disabled tracer: ``set`` does nothing."""

    __slots__ = ()

    def set(self, **attrs: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Structured span recorder: JSON lines, thread-safe, cheap when off.

    The file rotates by size: past ``max_bytes`` (``TPUJOB_TRACE_MAX_MB``;
    0 or unset: never) it is renamed to ``<path>.1`` (older segments
    shifting to ``.2`` ... ``.keep``, the oldest dropped) and a fresh file
    starts with its own clock anchor."""

    def __init__(self, path: str = "", enabled: Optional[bool] = None,
                 max_bytes: Optional[int] = None,
                 keep: Optional[int] = None) -> None:
        self.path = path or os.environ.get("TPUJOB_TRACE_FILE", "")
        self.enabled = bool(self.path) if enabled is None else enabled
        if max_bytes is None:
            try:
                max_bytes = int(float(os.environ.get(
                    "TPUJOB_TRACE_MAX_MB", "0")) * 1024 * 1024)
            except ValueError:
                max_bytes = 0
        self.max_bytes = max(0, max_bytes)
        if keep is None:
            try:
                keep = int(os.environ.get("TPUJOB_TRACE_KEEP", "3"))
            except ValueError:
                keep = 3
        self.keep = max(1, keep)
        self._lock = threading.Lock()
        self._file = None
        self._bytes = 0
        self._events: deque = deque(maxlen=4096)
        # one (wall, monotonic) pair written before the first record, so
        # a reader converts this process's monotonic stamps to wall time
        self._anchored = False

    @contextmanager
    def span(self, name: str, **attrs: Any):
        if not self.enabled:
            yield _NULL_SPAN
            return
        depth = getattr(_local, "depth", 0)
        _local.depth = depth + 1
        sp = _Span(dict(attrs))
        t0 = time.time()
        m0 = time.monotonic()   # taken at the span's start, beside t0
        p0 = time.perf_counter()
        try:
            yield sp
        finally:
            _local.depth = depth
            self._emit({
                "name": name,
                "t0": round(t0, 6),
                "m0": round(m0, 6),
                "dur_ms": round((time.perf_counter() - p0) * 1e3, 3),
                "depth": depth,
                "attrs": sp.attrs,
            })

    def event(self, name: str, **attrs: Any) -> None:
        if not self.enabled:
            return
        self._emit({
            "name": name, "t0": round(time.time(), 6),
            "m0": round(time.monotonic(), 6), "dur_ms": 0.0,
            "depth": getattr(_local, "depth", 0), "attrs": attrs,
        })

    def _emit(self, rec: Dict[str, Any]) -> None:
        # while an adopted incident is live, every record carries its id
        # (an explicit incident attribute wins)
        ctx = current_incident_context()
        if ctx is not None:
            rec["attrs"].setdefault("incident", ctx.incident_id)
        with self._lock:
            recs = [rec]
            if not self._anchored:
                self._anchored = True
                recs.insert(0, self._anchor_record())
            for r in recs:
                self._events.append(r)
                if not self.path:
                    continue
                if self._file is None:
                    os.makedirs(os.path.dirname(self.path) or ".",
                                exist_ok=True)
                    self._file = open(self.path, "a", buffering=1)
                    try:   # appending to a survivor: resume its size
                        self._bytes = os.path.getsize(self.path)
                    except OSError:
                        self._bytes = 0
                line = json.dumps(r) + "\n"
                self._file.write(line)
                self._bytes += len(line)
                if self.max_bytes and self._bytes >= self.max_bytes:
                    self._rotate_locked()

    @staticmethod
    def _anchor_record() -> Dict[str, Any]:
        return {
            "name": "clock_anchor",
            "t0": round(time.time(), 6),
            "m0": round(time.monotonic(), 6),
            "dur_ms": 0.0,
            "depth": 0,
            "attrs": {"pid": os.getpid()},
        }

    def _rotate_locked(self) -> None:
        """Shift ``path.i`` -> ``path.i+1`` (dropping ``.keep``) and rename
        the live file to ``path.1``, one atomic rename a segment."""
        self._file.close()
        self._file = None
        self._bytes = 0
        try:
            for i in range(self.keep, 0, -1):
                src = "%s.%d" % (self.path, i)
                if not os.path.exists(src):
                    continue
                if i == self.keep:
                    os.remove(src)
                else:
                    os.replace(src, "%s.%d" % (self.path, i + 1))
            os.replace(self.path, self.path + ".1")
            self._anchored = False   # the fresh segment gets its anchor
        except OSError:
            # a failed rotation must not take tracing down: keep
            # appending to the live file
            pass

    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def worker_trace_path(path: str) -> str:
    """``path`` for this worker: in a world of several workers
    (``TPUJOB_NUM_WORKERS`` > 1), ``<path>.w<TPUJOB_WORKER_ID>``, so that
    workers sharing a host (and ``TPUJOB_TRACE_FILE``) write a file each,
    as the reference's workers, one a pod, do; else ``path``."""
    try:
        workers = int(os.environ.get("TPUJOB_NUM_WORKERS", "1") or 1)
    except ValueError:
        workers = 1
    if not path or workers <= 1:
        return path
    return "%s.w%s" % (path, os.environ.get("TPUJOB_WORKER_ID", "0"))


_global: Optional[Tracer] = None


def tracer() -> Tracer:
    """The process's tracer, writing to ``TPUJOB_TRACE_FILE``
    (:func:`worker_trace_path` of it)."""
    global _global
    if _global is None:
        _global = Tracer(path=worker_trace_path(
            os.environ.get("TPUJOB_TRACE_FILE", "")))
    return _global


class StageTimes:
    """Thread-safe accumulator of per-stage host time.

    The input pipeline (:class:`..data.ShardedLoader`) and the training
    loop record where host wall-clock goes, under the JAX package's stage
    names: ``batch_build`` (source pull + window stack), ``device_put``
    (H2D issue), ``enqueue_wait`` (producer blocked on a full queue: the
    consumer is the bottleneck), ``dequeue_wait`` (consumer starved: the
    producer is the bottleneck), ``step_dispatch`` and ``dispatch_gap``
    (host time between step dispatches). ``summary()`` is the breakdown
    ``run_training`` reports.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._total: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._total[stage] = self._total.get(stage, 0.0) + seconds
            self._count[stage] = self._count.get(stage, 0) + 1

    @contextmanager
    def timed(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                stage: {
                    "ms": round(self._total[stage] * 1e3, 3),
                    "count": self._count[stage],
                    "mean_ms": round(
                        self._total[stage] * 1e3 / self._count[stage], 3),
                }
                for stage in sorted(self._total)
            }

    def reset(self) -> None:
        with self._lock:
            self._total.clear()
            self._count.clear()


class profile_steps:
    """Step-window gate for ``torch.profiler``.

    >>> prof = profile_steps()        # reads TPUJOB_PROFILE_DIR/_STEPS
    >>> for step in range(n):
    ...     prof.before(step)
    ...     state, _ = train_step(state, batch)
    ...     prof.after(step)

    Profiles steps ``[start, stop)`` (0-based, default ``10:13`` once a
    directory is set) with the CPU activity, and the CUDA one once CUDA is
    in use in the process, and writes the window as a Chrome trace,
    ``<dir>/steps_<first>-<end>.pid<pid>.trace.json`` (the paths in
    :attr:`traces`). A call of ``span`` fused steps covers ``[step,
    step + span)``: the window starts when it intersects it. Before the
    window's end is written, the card is synchronised, so the trace holds
    every kernel of its steps.
    """

    def __init__(self, profile_dir: str = "",
                 window: Optional[str] = None) -> None:
        self.dir = profile_dir or os.environ.get("TPUJOB_PROFILE_DIR", "")
        window = window or os.environ.get("TPUJOB_PROFILE_STEPS", "10:13")
        try:
            start_s, _, stop_s = window.partition(":")
            self.start, self.stop = int(start_s), int(stop_s)
        except ValueError:
            log.warning("unparseable TPUJOB_PROFILE_STEPS=%r (want "
                        "start:stop); using default 10:13", window)
            self.start, self.stop = 10, 13
        self._prof: Any = None
        self._first = 0
        self.traces: List[str] = []

    def before(self, step: int, span: int = 1) -> None:
        # a range check, not equality: a run resumed past ``start`` still
        # takes the window's tail
        if (self.dir and self._prof is None
                and self.start < step + span and step < self.stop):
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_initialized():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._first = step

    def after(self, step: int, span: int = 1) -> None:
        if self._prof is not None and step + span >= self.stop:
            self._finish(step + span)

    def close(self) -> None:
        """End a window left open (a step raised, or the run ended within
        it), writing what it holds."""
        if self._prof is not None:
            self._finish(None)

    def _finish(self, end: Optional[int]) -> None:
        import torch

        prof, self._prof = self._prof, None
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "steps_%d-%s.pid%d.trace.json" % (
            self._first, "open" if end is None else end, os.getpid()))
        prof.export_chrome_trace(path)
        self.traces.append(path)
