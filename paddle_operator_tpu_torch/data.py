"""Input pipeline: a background producer feeding the training loop. The
port of ``paddle_operator_tpu/data.py``.

* :class:`ShardedLoader` runs a producer thread that pulls batches from a
  source and stages them on the device into a bounded queue, so batch
  construction and the host-to-device copy for step N+1 overlap step N.
  Where the JAX package issued ``jax.device_put``, the port copies host
  tensors through pinned buffers with ``non_blocking`` copies on a side
  CUDA stream and records an event; the consumer's stream waits on that
  event. A source that makes its batches on the device (a CUDA
  ``torch.Generator``) runs on the side stream too. Source exceptions
  re-raise on the consumer; :meth:`close` (also a context manager and GC
  hook) stops the producer.
* :func:`job_window_source` + :func:`stack_window` assemble the ``[K,
  ...]`` windows of the ``steps_per_call`` path; step ``s`` gets a
  generator seeded from ``(seed, s)`` (:func:`step_generator`, the
  counterpart of ``fold_in(rng, s)``), so a resumed run rebuilds the same
  batches. Under data parallelism each step's batch is cut to the rank's
  block (:func:`process_shard`) before it is stacked or placed, so only
  that block reaches the rank's card.
* :class:`DeferredMetrics` starts the device-to-host copy of a metrics
  tree at one log boundary and reads it at the next, so logging never
  stalls the device queue.

Per-stage host timings go to a :class:`.utils.trace.StageTimes` under the
JAX package's stage names.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import weakref
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from . import bridge
from .device import DeviceLike, resolve_device
from .utils.trace import StageTimes


def step_generator(seed: int, step: int,
                   device: DeviceLike = None) -> torch.Generator:
    """A generator on ``device`` (``None`` means CUDA) seeded from
    ``(seed, step)``: the same pair always gives the same numbers, and
    distinct steps get unrelated seeds."""
    dev = resolve_device(device, "step_generator")
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=dev).manual_seed(int(state[0]) >> 1)


def process_shard(batch: Any, process_index: int, process_count: int,
                  axis: int = 0) -> Any:
    """Slice the global batch to this process's contiguous block of
    ``axis`` (data parallelism: process i takes rows ``[i*b/P,
    (i+1)*b/P)``). Leaves with no such axis (scalars) are kept whole; a
    torch block is copied out, so the global batch can be freed."""
    if process_count == 1:
        return batch

    def slice_leaf(leaf):
        if getattr(leaf, "ndim", 0) <= axis:
            return leaf
        n = leaf.shape[axis]
        if n % process_count:
            raise ValueError(
                "global batch dim %d does not divide across %d processes"
                % (n, process_count)
            )
        per = n // process_count
        if isinstance(leaf, torch.Tensor):
            return leaf.narrow(axis, process_index * per, per).clone(
                memory_format=torch.contiguous_format)
        index = (slice(None),) * axis + (
            slice(process_index * per, (process_index + 1) * per),)
        return np.asarray(leaf)[index]

    return bridge.tree_map(slice_leaf, batch)


def stack_window(batches: list, force_host: bool = False) -> Any:
    """Stack K per-step batches into one ``[K, ...]`` window: torch leaves
    with ``torch.stack`` (on their device), numpy leaves with
    ``np.stack``. ``force_host`` stacks every leaf on the host, as numpy,
    whatever its device (the reference's multi-host windows)."""
    def stack(*xs):
        if not force_host and all(isinstance(x, torch.Tensor) for x in xs):
            return torch.stack(xs)
        return np.stack([x.detach().cpu().numpy()
                         if isinstance(x, torch.Tensor) else np.asarray(x)
                         for x in xs])

    return bridge.tree_map(stack, *batches)


def job_window_source(make_batch: Callable[[torch.Generator, int], Any],
                      seed: int, start_step: int, total_steps: int,
                      steps_per_call: int = 1,
                      device: DeviceLike = None,
                      force_host_windows: bool = False,
                      shard: Optional[Callable[[Any], Any]] = None
                      ) -> Iterator[Any]:
    """Adapt a ``TrainJob.make_batch(generator, step)`` into a loader
    source, drawing on ``device`` (``None`` means CUDA). Yields, in the
    order ``run_training`` consumes them, full ``[K, ...]`` windows while
    at least K steps remain (stacked on the host if
    ``force_host_windows``), then single batches for the tail (always
    singles when K == 1). ``shard`` (e.g. a :func:`process_shard`
    partial) cuts each step's batch to this rank's block before it is
    stacked. The device is resolved here, at the call."""
    dev = resolve_device(device, "job_window_source")
    K = max(1, steps_per_call)
    cut = shard or (lambda b: b)

    def one(s: int) -> Any:
        return cut(make_batch(step_generator(seed, s, dev), s))

    def windows() -> Iterator[Any]:
        step = start_step
        while step < total_steps:
            span = min(K, total_steps - step)
            if span == K and K > 1:
                yield stack_window([one(s) for s in range(step, step + K)],
                                   force_host=force_host_windows)
            else:
                for s in range(step, step + span):
                    yield one(s)
            step += span

    return windows()


def _producer_main(loader_ref) -> None:
    """Producer thread body, module-level on purpose: between items it
    holds only the weakref, so dropping the last user reference to a
    loader lets GC collect it (running ``__del__`` -> ``close()``)."""
    while True:
        loader = loader_ref()
        if loader is None:
            return
        try:
            status = loader._produce_step()
        except BaseException:  # defensive: _produce_step guards itself
            return
        if status == "done":
            return
        del loader


#: batches or windows the producer keeps ready ahead of the consumer
PREFETCH = 2


class _Staged:
    """A batch placed on the side stream, with the event its copies and
    kernels end at."""

    def __init__(self, batch: Any, event: torch.cuda.Event) -> None:
        self.batch = batch
        self.event = event


class ShardedLoader:
    """Background producer: pulls, places on ``device``, prefetches.

    A thread pulls from the source, places each batch and feeds a bounded
    queue :data:`PREFETCH` deep, the runner's depth; a full queue
    backpressures the producer. Source exceptions re-raise on the consumer at ``next()``.

    Placement on a CUDA ``device``: numpy and CPU tensor leaves are copied
    into pinned host memory and sent with ``non_blocking`` copies on a
    side stream; leaves already on the device pass through. The pull
    itself runs on the side stream, so a source that draws its batches on
    the device does so there. The consumer's current stream waits on the
    batch's event, and each leaf is marked as used by that stream.
    ``device=None`` means CUDA.
    """

    def __init__(self, source: Iterator[Any], device: DeviceLike = None,
                 timings: Optional[StageTimes] = None) -> None:
        self._source = source
        self._device = resolve_device(device, "ShardedLoader")
        self._timings = timings
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._exhausted = False
        self._queue: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._staged = None   # item built but not yet enqueued
        self._final = False   # staged item is the end/error sentinel
        self._enqueue_blocked = 0.0
        self._thread: Optional[threading.Thread] = threading.Thread(
            target=_producer_main, args=(weakref.ref(self),),
            name="sharded-loader", daemon=True)
        self._thread.start()

    def _timed(self, stage: str):
        if self._timings is None:
            return contextlib.nullcontext()
        return self._timings.timed(stage)

    def _on_side_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _pull(self) -> Any:
        """One source item (raises StopIteration at the end), built on the
        side stream."""
        with self._timed("batch_build"), self._on_side_stream():
            return next(self._source)

    def _place(self, batch: Any) -> Any:
        with self._timed("device_put"):
            if self._stream is None:
                return bridge.tree_map(
                    lambda x: torch.as_tensor(x).to(self._device), batch)

            def h2d(x: Any) -> torch.Tensor:
                t = torch.as_tensor(x)
                if t.device.type == "cpu":
                    t = t.pin_memory().to(self._device, non_blocking=True)
                return t

            with torch.cuda.stream(self._stream):
                placed = bridge.tree_map(h2d, batch)
                event = torch.cuda.Event()
                event.record(self._stream)
            return _Staged(placed, event)

    def _hand_over(self, item: Any) -> Any:
        """Make the consumer's stream wait for a staged batch."""
        if not isinstance(item, _Staged):
            return item
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(item.event)
        bridge.tree_map(lambda t: t.record_stream(consumer)
                        if t.device.type == "cuda" else None, item.batch)
        return item.batch

    # ---- producer thread --------------------------------------------------

    def _produce_step(self) -> str:
        """One producer iteration: stage one item (pull + place, an
        exception becoming the error sentinel), then try to enqueue it
        within a bounded wait, so the loop notices close() promptly.
        Returns "again" or "done"."""
        if self._stop.is_set():
            return "done"
        if self._staged is None:
            try:
                nxt = self._pull()
            except StopIteration:
                self._staged, self._final = ("end", None), True
            except BaseException as exc:  # re-raised on the consumer
                self._staged, self._final = ("error", exc), True
            else:
                try:
                    self._staged = ("batch", self._place(nxt))
                except BaseException as exc:
                    self._staged, self._final = ("error", exc), True
        t0 = time.perf_counter()
        try:
            self._queue.put(self._staged, timeout=0.1)
        except queue.Full:
            self._enqueue_blocked += time.perf_counter() - t0
            return "again"
        if self._timings is not None:
            self._timings.add("enqueue_wait",
                              self._enqueue_blocked + time.perf_counter() - t0)
        self._enqueue_blocked = 0.0
        self._staged = None
        return "done" if self._final else "again"

    # ---- consumer ---------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        if self._exhausted:
            raise StopIteration
        with self._timed("dequeue_wait"):
            while True:
                try:
                    kind, payload = self._queue.get(timeout=0.5)
                    break
                except queue.Empty:
                    if self._thread is None or not self._thread.is_alive():
                        # closed, or the producer died without a sentinel
                        self._exhausted = True
                        raise StopIteration from None
        if kind == "batch":
            return self._hand_over(payload)
        self._exhausted = True
        if kind == "error":
            raise payload
        raise StopIteration

    # ---- lifecycle --------------------------------------------------------

    def producer_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _drain(self) -> None:
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    def close(self) -> None:
        """Stop the producer and join its thread (idempotent)."""
        if self._thread is None:
            return
        self._stop.set()
        self._drain()   # a producer blocked mid-put sees the stop promptly
        self._thread.join(timeout=5)
        self._thread = None
        self._staged = None
        self._drain()   # an item put into the slot the first drain freed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DeferredMetrics:
    """Deferred metrics readback: start the copy now, read it later.

    ``start(step, metrics)`` starts a ``non_blocking`` device-to-host copy
    of every CUDA tensor leaf into pinned memory, records an event, and
    returns the PREVIOUS submission read back to numpy (``None`` on the
    first call). ``resolve()`` reads the pending entry (end of run)."""

    def __init__(self) -> None:
        self._pending = None  # (step, perf_counter at submit, host, event)

    @staticmethod
    def _copy_async(x: Any) -> Any:
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return out.copy_(x.detach(), non_blocking=True)
        return x

    def start(self, step: int, metrics: Any):
        host = bridge.tree_map(self._copy_async, metrics)
        event = None
        if any(isinstance(x, torch.Tensor) and x.device.type == "cuda"
               for x in bridge.leaves(metrics)):
            event = torch.cuda.Event()
            event.record()
        prev = self.resolve()
        self._pending = (step, time.perf_counter(), host, event)
        return prev

    def resolve(self):
        """``(step, submit_time, host_metrics)`` of the pending entry, or
        None. Blocks only until its copy has landed."""
        if self._pending is None:
            return None
        step, t_submit, host, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        return step, t_submit, bridge.tree_map(
            lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x), host)
