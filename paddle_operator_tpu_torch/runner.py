"""The training runner of the port: ``TrainJob`` + ``run_training``, the
loop of ``paddle_operator_tpu/runner.py`` that ``examples/train_resnet.py``
needs, on one device.

It builds the train step (:mod:`.parallel.train`), resumes from the newest
valid checkpoint (:func:`.utils.checkpoint.restore_latest`), feeds
prestaged batches or ``[K, ...]`` windows from a background producer
(:class:`.data.ShardedLoader`), logs deferred metrics every ``log_every``
steps, saves every ``checkpoint_every`` steps (on a background thread),
and on a drain request (:class:`DrainMonitor`) cuts a
checkpoint at the next step boundary and returns clean.

Not ported yet: elastic restart cycles, the live-migration handshake,
incident tracing, the worker metrics server, step profiling, straggler
detection and the hardware-efficiency plane.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .data import DeferredMetrics, ShardedLoader, job_window_source, \
    step_generator
from .device import DeviceLike, resolve_device
from .launch import LaunchConfig, detect_env, initialize_distributed
from .ops.optim import Optimizer
from .parallel import build_train_step
from .utils.checkpoint import AsyncCheckpointer, load_into, restore_latest
from .utils.trace import StageTimes

log = logging.getLogger("tpujob.runner")


class DrainMonitor:
    """Watches for a graceful-preemption drain request: a drain file
    appearing, a POSIX signal (``drain_signals``, typically SIGTERM), or a
    programmatic :meth:`request`. The loop polls :meth:`requested` at
    every step boundary; on drain it checkpoints at once and exits clean,
    losing no steps."""

    def __init__(self, drain_file: str = "", signals: Tuple = ()) -> None:
        self._file = drain_file
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._installed: list = []

    def request(self) -> None:
        self._event.set()

    def requested(self) -> bool:
        return self._event.is_set() or bool(
            self._file and os.path.exists(self._file))

    def install(self) -> "DrainMonitor":
        """Install the signal handlers (main thread only)."""
        if not self._signals:
            return self
        if threading.current_thread() is not threading.main_thread():
            log.warning("drain signals ignored: run_training is not on the "
                        "main thread")
            return self
        import signal as _signal

        for sig in self._signals:
            prev = _signal.signal(sig, lambda signum, frame: self._event.set())
            self._installed.append((sig, prev))
        return self

    def uninstall(self) -> None:
        import signal as _signal

        while self._installed:
            sig, prev = self._installed.pop()
            try:
                _signal.signal(sig, prev)
            except (ValueError, TypeError):  # interpreter shutting down
                pass


@dataclass
class TrainJob:
    """Everything the runner needs to train one model."""

    init_params: Callable[[torch.Generator], Any]      # generator -> params
    loss_fn: Callable                   # (params, batch) -> (loss, aux)
    optimizer: Optimizer
    make_batch: Callable[[torch.Generator, int], Any]  # (gen, step) -> batch
    merge_stats: Optional[Callable] = None
    grad_clip: Optional[float] = None
    accum_steps: int = 1        # >1: make_batch returns [accum, mb, ...]
    # >1: K optimizer steps per step_fn call; the loader stacks [K, ...]
    # windows while the current one computes
    steps_per_call: int = 1
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    # saves run on a background thread; the loop pays only the
    # device-to-host snapshot, and the end of the run drains the writer
    checkpoint_dir: str = ""
    # graceful-preemption drain: a file ("" falls back to
    # $TPUJOB_DRAIN_FILE), signals, or a programmatic monitor
    drain_file: str = ""
    drain_signals: Tuple = ()
    drain_monitor: Optional[DrainMonitor] = None
    seed: int = 0
    # where to train: None means CUDA (and raises without a card)
    device: DeviceLike = None


def run_training(job: TrainJob,
                 cfg: Optional[LaunchConfig] = None) -> Dict[str, Any]:
    """Train to ``job.total_steps`` (from the newest checkpoint, if any).

    Returns ``{"state", "steps", "cycles", "loss", "host_stages"}``, plus
    ``"resume_steps"`` after a restore and ``"drained"``/``"drain_step"``
    after a drain."""
    cfg = cfg or detect_env()
    if cfg.is_elastic:
        raise NotImplementedError(
            "elastic training cycles are not ported yet")
    initialize_distributed(cfg)
    dev = resolve_device(job.device, "run_training")
    result: Dict[str, Any] = {"cycles": 1}
    writer = AsyncCheckpointer()
    drain = job.drain_monitor or DrainMonitor(
        job.drain_file or os.environ.get("TPUJOB_DRAIN_FILE", ""),
        job.drain_signals)

    def save(step: int, state: Any) -> None:
        if cfg.worker_id == 0:
            writer.save(job.checkpoint_dir, step, state, meta={"epoch": 0})

    try:
        drain.install()
        _train(job, dev, result, save, drain, writer)
        writer.wait()   # a pending final write lands before we report
    finally:
        try:
            writer.wait()
        except BaseException:
            log.exception("async checkpoint write failed during teardown")
        drain.uninstall()
    return result


def _train(job: TrainJob, dev: torch.device, result: Dict[str, Any],
           save: Callable, drain: DrainMonitor,
           writer: AsyncCheckpointer) -> None:
    params = job.init_params(torch.Generator(device=dev).manual_seed(job.seed))
    K = max(1, job.steps_per_call)
    sample = job.make_batch(step_generator(job.seed, 0, dev), 0)
    build = dict(merge_stats=job.merge_stats, grad_clip=job.grad_clip,
                 accum_steps=job.accum_steps)
    step_fn, state = build_train_step(job.loss_fn, job.optimizer, params,
                                      sample, steps_per_call=K, **build)
    del params
    single_fn = None   # for a tail shorter than K, built on first use

    start_step = 0
    if job.checkpoint_dir:
        try:
            restored, manifest = restore_latest(job.checkpoint_dir)
        except FileNotFoundError:
            manifest = None   # fresh run (or nothing valid survived)
        if manifest is not None:
            load_into(state, restored)
            start_step = int(manifest["step"])
            result.setdefault("resume_steps", []).append(start_step)
            log.info("restored checkpoint step=%d", start_step)

    times = StageTimes()
    deferred = DeferredMetrics()
    t0 = time.perf_counter()

    def log_resolved(resolved) -> None:
        """Log a boundary whose metrics were started at the previous one."""
        if resolved is None:
            return
        pstep, t_submit, host = resolved
        rate = (pstep - start_step) / max(t_submit - t0, 1e-9)
        log.info("step %d loss=%.4f steps/s=%.2f", pstep,
                 float(host["loss"]), rate)

    loader = ShardedLoader(
        job_window_source(job.make_batch, job.seed, start_step,
                          job.total_steps, steps_per_call=K, device=dev),
        device=dev, timings=times)
    t_dispatched = None

    def dispatch(fn: Callable, state: Any):
        nonlocal t_dispatched
        t_f0 = time.perf_counter()
        batch = next(loader)
        times.add("data_wait", time.perf_counter() - t_f0)
        if t_dispatched is not None:
            times.add("dispatch_gap", time.perf_counter() - t_dispatched)
        with times.timed("step_dispatch"):
            out = fn(state, batch)
        t_dispatched = time.perf_counter()
        return out

    metrics: Dict[str, Any] = {}
    step = start_step
    last_saved = -1
    try:
        while step < job.total_steps:
            k_here = min(K, job.total_steps - step)
            if k_here == K:
                state, metrics = dispatch(step_fn, state)
                if K > 1:
                    metrics = {k: v[-1] for k, v in metrics.items()}
            else:
                if single_fn is None:
                    single_fn, _ = build_train_step(
                        job.loss_fn, job.optimizer, state["params"], sample,
                        init_state=False, **build)
                for _ in range(k_here):
                    state, metrics = dispatch(single_fn, state)
            step += k_here
            if job.log_every and step % job.log_every < k_here:
                log_resolved(deferred.start(step, metrics))
            if job.checkpoint_dir and step % job.checkpoint_every < k_here:
                with times.timed("checkpoint"):
                    save(step, state)
                last_saved = step
            result["state"] = state
            result["steps"] = step
            if drain.requested():
                log.info("drain requested; cutting final checkpoint at step "
                         "%d", step)
                log_resolved(deferred.resolve())
                if job.checkpoint_dir:
                    if last_saved != step:
                        save(step, state)
                    writer.wait()
                result["drained"] = True
                result["drain_step"] = step
                break
    finally:
        loader.close()
        result["host_stages"] = times.summary()
    log_resolved(deferred.resolve())
    if metrics:
        result["loss"] = float(metrics["loss"])
