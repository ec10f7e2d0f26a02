"""The training runner of the port: ``TrainJob`` + ``run_training``, the
loop of ``paddle_operator_tpu/runner.py``, on one device or data-parallel
over the processes of a ``torch.distributed`` world (one card each).

It joins the world the operator's env describes
(:func:`.launch.initialize_distributed`), builds a ``dp`` mesh when
``mesh_axes`` is set or the world has more than one process
(:mod:`.parallel.mesh`), builds the train step (:mod:`.parallel.train`),
resumes from the newest valid checkpoint (:func:`.utils.checkpoint.
restore_latest`, agreed between the ranks), feeds prestaged batches or
``[K, ...]`` windows from a background producer (:class:`.data.
ShardedLoader`; each rank draws the global batch and keeps its block),
logs deferred metrics every ``log_every`` steps, saves every
``checkpoint_every`` steps (v2 on a background thread from worker 0 in a
world of one; the sharded format from every rank, synchronously, in a
larger one), and on a drain request (:class:`DrainMonitor`) seen by any
rank cuts a checkpoint at the next step boundary on every rank and
returns clean.

Not ported yet: elastic restart cycles, the live-migration handshake,
incident tracing, the worker metrics server, step profiling, straggler
detection and the hardware-efficiency plane.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .data import DeferredMetrics, ShardedLoader, job_window_source, \
    process_shard, step_generator
from .device import DeviceLike, resolve_device
from .launch import LaunchConfig, detect_env, initialize_distributed, \
    shutdown_distributed
from .ops.optim import Optimizer
from .parallel import build_train_step, collectives
from .parallel.mesh import Mesh, make_mesh, world_size
from .parallel.train import batch_axis_of
from .utils.checkpoint import AsyncCheckpointer, load_into, \
    restore_latest, save_checkpoint_sharded
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
    # {axis: size} of the mesh, dp only (e.g. {"dp": -1}); None: dp over
    # every process of the world, or no mesh in a world of one
    mesh_axes: Optional[Dict[str, int]] = None
    # input contract under dp: False = make_batch returns the GLOBAL
    # batch, the same on every rank, and each rank keeps its block; True
    # = make_batch returns only this rank's block
    host_local_batches: bool = False


def run_training(job: TrainJob,
                 cfg: Optional[LaunchConfig] = None) -> Dict[str, Any]:
    """Train to ``job.total_steps`` (from the newest checkpoint, if any).

    Returns ``{"state", "steps", "cycles", "loss", "host_stages",
    "mesh_history"}``, plus ``"resume_steps"`` after a restore and
    ``"drained"``/``"drain_step"`` after a drain. Joins the world of
    ``cfg`` (default: the env) if it is not up yet, and leaves a group it
    made at the end."""
    cfg = cfg or detect_env()
    if cfg.is_elastic:
        raise NotImplementedError(
            "elastic training cycles are not ported yet")
    made = initialize_distributed(cfg, device=job.device)
    try:
        return _run(job, cfg)
    finally:
        shutdown_distributed(made)


def _run(job: TrainJob, cfg: LaunchConfig) -> Dict[str, Any]:
    dev = resolve_device(job.device, "run_training")
    result: Dict[str, Any] = {"cycles": 1}
    mesh = make_mesh(job.mesh_axes) if (
        job.mesh_axes or world_size() > 1) else None
    result["mesh_history"] = [dict(mesh.shape) if mesh is not None
                              else None]
    multi = mesh is not None and mesh.size > 1
    writer = AsyncCheckpointer()
    drain = job.drain_monitor or DrainMonitor(
        job.drain_file or os.environ.get("TPUJOB_DRAIN_FILE", ""),
        job.drain_signals)

    def save(step: int, state: Any) -> None:
        """Several ranks: every rank writes the sharded format, in step,
        synchronously (it meets barriers anyway); one: worker 0 writes v2
        on the background thread."""
        if multi:
            save_checkpoint_sharded(job.checkpoint_dir, step, state,
                                    meta={"epoch": 0}, group=mesh.control)
        elif cfg.worker_id == 0:
            writer.save(job.checkpoint_dir, step, state, meta={"epoch": 0})

    def drain_agreed() -> bool:
        """The boundary's drain decision, the same on every rank: a drain
        is per pod (one SIGTERM, one drain file), so each rank offers its
        own and the MAX over the ranks decides. Every rank calls this at
        every boundary, so the collective is aligned; a drain seen by one
        rank alone would leave its peers waiting in the next step's
        collectives."""
        local = int(drain.requested())
        return bool(collectives.max_int(local, mesh.control)) if multi \
            else bool(local)

    try:
        drain.install()
        _train(job, dev, mesh, result, save, drain_agreed, writer)
        writer.wait()   # a pending final write lands before we report
    finally:
        try:
            writer.wait()
        except BaseException:
            log.exception("async checkpoint write failed during teardown")
        drain.uninstall()
    return result


def _train(job: TrainJob, dev: torch.device, mesh: Optional[Mesh],
           result: Dict[str, Any], save: Callable,
           drain_agreed: Callable[[], bool],
           writer: AsyncCheckpointer) -> None:
    params = job.init_params(torch.Generator(device=dev).manual_seed(job.seed))
    K = max(1, job.steps_per_call)
    sample = job.make_batch(step_generator(job.seed, 0, dev), 0)
    multi = mesh is not None and mesh.size > 1
    # the loader hands each rank its block, so the step takes it as is
    build = dict(merge_stats=job.merge_stats, grad_clip=job.grad_clip,
                 accum_steps=job.accum_steps, mesh=mesh,
                 host_local_batches=True)
    step_fn, state = build_train_step(job.loss_fn, job.optimizer, params,
                                      sample, steps_per_call=K, **build)
    del params
    single_fn = None   # for a tail shorter than K, built on first use

    start_step = 0
    if job.checkpoint_dir:
        try:
            restored, manifest = restore_latest(
                job.checkpoint_dir,
                group=mesh.control if mesh is not None else None)
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

    shard = None
    if multi and not job.host_local_batches:
        shard = functools.partial(process_shard,
                                  process_index=mesh.rank,
                                  process_count=mesh.size,
                                  axis=batch_axis_of(job.accum_steps))
    loader = ShardedLoader(
        job_window_source(job.make_batch, job.seed, start_step,
                          job.total_steps, steps_per_call=K, device=dev,
                          shard=shard),
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
            if drain_agreed():
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
