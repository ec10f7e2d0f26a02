"""The training runner of the port: ``TrainJob`` + ``run_training``, the
loop of ``paddle_operator_tpu/runner.py``, on one device or data-parallel
over the processes of a ``torch.distributed`` world (one card each).

It joins the world the operator's env describes
(:func:`.launch.initialize_distributed`), builds a mesh when
``mesh_axes`` is set (dp, or dp x sp with ``seq_axis``) or the world has
more than one process (all on dp) (:mod:`.parallel.mesh`), hands it to a
``loss_fn`` that declares a ``mesh`` keyword (the hook ring and Ulysses
attention plug into), builds the train step (:mod:`.parallel.train`),
resumes from the newest valid checkpoint (:func:`.utils.checkpoint.
restore_latest`, agreed between the ranks), feeds prestaged batches or
``[K, ...]`` windows from a background producer (:class:`.data.
ShardedLoader`; each rank draws the global batch and keeps its dp
block, the token axis whole under a sequence axis),
logs deferred metrics every ``log_every`` steps, saves every
``checkpoint_every`` steps (v2 on a background thread from worker 0 in a
world of one; the sharded format from every rank, synchronously, in a
larger one), and on a drain request (:class:`DrainMonitor`) seen by any
rank cuts a checkpoint at the next step boundary on every rank and
returns clean.

An elastic job (``TPUJOB_ELASTIC_SERVER``) trains in restart cycles
under :class:`.launch.ElasticAgent`: when the operator moves the job's
membership epoch, every rank stops at the same step boundary, cuts a
durable checkpoint, leaves the process group, and the next cycle forms
one of the new ``np`` ranks (:class:`.launch.ElasticWorld`), rebuilds
the mesh (``mesh_axes`` may be a callable of the world size), restores
and trains on; a worker whose index the new world no longer holds
leaves after the save.

Not ported yet: the live-migration handshake, incident tracing, the
worker metrics server, step profiling, straggler detection and the
hardware-efficiency plane.
"""

from __future__ import annotations

import functools
import inspect
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from .data import DeferredMetrics, ShardedLoader, job_window_source, \
    process_shard, step_generator
from .device import DeviceLike, resolve_device
from .launch import ElasticAgent, ElasticWorld, LaunchConfig, detect_env, \
    initialize_distributed, shutdown_distributed
from .ops.optim import Optimizer
from .parallel import build_train_step, collectives
from .parallel.mesh import Mesh, make_mesh, world_size
from .parallel.train import batch_axis_of
from .utils.checkpoint import AsyncCheckpointer, load_into, \
    restore_latest, save_checkpoint_sharded
from .utils.trace import StageTimes

log = logging.getLogger("tpujob.runner")

# a step boundary's decision, max-reduced over the ranks so that every
# rank takes the same one at the same step: drain over restart over none
_POLL_NONE, _POLL_RESTART, _POLL_DRAIN = 0, 1, 2


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
    # {axis: size} of the mesh, over dp and sp (e.g. {"dp": -1, "sp": 2}),
    # or a callable world size -> {axis: size}, so that an elastic resize
    # rebuilds the next cycle's mesh at the new world; None: dp over every
    # process of the world, or no mesh in a world of one
    mesh_axes: Union[None, Dict[str, int],
                     Callable[[int], Dict[str, int]]] = None
    # the mesh axis the sequence is split over (e.g. "sp"): the loss takes
    # this rank's block of each sequence (parallel.train)
    seq_axis: Optional[str] = None
    # input contract under dp: False = make_batch returns the GLOBAL
    # batch, the same on every rank, and each rank keeps its dp block;
    # True = make_batch returns only this rank's dp block
    host_local_batches: bool = False


def run_training(job: TrainJob, cfg: Optional[LaunchConfig] = None,
                 init_distributed: bool = True,
                 poll_interval: float = 2.0) -> Dict[str, Any]:
    """Train to ``job.total_steps`` (from the newest checkpoint, if any),
    elastically if ``cfg`` names an elastic server.

    Returns ``{"state", "steps", "cycles", "loss", "host_stages",
    "mesh_history", "cycle_stages"}``, plus ``"resume_steps"`` after a
    restore, ``"drained"``/``"drain_step"`` after a drain and
    ``"left_at_epoch"`` on a worker that an elastic shrink removed.
    ``cycle_stages`` holds, a cycle each, its epoch, world, first and
    last step, its host seconds by part (the rendezvous with its mesh,
    the step build, the restore, the interrupt save and the leave) and,
    for a cycle that stopped early, the ``time.perf_counter()`` of the
    stop decision.

    A static job joins the world of ``cfg`` (default: the env) if it is
    not up yet and leaves a group it made at the end. An elastic job runs
    cycles under :class:`.launch.ElasticAgent` (polling the store every
    ``poll_interval`` seconds at most), each in a process group of the
    cycle's ``np`` ranks that :class:`.launch.ElasticWorld` forms and
    destroys. With ``init_distributed=False`` the caller owns the
    process group, and no cycle forms or destroys one."""
    cfg = cfg or detect_env()
    dev = resolve_device(job.device, "run_training")
    result: Dict[str, Any] = {"cycles": 0, "mesh_history": [],
                              "cycle_stages": []}
    writer = AsyncCheckpointer()
    drain = job.drain_monitor or DrainMonitor(
        job.drain_file or os.environ.get("TPUJOB_DRAIN_FILE", ""),
        job.drain_signals)
    world_of = ElasticWorld(cfg, job.device) if (
        cfg.is_elastic and init_distributed) else None

    def train_cycle(world: int, epoch: int,
                    should_stop: Callable[[], bool]) -> bool:
        if cfg.worker_id >= world:
            # a shrink removes the highest ranks: this one saved with the
            # old world, and its pod is the one the operator deletes
            log.info("worker %d is not in the %d-worker world of epoch %d; "
                     "leaving", cfg.worker_id, world, epoch)
            result["left_at_epoch"] = epoch
            return True
        stages: Dict[str, Any] = {"epoch": epoch, "world": world}
        result["cycle_stages"].append(stages)
        t = time.perf_counter()
        formed = world_of is not None and world_of.join(world, epoch)
        try:
            axes = job.mesh_axes(world) if callable(job.mesh_axes) \
                else job.mesh_axes
            mesh = _cycle_mesh(axes, elastic=callable(job.mesh_axes))
            # the agreement on (np, epoch), the group and its mesh
            stages["rendezvous_s"] = time.perf_counter() - t + (
                world_of.agree_s if world_of is not None else 0.0)
            return _train(job, cfg, dev, mesh, epoch, should_stop, result,
                          stages, writer, drain)
        finally:
            t = time.perf_counter()
            if formed:
                world_of.leave()
            stages["leave_s"] = time.perf_counter() - t

    made = not cfg.is_elastic and init_distributed and \
        initialize_distributed(cfg, device=job.device)
    try:
        drain.install()
        if cfg.is_elastic:
            result["cycles"] = ElasticAgent(
                cfg, poll_interval=poll_interval).run(
                    train_cycle,
                    agree=world_of.agree if world_of is not None else None)
        else:
            train_cycle(cfg.num_workers, 0, lambda: False)
            result["cycles"] = 1
        writer.wait()   # a pending final write lands before we report
    finally:
        try:
            writer.wait()
        except BaseException:
            log.exception("async checkpoint write failed during teardown")
        drain.uninstall()
        shutdown_distributed(made)
    return result


def _cycle_mesh(axes: Optional[Dict[str, int]],
                elastic: bool = False) -> Optional[Mesh]:
    """The mesh of one cycle over the current world: ``axes``, or dp over
    every process of a world of several; ``None`` for a world of one
    without axes. ``elastic``: the axes came from a ``mesh_axes``
    callable of the world size, and must name every size (a -1 would
    hide a resize the callable is there to state)."""
    if axes and elastic and any(s == -1 for s in axes.values()):
        raise ValueError(
            "elastic mesh_axes must be fully specified (no -1 sizes); "
            "compute them from the world size, got %r" % (axes,))
    if axes or world_size() > 1:
        return make_mesh(axes)
    return None


def bind_mesh(loss_fn: Callable, mesh: Optional[Mesh]) -> Callable:
    """``loss_fn`` with ``mesh=mesh`` bound when its signature declares a
    ``mesh`` keyword (the hook ring and Ulysses attention plug into), as
    the reference's runner gives the live mesh; else ``loss_fn``."""
    if "mesh" in inspect.signature(loss_fn).parameters:
        return functools.partial(loss_fn, mesh=mesh)
    return loss_fn


def _train(job: TrainJob, cfg: LaunchConfig, dev: torch.device,
           mesh: Optional[Mesh], epoch: int,
           should_stop: Callable[[], bool], result: Dict[str, Any],
           stages: Dict[str, Any], writer: AsyncCheckpointer,
           drain: DrainMonitor) -> bool:
    """One cycle: build the step on ``mesh``, restore the newest
    checkpoint, train until done (True) or until the boundary decision
    says drain (True) or restart (False), cutting a checkpoint first."""
    result["mesh_history"].append(dict(mesh.shape) if mesh is not None
                                  else None)
    multi = mesh is not None and mesh.size > 1

    def save(step: int, state: Any) -> None:
        """Several ranks: every rank writes the sharded format, in step,
        synchronously (it meets barriers anyway); one: worker 0 writes v2
        on the background thread."""
        if multi:
            save_checkpoint_sharded(job.checkpoint_dir, step, state,
                                    meta={"epoch": epoch}, group=mesh.control)
        elif cfg.worker_id == 0:
            writer.save(job.checkpoint_dir, step, state,
                        meta={"epoch": epoch})

    def boundary() -> int:
        """The boundary's decision, the same on every rank: a drain is per
        pod (one SIGTERM, one drain file), so each rank offers its own;
        the epoch is the same for every rank, so only rank 0 reads the
        store; the MAX over the ranks decides (drain over restart over
        nothing). Every rank calls this at every boundary, so the
        collective is aligned; a decision seen by one rank alone would
        leave its peers waiting in the next step's collectives."""
        local = _POLL_DRAIN if drain.requested() else _POLL_NONE
        if local == _POLL_NONE and (not multi or mesh.rank == 0) \
                and should_stop():
            local = _POLL_RESTART
        return collectives.max_int(local, mesh.control) if multi else local

    t = time.perf_counter()
    params = job.init_params(torch.Generator(device=dev).manual_seed(job.seed))
    K = max(1, job.steps_per_call)
    sample = job.make_batch(step_generator(job.seed, 0, dev), 0)
    loss_fn = bind_mesh(job.loss_fn, mesh)
    # the loader hands each rank its block, so the step takes it as is
    build = dict(merge_stats=job.merge_stats, grad_clip=job.grad_clip,
                 accum_steps=job.accum_steps, mesh=mesh,
                 seq_axis=job.seq_axis, host_local_batches=True)
    step_fn, state = build_train_step(loss_fn, job.optimizer, params,
                                      sample, steps_per_call=K, **build)
    del params
    single_fn = None   # for a tail shorter than K, built on first use
    stages["build_s"] = time.perf_counter() - t

    t = time.perf_counter()
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
            log.info("restored checkpoint step=%d (epoch %s)", start_step,
                     manifest["meta"].get("epoch"))
        # a fallback below the writer's last save makes that save real
        # again when training reaches its step
        writer.sync_dedup(job.checkpoint_dir, start_step)
    stages["restore_s"] = time.perf_counter() - t
    stages["start_step"] = stages["end_step"] = start_step

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
                                  process_index=mesh.axis_rank("dp"),
                                  process_count=mesh.axis_size("dp"),
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
                        loss_fn, job.optimizer, state["params"], sample,
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
            result["steps"] = stages["end_step"] = step
            outcome = boundary()
            if outcome == _POLL_NONE:
                continue
            stages["stopped_at"] = time.perf_counter()
            drained = outcome == _POLL_DRAIN
            log.info("%s at step %d", "drain requested; cutting final "
                     "checkpoint" if drained else "membership epoch moved; "
                     "restarting", step)
            log_resolved(deferred.resolve())
            if job.checkpoint_dir:
                t = time.perf_counter()
                # the periodic save may have covered this step already;
                # the write must be durable before the next cycle reads it
                if last_saved != step:
                    save(step, state)
                writer.wait()
                stages["interrupt_save_s"] = time.perf_counter() - t
            if not drained:
                return False
            result["drained"] = True
            result["drain_step"] = step
            break
    finally:
        loader.close()
        result["host_stages"] = times.summary()
    log_resolved(deferred.resolve())
    if metrics:
        result["loss"] = float(metrics["loss"])
    return True
