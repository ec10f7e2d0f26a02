"""The training runner of the port: ``TrainJob`` + ``run_training``, the
loop of ``paddle_operator_tpu/runner.py``, on one device or data-parallel
over the processes of a ``torch.distributed`` world (one card each).

It joins the world the operator's env describes
(:func:`.launch.initialize_distributed`), builds a mesh when
``mesh_axes`` is set (dp, dp x sp with ``seq_axis``, dp x ep, dp x tp or
dp x fsdp with the job's ``rules``) or the world has more than one
process (all on dp) (:mod:`.parallel.mesh`), hands it to a ``loss_fn``
that declares a ``mesh`` keyword (the hook ring and Ulysses attention
plug into), builds the train step with the job's sharding ``rules``
(:mod:`.parallel.train`: under ep, tp or fsdp each rank holds its tile
of every leaf the rules split, saves it once a tile as its block of the
whole leaf and restores its own blocks shard-wise),
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

A drain can be a MOVE (the live-migration handshake, docs/design.md
"Live migration"): the operator's drain notice writes the intent
(``{"namespace", "name"}``) to ``TPUJOB_MIGRATE_FILE``; the drained exit
of a world of one (worker 0) then publishes the final cut, once the
writer has landed it, as a state bundle through the artifact store
(:mod:`.artifacts.state`). The destination pod carries
``TPUJOB_MIGRATE_STATE="ns/name:step"`` and pre-stages that bundle into
its checkpoint dir before the first cycle, so the restore finds the
source's cut; any miss or poisoned member falls back to the durable
checkpoint, never to a wrong restore.

Observability, as the reference's runner has it (:class:`_Observer`):
a pod carrying ``TPUJOB_TRACE_CONTEXT`` adopts the operator's incident
and stamps every trace record with it until its first good step
(``incident_adopted``, ``incident_stage``, ``incident_first_step``);
``metrics_port`` (or ``TPUJOB_WORKER_METRICS_PORT``) serves the
``tpujob_worker_*`` families at ``result["worker_metrics_url"]``, with
the gauges of each log boundary; each step's phases go to a bounded
profile (``data_wait``, ``dispatch``, ``collective``, ``d2h``,
``checkpoint``: ``result["step_profile"]``); at each log boundary the
rank's dispatch p50 is held against the gang's (an injected
``gang_p50_source``, or an all-gather over the world: ``straggler``
events) and its examples/s against its own baseline
(``backend_degraded`` events); the hardware plane
(:mod:`.obs.hardware`) counts the first step of each cycle's FLOPs
(executed FLOPs, flash attention's as model FLOPs: the module says why)
and times every step on the device's clock (``result["hardware"]``);
and the run's wall time splits into goodput and badput by cause
(``restore``, ``data_stall``, ``checkpoint``, ``compile``: the seconds
the compile cache spent in nvcc during the run) in a conserving
``result["goodput_detail"]``.

The compile cache (:mod:`.compile_cache`): every kernel library comes
down its ladder (memo, local, fleet, built), and ``result
["compile_cache"]`` is its :func:`~.compile_cache.startup_block`. A
cycle's counted first step keeps its cost under the step's fingerprint
(in ``TPUJOB_COMPILE_CACHE_DIR``, where it is set): a restart of the same
step reads it back and runs its first step uncounted (``result["compile_cache"]["step_cost"]``: ``cache`` or
``counted`` a cycle). ``TPUJOB_PROFILE_DIR`` takes a
``torch.profiler`` window (:class:`.utils.trace.profile_steps`).
"""

from __future__ import annotations

import functools
import inspect
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from . import bridge, compile_cache
from .artifacts import get_store
from .artifacts.state import fetch_state, publish_state, state_fingerprint
from .data import PREFETCH, DeferredMetrics, ShardedLoader, \
    job_window_source, process_shard, step_generator
from .device import DeviceLike, resolve_device
from .launch import ElasticAgent, ElasticWorld, LaunchConfig, detect_env, \
    initialize_distributed, shutdown_distributed
from .obs.hardware import HardwarePlane, StepClock, StepCost, \
    analytic_cost, resolve_chip, step_cost_of
from .obs.worker import StepProfiler, StragglerDetector, \
    ThroughputBaseline, WorkerMetricsServer, median
from .ops.optim import Optimizer
from .parallel import build_train_step, collectives
from .parallel.mesh import Mesh, make_mesh, world_size
from .parallel.train import batch_axis_of
from .utils.checkpoint import AsyncCheckpointer, load_into, \
    restore_latest, save_checkpoint, save_checkpoint_sharded
from .utils.trace import SpanContext, StageTimes, clear_incident_context, \
    profile_steps, set_incident_context, tracer

log = logging.getLogger("tpujob.runner")

# a step boundary's decision, max-reduced over the ranks so that every
# rank takes the same one at the same step: drain over restart over none
_POLL_NONE, _POLL_RESTART, _POLL_DRAIN = 0, 1, 2


class DrainMonitor:
    """Watches for a graceful-preemption drain request: a drain file
    appearing, a POSIX signal (``drain_signals``, typically SIGTERM), or a
    programmatic :meth:`request`. The loop polls :meth:`requested` at
    every step boundary; on drain it checkpoints at once and exits clean,
    losing no steps.

    A drain can be a MOVE: the same final checkpoint, which the exit then
    also publishes as a state bundle for the destination to pre-stage.
    A migrate file carrying the JSON intent (``TPUJOB_MIGRATE_FILE``, what
    the operator's drain notice writes) or :meth:`request_migrate` arms
    it."""

    def __init__(self, drain_file: str = "", signals: Tuple = (),
                 migrate_file: str = "") -> None:
        self._file = drain_file
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._installed: list = []
        self._migrate_file = migrate_file
        self._migrate: Optional[dict] = None

    def request(self) -> None:
        self._event.set()

    def request_migrate(self, intent: Optional[dict] = None) -> None:
        """Arm the drain as a MOVE: the intent (``namespace`` and
        ``name`` at least) says where the exit publishes the state. It is
        set BEFORE the event, so a drain that sees the event sees it."""
        self._migrate = dict(intent or {})
        self._event.set()

    def requested(self) -> bool:
        return self._event.is_set() or bool(
            self._file and os.path.exists(self._file)) or bool(
            self._migrate_file and os.path.exists(self._migrate_file))

    def migrate_intent(self) -> Optional[dict]:
        """The MOVE intent when this drain is a migration, else None (an
        ordinary drain). A torn or non-object migrate file gives ``{}``:
        the drain still exits clean, and only the publish is skipped for
        want of a job key."""
        if self._migrate is not None:
            return dict(self._migrate)
        if self._migrate_file and os.path.exists(self._migrate_file):
            try:
                with open(self._migrate_file) as fh:
                    out = json.load(fh)
                return dict(out) if isinstance(out, dict) else {}
            except (OSError, ValueError):
                return {}
        return None

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
    checkpoint_dir: str = ""
    # a world of one saves on a background thread (the loop pays only the
    # device-to-host snapshot; the end of the run drains the writer);
    # False: synchronously. A world of several always saves sharded and
    # synchronously.
    async_checkpoint: bool = True
    # a world of one writes the sharded format too (shards, one process)
    sharded_checkpoint: bool = False
    # batches or windows the loader's producer keeps ahead of the loop;
    # 0: inline, no producer thread
    prefetch: int = PREFETCH
    # the worker /metrics endpoint: None = off unless
    # TPUJOB_WORKER_METRICS_PORT is set; 0 = any free port (the URL lands
    # in result["worker_metrics_url"])
    metrics_port: Optional[int] = None
    # straggler detection: own dispatch p50 -> {worker: p50}, the gang
    # view at a log boundary; None in a world of several processes is an
    # all-gather of every rank's p50 (every rank reaches the same
    # boundary). A worker above straggler_k x the gang median emits a
    # `straggler` event and counts in result["straggler_events"].
    gang_p50_source: Optional[Callable[[float], Dict[Any, float]]] = None
    straggler_k: float = 2.0
    # the hardware plane's closed-form cost, used where the step's FLOP
    # count gives nothing (stamped cost_source="analytic"); the count has
    # no bytes, so bytes_per_step is the only source of an intensity
    flops_per_step: Optional[float] = None
    bytes_per_step: Optional[float] = None
    # graceful-preemption drain: a file ("" falls back to
    # $TPUJOB_DRAIN_FILE), signals, or a programmatic monitor
    drain_file: str = ""
    drain_signals: Tuple = ()
    drain_monitor: Optional[DrainMonitor] = None
    seed: int = 0
    # where to train: None means CUDA (and raises without a card)
    device: DeviceLike = None
    # {axis: size} of the mesh, over dp, sp, ep, tp and fsdp (e.g.
    # {"dp": -1, "sp": 2}, {"dp": 2, "tp": 2}),
    # or a callable world size -> {axis: size}, so that an elastic resize
    # rebuilds the next cycle's mesh at the new world; None: dp over every
    # process of the world, or no mesh in a world of one
    mesh_axes: Union[None, Dict[str, int],
                     Callable[[int], Dict[str, int]]] = None
    # the mesh axis the sequence is split over (e.g. "sp"): the loss takes
    # this rank's block of each sequence (parallel.train)
    seq_axis: Optional[str] = None
    # sharding rules, (regex, spec) pairs (parallel.sharding): rules over
    # ep, tp or fsdp split their leaves on a mesh with that axis; axes the
    # mesh lacks are dropped
    rules: Optional[list] = None
    # input contract under dp: False = make_batch returns the GLOBAL
    # batch, the same on every rank, and each rank keeps its dp block;
    # True = make_batch returns only this rank's dp block
    host_local_batches: bool = False


class _Observer:
    """The observability of one :func:`run_training` call, the
    reference's runner telemetry: the adopted incident, the worker
    ``/metrics`` server, the step profile, the straggler detector, the
    examples/s baseline, the hardware plane and the badput by cause,
    kept across the run's cycles."""

    def __init__(self, job: TrainJob, cfg: LaunchConfig,
                 dev: torch.device, result: Dict[str, Any]) -> None:
        self.job, self.cfg, self.result = job, cfg, result
        self.trc = tracer()
        # a pod made while its job's recovery incident was open carries
        # the operator's context; a missing or mangled one gives plain,
        # uncorrelated tracing
        self.ctx = SpanContext.decode(
            os.environ.get("TPUJOB_TRACE_CONTEXT", ""))
        if self.ctx is not None:
            set_incident_context(self.ctx)
            self.trc.event("incident_adopted", cause=self.ctx.cause,
                           job=self.ctx.job or None, worker=cfg.worker_id)
        self.metrics = self._serve_metrics()
        self.profiler = StepProfiler()
        self.detector = StragglerDetector(k=job.straggler_k)
        self.tput = ThroughputBaseline()
        self.badput: Dict[str, float] = {}
        self.wall = self.good = 0.0
        self.hw = HardwarePlane(resolve_chip(dev), device=dev)
        if job.flops_per_step:
            self.hw.set_cost(analytic_cost(job.flops_per_step,
                                           job.bytes_per_step or 0.0))
        self.clock = StepClock(self.hw, dev)
        self._compile_s0 = compile_cache.stats()["compile_seconds"]
        self.step_cost_sources: list = []
        result["straggler_events"] = 0
        result["backend_degraded_events"] = 0

    def _serve_metrics(self) -> Optional[WorkerMetricsServer]:
        port = self.job.metrics_port
        if port is None:
            env_port = os.environ.get("TPUJOB_WORKER_METRICS_PORT", "")
            if env_port:
                try:
                    port = int(env_port)
                except ValueError:
                    log.warning("ignoring unparseable "
                                "TPUJOB_WORKER_METRICS_PORT=%r", env_port)
        if port is None:
            return None
        try:
            srv = WorkerMetricsServer(":%d" % port).start()
        except (OSError, OverflowError) as e:
            # a taken port degrades to training without metrics, as the
            # reference's (OverflowError: a port outside 0-65535)
            log.warning("worker metrics endpoint disabled: bind :%d "
                        "failed (%s)", port, e)
            return None
        self.result["worker_metrics_url"] = srv.url
        log.info("worker metrics at %s/metrics", srv.url)
        return srv

    def add_badput(self, cause: str, seconds: float) -> None:
        if seconds > 0:
            self.badput[cause] = self.badput.get(cause, 0.0) + seconds

    def incident_stage(self, stage: str, seconds: float) -> None:
        if self.ctx is not None and seconds > 0:
            self.trc.event("incident_stage", stage=stage,
                           dur_s=round(seconds, 6), plane="runner",
                           job=self.ctx.job or None)

    def stepped(self, step: int, epoch: int, since: float) -> None:
        """After a step: its ``train_step`` event; the first good step
        after an adopted incident ends it (its ``warmup`` stage, from the
        loop's start, and ``incident_first_step``), and stamping stops."""
        self.trc.event("train_step", step=step, epoch=epoch)
        if self.ctx is None:
            return
        self.incident_stage("warmup", time.perf_counter() - since)
        ctx, self.ctx = self.ctx, None
        self.trc.event("incident_first_step", step=step,
                       job=ctx.job or None)
        clear_incident_context()

    def boundary(self, pstep: int, rate: float, loss: float,
                 examples: int, queue_depth: int) -> None:
        """A resolved log boundary: the examples/s baseline and the
        gauges."""
        eps = rate * examples
        if examples > 0 and self.tput.observe(eps) == "degraded":
            log.warning("backend degraded: %.3g examples/s vs own "
                        "baseline %.3g", eps, self.tput.baseline)
            self.trc.event("backend_degraded", step=pstep,
                           examples_per_s=round(eps, 6),
                           baseline=round(self.tput.baseline, 6))
            self.result["backend_degraded_events"] += 1
            if self.metrics is not None:
                self.metrics.inc("tpujob_worker_backend_degraded_total")
        if self.metrics is None:
            return
        cost = self.hw.cost
        self.metrics.update(
            steps_total=pstep, steps_per_second=rate,
            examples_per_second=eps, loss=loss,
            loader_queue_depth=queue_depth,
            # MFU at this boundary's readback-synced rate; an intensity
            # only from a bytes figure (a 0 would read as memory-bound)
            mfu=self.hw.mfu_of_rate(rate),
            arithmetic_intensity=(
                cost.arithmetic_intensity
                if cost.source != "unavailable"
                and cost.bytes_accessed > 0 else None))
        self.metrics.set_hbm(self.hw.sample_hbm())

    def straggler_check(self, at_step: int, mesh: Optional[Mesh]) -> None:
        """This rank's dispatch p50 against the gang's: the injected
        view, or an all-gather over the world (every rank calls this at
        the same log boundary, so the collective is aligned)."""
        own = self.profiler.p50("dispatch")
        if self.job.gang_p50_source is not None:
            if own <= 0.0:
                return
            gang = self.job.gang_p50_source(own)
            me: Any = self.cfg.worker_id
        elif mesh is not None and mesh.size > 1:
            gang = dict(enumerate(collectives.gather_floats(own,
                                                            mesh.control)))
            me = mesh.rank
            if own <= 0.0:
                return
        else:
            return
        self.result["gang_p50"] = dict(gang or {})
        if me in self.detector.evaluate(gang or {}):
            # the median the detector held the gang to
            self.trc.event("straggler", step=at_step, p50=round(own, 6),
                           gang_median=round(median(list(gang.values())),
                                             6))
            self.result["straggler_events"] += 1
            if self.metrics is not None:
                self.metrics.inc("tpujob_straggler_total")

    def cycle_end(self, since: float, host_stages: Dict[str, Any]) -> None:
        """Bank a cycle: its wall from ``since``, its step dispatch as
        goodput, the device times still pending; publish the breakdowns."""
        self.clock.drain(wait=True)
        self.wall += time.perf_counter() - since
        self.good += host_stages.get("step_dispatch", {}).get("ms",
                                                              0.0) / 1e3
        if self.metrics is not None:
            self.metrics.set_stage_summary(host_stages)
            self.metrics.set_step_stats(self.profiler.stats())
            self.metrics.set_badput(self.badput)
            if self.wall > 0:
                self.metrics.update(goodput_ratio=min(1.0,
                                                      self.good / self.wall))

    def close(self) -> None:
        """The incident stamp never outlives the run; stop the server."""
        clear_incident_context()
        if self.metrics is not None:
            self.metrics.stop()

    def finish(self) -> None:
        """The run's ``goodput``, ``step_profile``, ``hardware`` and
        ``goodput_detail``: wall == goodput + the sum of badput, the
        causes scaled into the non-productive remainder where they
        overlap the dispatch (a kernel built inside the first step) and
        the unnamed rest reported as ``host_other``."""
        result = self.result
        if self.wall > 0:
            result["goodput"] = round(min(1.0, self.good / self.wall), 4)
        result["step_profile"] = self.profiler.stats()
        self.hw.sample_hbm()
        result["hardware"] = self.hw.emit_trace()
        block = compile_cache.startup_block()
        block["step_cost"] = list(self.step_cost_sources)
        result["compile_cache"] = block
        self.add_badput("compile",
                        block["compile_seconds"] - self._compile_s0)
        wall = self.wall
        if wall <= 0:
            return
        good = min(self.good, wall)
        avail = max(0.0, wall - good)
        named = sum(self.badput.values())
        scale = (avail / named) if named > avail and named > 0 else 1.0
        badput_s = {cause: round(s * scale, 6)
                    for cause, s in sorted(self.badput.items())
                    if s * scale > 1e-9}
        other = max(0.0, avail - sum(badput_s.values()))
        if other > 1e-9:
            badput_s["host_other"] = round(other, 6)
        result["goodput_detail"] = {
            "wall_s": round(wall, 6),
            "goodput_s": round(good, 6),
            "ratio": round(good / wall, 4),
            "badput_s": badput_s,
        }


def run_training(job: TrainJob, cfg: Optional[LaunchConfig] = None,
                 init_distributed: bool = True,
                 poll_interval: float = 2.0) -> Dict[str, Any]:
    """Train to ``job.total_steps`` (from the newest checkpoint, if any),
    elastically if ``cfg`` names an elastic server.

    Returns ``{"state", "steps", "cycles", "loss", "host_stages",
    "mesh_history", "cycle_stages"}``, plus ``"resume_steps"`` after a
    restore, ``"drained"``/``"drain_step"`` after a drain (and
    ``"drain_reason": "migrate"`` after a MOVE, with
    ``"migrate_published": {"fp", "step"}`` once its cut is published),
    ``"migrate_prefetched_step"`` when a MOVE's state was pre-staged,
    ``"migrate_stages"`` with the host seconds of the publish
    (``publish_s``) and the pre-stage (``prestage_s``), and
    ``"left_at_epoch"`` on a worker that an elastic shrink removed.
    ``cycle_stages`` holds, a cycle each, its epoch, world, first and
    last step, its host seconds by part (the rendezvous with its mesh,
    the step build, the restore, the interrupt save and the leave) and,
    for a cycle that stopped early, the ``time.perf_counter()`` of the
    stop decision. The observability keys are the reference's:
    ``"goodput"``, ``"goodput_detail"`` (``wall_s``, ``goodput_s``,
    ``ratio``, ``badput_s`` by cause), ``"step_profile"`` (each phase's
    p50, p90, p99, mean and count), ``"hardware"`` (the block of
    :class:`.obs.hardware.HardwarePlane`), ``"straggler_events"``,
    ``"backend_degraded_events"``, ``"worker_metrics_url"`` when the
    endpoint is up, and ``"gang_p50"``, the last gang view a straggler
    check held this rank against.

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
        job.drain_signals,
        migrate_file=os.environ.get("TPUJOB_MIGRATE_FILE", ""))
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
        t = since = time.perf_counter()
        formed = world_of is not None and world_of.join(world, epoch)
        try:
            axes = job.mesh_axes(world) if callable(job.mesh_axes) \
                else job.mesh_axes
            mesh = _cycle_mesh(axes, elastic=callable(job.mesh_axes))
            # the agreement on (np, epoch), the group and its mesh
            stages["rendezvous_s"] = time.perf_counter() - t + (
                world_of.agree_s if world_of is not None else 0.0)
            return _train(job, cfg, dev, mesh, epoch, should_stop, result,
                          stages, writer, drain, obs, since)
        finally:
            t = time.perf_counter()
            if formed:
                world_of.leave()
            stages["leave_s"] = time.perf_counter() - t

    obs = _Observer(job, cfg, dev, result)
    made = False
    try:
        # a pod that receives a MOVE pulls the source's cut in before the
        # first cycle's restore looks for it
        _prestage(job, result, obs)
        made = not cfg.is_elastic and init_distributed and \
            initialize_distributed(cfg, device=job.device)
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
        obs.close()
        shutdown_distributed(made)
    obs.finish()
    return result


def _prestage(job: TrainJob, result: Dict[str, Any],
              obs: _Observer) -> None:
    """The destination's side of a MOVE: with
    ``TPUJOB_MIGRATE_STATE="ns/name:step"``, fetch that state bundle into
    ``job.checkpoint_dir`` (all or nothing, :func:`.artifacts.state.
    fetch_state`). A spec that does not parse is ignored; a miss or a
    poisoned member falls back to the durable checkpoint."""
    spec = os.environ.get("TPUJOB_MIGRATE_STATE", "")
    if not spec or not job.checkpoint_dir:
        return
    try:
        mjob, _, mstep_s = spec.rpartition(":")
        mns, _, mname = mjob.partition("/")
        mstep = int(mstep_s)
    except ValueError:
        log.warning("ignoring unparseable TPUJOB_MIGRATE_STATE=%r", spec)
        return
    store = get_store()
    if store is None or not mns or not mname:
        log.warning("TPUJOB_MIGRATE_STATE=%r: no artifact store or job "
                    "key; resuming from the durable checkpoint", spec)
        return
    t = time.perf_counter()
    got = fetch_state(store, state_fingerprint(mns, mname, mstep),
                      job.checkpoint_dir, mstep)
    result.setdefault("migrate_stages", {})["prestage_s"] = \
        time.perf_counter() - t
    if got is None:
        log.warning("migration pre-stage miss for %s step %d; falling "
                    "back to the durable checkpoint", mjob, mstep)
        return
    log.info("pre-staged %s step %d from the artifact store", mjob, mstep)
    obs.incident_stage("prestage", result["migrate_stages"]["prestage_s"])
    obs.trc.event("migrate_prestage", step=mstep, job=mjob)
    result["migrate_prefetched_step"] = mstep


def _publish_move(job: TrainJob, intent: dict, step: int,
                  result: Dict[str, Any], obs: _Observer) -> None:
    """The source's side of a MOVE, once the drain's cut has landed:
    publish ``step`` as a state bundle under the intent's job key. A
    missing key, checkpoint dir or store publishes nothing; the drain
    stays clean either way."""
    ns, name = str(intent.get("namespace", "")), str(intent.get("name", ""))
    store = get_store()
    if not (ns and name and job.checkpoint_dir) or store is None:
        log.warning("MOVE at step %d publishes nothing (intent %r, "
                    "store %s)", step, intent,
                    "set" if store is not None else "unset")
        return
    t = time.perf_counter()
    fp = publish_state(store, ns, name, step, job.checkpoint_dir)
    result.setdefault("migrate_stages", {})["publish_s"] = \
        time.perf_counter() - t
    if fp is not None:
        log.info("MOVE: published step %d of %s/%s", step, ns, name)
        obs.incident_stage("prestage", result["migrate_stages"]["publish_s"])
        obs.trc.event("migrate_publish", step=step, fp=fp)
        result["migrate_published"] = {"fp": fp, "step": step}


def _cached_step_cost(fn: Callable, state: Any, batch: Any,
                      mesh: Optional[Mesh], span: int, job: TrainJob
                      ) -> Tuple[str, Optional[StepCost]]:
    """The step-cost rung: the step's fingerprint (over its function,
    the shapes of ``(state, batch)``, the steps a call and the job's bytes
    figure, and the mesh) and the cost a cycle of the same step saved
    under it, or None (a miss; a torn or malformed sidecar is a miss).
    Telemetry never takes the run down: a fingerprint that cannot be
    taken is a miss that saves nothing."""
    try:
        key = compile_cache.step_fingerprint(
            fn, (state, batch), mesh=mesh,
            config={"steps_per_call": span,
                    "bytes_per_step": job.bytes_per_step or 0.0})
    except Exception as e:
        log.warning("step fingerprint unavailable (%s); counting the "
                    "step", e)
        return "", None
    raw = compile_cache.load_step_cost(key)
    try:
        if raw and float(raw.get("flops") or 0) > 0:
            return key, StepCost(float(raw["flops"]),
                                 max(0.0, float(raw.get("bytes") or 0.0)),
                                 str(raw.get("source") or "flop_counter"))
    except (TypeError, ValueError):
        log.warning("step-cost sidecar %s unreadable; counting the step",
                    key[:12])
    return key, None


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
           drain: DrainMonitor, obs: _Observer, since: float) -> bool:
    """One cycle: build the step on ``mesh``, restore the newest
    checkpoint, train until done (True) or until the boundary decision
    says drain (True) or restart (False), cutting a checkpoint first.
    ``since``: the cycle's start, from which ``obs`` banks its wall."""
    result["mesh_history"].append(dict(mesh.shape) if mesh is not None
                                  else None)
    multi = mesh is not None and mesh.size > 1

    def save(step: int, state: Any) -> None:
        """Several ranks: every rank writes the sharded format, in step,
        synchronously (it meets barriers anyway); one: worker 0 writes v2
        on the background thread, or synchronously without
        ``async_checkpoint``, or the sharded format with
        ``sharded_checkpoint``."""
        if multi:
            save_checkpoint_sharded(job.checkpoint_dir, step, state,
                                    meta={"epoch": epoch}, group=mesh.control,
                                    tiles=layout, coords=mesh.coords())
        elif cfg.worker_id != 0:
            return
        elif job.sharded_checkpoint:
            save_checkpoint_sharded(job.checkpoint_dir, step, state,
                                    meta={"epoch": epoch})
        elif job.async_checkpoint:
            writer.save(job.checkpoint_dir, step, state,
                        meta={"epoch": epoch})
        else:
            save_checkpoint(job.checkpoint_dir, step, state,
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
    # examples a step for the throughput gauge: the leading batch dim
    # (times the microbatches of a [accum, mb, ...] batch)
    shape = tuple(getattr(bridge.leaves(sample)[0], "shape", ()))
    examples = int(shape[0]) if shape else 0
    if job.accum_steps > 1 and len(shape) > 1:
        examples *= int(shape[1])
    loss_fn = bind_mesh(job.loss_fn, mesh)
    # the loader hands each rank its block, so the step takes it as is
    build = dict(merge_stats=job.merge_stats, grad_clip=job.grad_clip,
                 accum_steps=job.accum_steps, mesh=mesh, rules=job.rules,
                 seq_axis=job.seq_axis, host_local_batches=True)
    step_fn, state = build_train_step(loss_fn, job.optimizer, params,
                                      sample, steps_per_call=K, **build)
    del params
    # this rank's tiles of the leaves the rules split: the first replica
    # of each writes it, and each rank restores its own
    layout = step_fn.layout
    single_fn = None   # for a tail shorter than K, built on first use
    stages["build_s"] = time.perf_counter() - t
    obs.incident_stage("compile", stages["build_s"])

    t = time.perf_counter()
    start_step = 0
    manifest = None
    if job.checkpoint_dir:
        try:
            restored, manifest = restore_latest(
                job.checkpoint_dir,
                group=mesh.control if mesh is not None else None,
                tiles=layout if multi else None)
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
    if manifest is not None:
        # the whole restore (read, verify, place) is restore badput
        obs.add_badput("restore", stages["restore_s"])
        obs.incident_stage("restore", stages["restore_s"])
    stages["start_step"] = stages["end_step"] = start_step

    times = StageTimes()
    deferred = DeferredMetrics()
    prof = profile_steps()
    t0 = time.perf_counter()

    def log_boundary(step: int, metrics: Any) -> None:
        """Start this boundary's readback and log the previous one's,
        whose wait is the d2h phase."""
        t_d2h = time.perf_counter()
        log_resolved(deferred.start(step, metrics), t_d2h)

    def log_resolved(resolved, t_d2h: float) -> None:
        """Log a boundary whose metrics were started at the previous one."""
        if resolved is None:
            return
        pstep, t_submit, host = resolved
        rate = (pstep - start_step) / max(t_submit - t0, 1e-9)
        loss = float(host["loss"])
        log.info("step %d loss=%.4f steps/s=%.2f", pstep, loss, rate)
        obs.profiler.record(pstep, d2h=time.perf_counter() - t_d2h)
        obs.boundary(pstep, rate, loss, examples, loader.queue_depth())

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
        device=dev, timings=times, prefetch=job.prefetch)
    t_dispatched = None
    counted = False   # the cycle's first call is counted for its FLOPs

    def dispatch(fn: Callable, state: Any, at_step: int, span: int = 1):
        """One step_fn call: the batch wait (data_stall badput and the
        data_wait phase), the gap since the previous call, the call timed
        on the host and on the device's clock, and the step's phases
        (``dispatch`` is the host time outside the collectives, which are
        ``collective``: a rank waiting on a slow peer waits there)."""
        nonlocal t_dispatched, counted
        t_f0 = time.perf_counter()
        batch = next(loader)
        wait = time.perf_counter() - t_f0
        times.add("data_wait", wait)
        obs.add_badput("data_stall", wait)
        if t_dispatched is not None:
            times.add("dispatch_gap", time.perf_counter() - t_dispatched)
        cached, key = None, ""
        if not counted:
            key, cached = _cached_step_cost(fn, state, batch, mesh, span, job)
        c0 = collectives.host_seconds()
        begun = obs.clock.begin()
        t_d0 = time.perf_counter()
        with times.timed("step_dispatch"):
            if counted or cached is not None:
                out = fn(state, batch)
            else:
                out, cost = step_cost_of(
                    fn, state, batch, steps_per_call=span,
                    bytes_per_step=job.bytes_per_step or 0.0)
        t_dispatched = time.perf_counter()
        if not counted:
            counted = True
            if cached is not None:
                obs.hw.set_cost(cached)
                obs.step_cost_sources.append("cache")
            else:
                obs.hw.set_cost(cost)
                obs.step_cost_sources.append("counted")
                if cost is not None and key:
                    compile_cache.save_step_cost(key, {
                        "flops": cost.flops, "bytes": cost.bytes_accessed,
                        "source": cost.source})
        obs.clock.end(begun, span)
        waited = collectives.host_seconds() - c0
        phases = {"data_wait": wait,
                  "dispatch": max(0.0, t_dispatched - t_d0 - waited)}
        if multi:
            phases["collective"] = waited
        obs.profiler.record(at_step, **phases)
        return out

    metrics: Dict[str, Any] = {}
    step = start_step
    last_saved = -1
    try:
        while step < job.total_steps:
            k_here = min(K, job.total_steps - step)
            prof.before(step, span=k_here)
            if k_here == K:
                state, metrics = dispatch(step_fn, state, step, span=K)
                if K > 1:
                    metrics = {k: v[-1] for k, v in metrics.items()}
            else:
                if single_fn is None:
                    single_fn, _ = build_train_step(
                        loss_fn, job.optimizer, state["params"], sample,
                        init_state=False, tiles=layout, **build)
                for i in range(k_here):
                    state, metrics = dispatch(single_fn, state, step + i)
            prof.after(step, span=k_here)
            step += k_here
            obs.stepped(step, epoch, t0)
            if job.log_every and step % job.log_every < k_here:
                log_boundary(step, metrics)
                obs.straggler_check(step, mesh if multi else None)
                obs.trc.event("step_profile", step=step, **{
                    ph: st["p50"] for ph, st in obs.profiler.stats().items()})
            if job.checkpoint_dir and step % job.checkpoint_every < k_here:
                t = time.perf_counter()
                with times.timed("checkpoint"):
                    save(step, state)
                ck_s = time.perf_counter() - t
                obs.add_badput("checkpoint", ck_s)
                obs.profiler.record(step, checkpoint=ck_s)
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
            log_resolved(deferred.resolve(), time.perf_counter())
            if job.checkpoint_dir:
                t = time.perf_counter()
                # the periodic save may have covered this step already;
                # the write must be durable before the next cycle reads it
                if last_saved != step:
                    save(step, state)
                writer.wait()
                stages["interrupt_save_s"] = time.perf_counter() - t
                obs.add_badput("checkpoint", stages["interrupt_save_s"])
            if not drained:
                return False
            obs.trc.event("drain_exit", step=step, epoch=epoch)
            result["drained"] = True
            result["drain_step"] = step
            intent = drain.migrate_intent()
            if intent is not None:
                # a MOVE: the cut has landed (writer.wait above); a world
                # of one publishes it, as the reference's one process does
                result["drain_reason"] = "migrate"
                if not multi and cfg.worker_id == 0:
                    _publish_move(job, intent, step, result, obs)
            break
    finally:
        # a step that raised inside the window still writes its trace,
        # and the producer thread never outlives the cycle
        prof.close()
        loader.close()
        result["host_stages"] = times.summary()
        obs.cycle_end(since, result["host_stages"])
    log_resolved(deferred.resolve(), time.perf_counter())
    if metrics:
        result["loss"] = float(metrics["loss"])
    return True
