"""In-pod bootstrap: ``python -m paddle_operator_tpu_torch.launch train.py``.

The port of ``paddle_operator_tpu/launch.py``. :func:`detect_env` reads
the env the operator injects (``TPU_WORKER_ID`` per pod,
``TPU_WORKER_HOSTNAMES`` / ``TPUJOB_COORDINATOR`` from the ConfigMap
barrier, with ``PADDLE_*`` names accepted for parity) into a
:class:`LaunchConfig`: the rank, the world size, the coordinator, the
role and the parameter servers of PS mode (``TRAINING_ROLE``,
``PADDLE_PSERVERS_IP_PORT_LIST``) and the elastic job's server, id and
timeout.
:func:`initialize_distributed` brings every worker into one
``torch.distributed`` process group at ``tcp://<coordinator>``: NCCL on
CUDA, gloo on the CPU; a world of one process is a no-op.
:func:`main` detects the env, initialises (over NCCL, or the backend
``TPUJOB_DIST_BACKEND`` names), runs the script as ``__main__`` and
destroys the group it made. PS pods do not go through :func:`main`: they
run their script directly (``examples/train_wide_deep_ps.py``), which
dispatches on the role.

Elastic jobs (``TPUJOB_ELASTIC_SERVER`` set): :class:`ElasticAgent`
watches the job's ``np``/``epoch`` keys and drives the runner's restart
cycles, and :class:`ElasticWorld` forms a new process group of ``np``
ranks at each cycle, so :func:`main` forms none for them.
"""

from __future__ import annotations

import datetime
import os
import runpy
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .device import DeviceLike, resolve_device
from .elastic.store import KVStore, connect as kv_connect
from .elastic.sync import JobRef, epoch_key, np_key


@dataclass
class LaunchConfig:
    """The launch fields the runner and the parameter-server mode
    (:mod:`.ps`) read. The multislice fields of the JAX package's config
    wait for the slice that uses them."""

    worker_id: int = 0             # GLOBAL rank across all slices
    num_workers: int = 1           # total hosts across all slices
    coordinator: str = ""          # host:port of slice-0 worker-0
    role: str = "TRAINER"          # TRAINING_ROLE: TRAINER or PSERVER
    # PS mode (operator env PADDLE_PSERVERS_IP_PORT_LIST): host:port of
    # every parameter server; read by ps.run_ps_training
    ps_endpoints: List[str] = field(default_factory=list)
    job_id: str = ""               # "{namespace}-{name}" of the elastic job
    elastic_server: str = ""
    elastic_timeout: float = 60.0  # seconds a cycle's world may take to form

    @property
    def is_distributed(self) -> bool:
        return self.num_workers > 1

    @property
    def is_elastic(self) -> bool:
        return bool(self.elastic_server)


def _env(*names: str, default: str = "") -> str:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return default


def detect_env(environ: Optional[dict] = None) -> LaunchConfig:
    """Build a LaunchConfig from operator-injected env (TPU names first,
    PADDLE_* parity names second)."""
    if environ is not None:
        saved = os.environ
        os.environ = environ  # type: ignore[assignment]
    try:
        hostnames_s = _env("TPU_WORKER_HOSTNAMES")
        hostnames = [h for h in hostnames_s.split(",") if h] if hostnames_s else []
        if not hostnames:
            eps = _env("PADDLE_TRAINER_ENDPOINTS")
            hostnames = [e.split(":")[0] for e in eps.split(",") if e]

        # Multislice: TPU_WORKER_HOSTNAMES / TPU_WORKER_ID are slice-local;
        # TPUJOB_* are the global world. With only MEGASCALE_* + slice-local
        # env, scale the fallbacks by the slice count, so a multislice
        # launch counts its whole world (and the runner refuses it).
        num_slices = int(_env("MEGASCALE_NUM_SLICES", default="1"))
        slice_id = int(_env("MEGASCALE_SLICE_ID", default="0"))
        hosts_per_slice = max(len(hostnames), 1)
        num_workers = int(
            _env("TPUJOB_NUM_WORKERS", "PADDLE_TRAINERS_NUM", default="0")
        ) or hosts_per_slice * num_slices

        coordinator = _env("TPUJOB_COORDINATOR")
        if not coordinator:
            port = _env("PADDLE_PORT", default="2379")
            host = ""
            if num_slices > 1:
                # slice-local hostnames[0] is the wrong host on slices > 0;
                # without a slice-0 address, fail rather than rendezvous
                # divergent per-slice worlds that hang at init
                mca = _env("MEGASCALE_COORDINATOR_ADDRESS")
                if not mca:
                    raise RuntimeError(
                        "multislice launch needs TPUJOB_COORDINATOR or "
                        "MEGASCALE_COORDINATOR_ADDRESS; slice-local hostnames "
                        "cannot name the slice-0 coordinator"
                    )
                host = mca.split(":")[0]
            if not host and hostnames:
                host = hostnames[0]
            if host:
                coordinator = "%s:%s" % (host, port)

        worker_id_s = _env("TPUJOB_WORKER_ID", "PADDLE_TRAINER_ID")
        if worker_id_s:
            worker_id = int(worker_id_s)
        else:
            worker_id = int(_env("TPU_WORKER_ID", default="0"))
            if num_slices > 1:
                worker_id += slice_id * hosts_per_slice
        return LaunchConfig(
            worker_id=worker_id,
            num_workers=num_workers,
            coordinator=coordinator,
            role=_env("TRAINING_ROLE", default="TRAINER"),
            ps_endpoints=[
                e for e in _env("PADDLE_PSERVERS_IP_PORT_LIST").split(",")
                if e],
            job_id=_env("PADDLE_ELASTIC_JOB_ID", "TPUJOB_JOB_ID"),
            elastic_server=_env("TPUJOB_ELASTIC_SERVER", "PADDLE_ELASTIC_SERVER"),
            elastic_timeout=float(_env("PADDLE_ELASTIC_TIMEOUT", default="60")),
        )
    finally:
        if environ is not None:
            os.environ = saved  # type: ignore[assignment]


def initialize_distributed(cfg: LaunchConfig, device: DeviceLike = None,
                           backend: Optional[str] = None) -> bool:
    """Join the ``torch.distributed`` world the operator's env describes:
    ``init_process_group`` at ``tcp://<coordinator>`` with
    ``world_size=num_workers`` and ``rank=worker_id``, over ``backend``
    (default: NCCL for workers on CUDA, gloo on the CPU; ``device=None``
    means CUDA). Every worker must call it with the same coordinator and
    world size: the ConfigMap barrier materialises the env only once
    every pod has an address.

    An NCCL worker takes card ``worker_id % device_count()`` as its
    current device. A world of one process is a no-op. A group that is
    already up (the launcher made it) is kept if it has this rank and
    size, else this raises. Returns True only when this call made the
    group, so that its caller, and only it, destroys it
    (:func:`shutdown_distributed`)."""
    if not cfg.is_distributed:
        return False
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (cfg.worker_id,
                                                        cfg.num_workers):
            raise RuntimeError(
                "a process group of rank %d/%d is up, the env says %d/%d"
                % (dist.get_rank(), dist.get_world_size(), cfg.worker_id,
                   cfg.num_workers))
        return False
    if not cfg.coordinator:
        raise RuntimeError(
            "a %d-worker world needs a coordinator (TPUJOB_COORDINATOR, or "
            "TPU_WORKER_HOSTNAMES / PADDLE_TRAINER_ENDPOINTS with "
            "PADDLE_PORT)" % cfg.num_workers)
    dist.init_process_group(
        _backend(cfg.worker_id, device, backend, "initialize_distributed"),
        init_method="tcp://%s" % cfg.coordinator,
        world_size=cfg.num_workers, rank=cfg.worker_id)
    return True


def _backend(rank: int, device: DeviceLike, backend: Optional[str],
             who: str) -> str:
    """``backend``, or NCCL for workers on CUDA and gloo on the CPU. An
    NCCL worker takes card ``rank % device_count()`` as its current
    device."""
    if backend is None:
        cuda = resolve_device(device, who).type == "cuda"
        backend = "nccl" if cuda else "gloo"
    if backend == "nccl" and torch.cuda.is_available():
        # one card a worker: a pod that sees one card takes it; workers
        # that share a host with a card each take card rank % cards
        torch.cuda.set_device(rank % torch.cuda.device_count())
    return backend


def shutdown_distributed(made: bool) -> None:
    """Destroy the process group if ``made`` (what
    :func:`initialize_distributed` returned)."""
    if made and dist.is_initialized():
        dist.destroy_process_group()


def env_backend() -> Optional[str]:
    """The backend ``TPUJOB_DIST_BACKEND`` names (gloo: CPU workers, or
    several workers sharing one card, which NCCL refuses), else None."""
    return os.environ.get("TPUJOB_DIST_BACKEND") or None


class ElasticAgent:
    """Watches membership np/epoch; drives restart-from-checkpoint cycles.

    Protocol (operator side in :mod:`.elastic.sync`): the controller
    writes the desired world size to ``np`` and bumps ``epoch`` whenever
    it changes. Workers poll; when the epoch moves past the one they
    trained under, the current training run is asked to stop (via the
    ``should_stop`` callable handed to ``train_fn``), the agent re-reads
    the world, and calls ``train_fn`` again, which resumes from the
    newest checkpoint."""

    def __init__(self, cfg: LaunchConfig, store: Optional[KVStore] = None,
                 poll_interval: float = 2.0):
        self.cfg = cfg
        self.store = store or kv_connect(cfg.elastic_server.split(",")[0])
        self.poll_interval = poll_interval
        job = JobRef.of(cfg.job_id)
        self._np_key = np_key(*job)
        self._epoch_key = epoch_key(*job)

    def read_world(self) -> Tuple[int, int]:
        """``(np, epoch)`` from the store, ``(num_workers, 0)`` where a key
        is missing."""
        np_v = self.store.get(self._np_key)
        epoch_v = self.store.get(self._epoch_key)
        return (int(np_v) if np_v else self.cfg.num_workers,
                int(epoch_v) if epoch_v else 0)

    def run(self, train_fn: Callable,
            agree: Optional[Callable] = None) -> int:
        """Run train cycles until training reports completion.

        ``train_fn(world_size, epoch, should_stop) -> bool`` returns True
        when training is COMPLETE (not merely interrupted).
        ``should_stop()`` re-reads the epoch at most once every
        ``poll_interval`` seconds, so it is cheap at every step boundary.
        ``agree(world, epoch, read_world)``, if given, turns the
        ``(np, epoch)`` this process read into the one every process of
        the cycle takes (:meth:`ElasticWorld.agree`). Returns the cycles
        run."""
        cycles = 0
        while True:
            world, epoch = self.read_world()
            if agree is not None:
                world, epoch = agree(world, epoch, self.read_world)
            self._last_poll = 0.0

            def should_stop() -> bool:
                now = time.monotonic()
                if now - self._last_poll < self.poll_interval:
                    return False
                self._last_poll = now
                _, cur = self.read_world()
                return cur != epoch

            done = train_fn(world, epoch, should_stop)
            cycles += 1
            if done:
                return cycles


class ElasticWorld:
    """The ``torch.distributed`` world of an elastic job, formed anew at
    every cycle: ``jax.distributed`` cannot re-initialise, so the
    reference models a resize inside one process; here each cycle is a
    new process group of the cycle's ``np`` ranks, rank = ``worker_id``.

    One ``TCPStore`` serves the process's whole life, at the coordinator's
    address, with worker 0 as its server (a shrink removes the highest
    indices, as the operator scales its replicas down, so worker 0
    stays). On it the workers first agree on the cycle's ``(np, epoch)``
    (:meth:`agree`): each reads the membership store on its own, and two
    moves of the epoch close together could give two workers two
    epochs. Each cycle's group then rendezvouses under the prefix
    ``epoch/<epoch>``, so a straggler of one epoch never meets the next
    one, and no port is bound twice. The backend is the one
    ``TPUJOB_DIST_BACKEND`` names, else NCCL on CUDA and gloo on the
    CPU. ``cfg.elastic_timeout`` bounds the agreement on one epoch; the
    group's operations keep the library's timeout."""

    def __init__(self, cfg: LaunchConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = device
        self._store: Optional[dist.TCPStore] = None
        self.agree_s = 0.0   # seconds the last agreement took

    def _lifetime_store(self) -> dist.TCPStore:
        if self._store is None:
            host, _, port = self.cfg.coordinator.rpartition(":")
            self._store = dist.TCPStore(
                host, int(port), is_master=self.cfg.worker_id == 0,
                timeout=datetime.timedelta(seconds=self.cfg.elastic_timeout),
                wait_for_workers=False)
        return self._store

    def agree(self, world: int, epoch: int,
              read_world: Callable[[], Tuple[int, int]]) -> Tuple[int, int]:
        """The cycle's ``(np, epoch)``, the same on every worker that takes
        part, from the ``(world, epoch)`` this worker read.

        A worker of the world (``worker_id < world``) checks in under
        ``cycle/<epoch>`` of the lifetime store. The epoch is settled
        once, by whichever worker sees it first: *formed* when all
        ``world`` workers have checked in, *moved* when the membership
        store (``read_world``) has moved past it. Every worker that
        checked in takes the settled outcome: on *formed* this epoch is
        the cycle's, on *moved* each reads the world again and checks in
        at the new epoch. A worker outside the world (a shrink's leaver)
        does not check in; it leaves only once the epoch is formed, so
        that a move back to a larger world finds it. Without a
        coordinator (a world of one process) the read stands. Raises
        ``TimeoutError`` when an epoch is not settled within
        ``cfg.elastic_timeout`` seconds of reading it."""
        t0 = time.perf_counter()
        self.agree_s = 0.0
        if not self.cfg.coordinator:
            return world, epoch
        store = self._lifetime_store()
        while True:
            ranks, state = "cycle/%d/ranks" % epoch, "cycle/%d/state" % epoch
            member = self.cfg.worker_id < world
            if member:
                store.add(ranks, 1)
            deadline = time.monotonic() + self.cfg.elastic_timeout
            while True:
                if store.check([state]):
                    settled = store.get(state)
                elif member and store.add(ranks, 0) >= world:
                    settled = store.compare_set(state, "", "formed")
                elif read_world()[1] != epoch:
                    settled = store.compare_set(state, "", "moved")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        "epoch %d's world of %d workers did not form within "
                        "%.0f s (PADDLE_ELASTIC_TIMEOUT); %d checked in"
                        % (epoch, world, self.cfg.elastic_timeout,
                           store.add(ranks, 0)))
                else:
                    time.sleep(0.01)
                    continue
                break
            if settled == b"formed":
                self.agree_s = time.perf_counter() - t0
                return world, epoch
            world, epoch = read_world()

    def join(self, world: int, epoch: int) -> bool:
        """Form this cycle's group of ``world`` ranks (none for a world of
        one). Returns True when a group was formed."""
        if world <= 1:
            return False
        if dist.is_initialized():
            raise RuntimeError(
                "an elastic job forms its process group at every cycle, "
                "but one is already up (rank %d/%d)"
                % (dist.get_rank(), dist.get_world_size()))
        if not 0 <= self.cfg.worker_id < world:
            raise ValueError("worker %d is not a rank of a %d-worker world"
                             % (self.cfg.worker_id, world))
        if not self.cfg.coordinator:
            raise RuntimeError(
                "an elastic world of %d workers needs a coordinator "
                "(TPUJOB_COORDINATOR)" % world)
        dist.init_process_group(
            _backend(self.cfg.worker_id, self.device, env_backend(),
                     "ElasticWorld"),
            store=dist.PrefixStore("epoch/%d" % epoch, self._lifetime_store()),
            world_size=world, rank=self.cfg.worker_id)
        return True

    @staticmethod
    def leave() -> None:
        """Destroy the cycle's group and every subgroup made over it."""
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m paddle_operator_tpu_torch.launch SCRIPT "
              "[args...]", file=sys.stderr)
        return 2
    cfg = detect_env()
    print(
        "[tpujob.launch] worker %d/%d coordinator=%s elastic=%s"
        % (cfg.worker_id, cfg.num_workers, cfg.coordinator or "-",
           cfg.elastic_server or "-"),
        flush=True,
    )
    # an elastic job's runner forms a group at every cycle (ElasticWorld)
    made = not cfg.is_elastic and initialize_distributed(
        cfg, backend=env_backend())
    try:
        script, sys.argv = argv[0], argv
        runpy.run_path(script, run_name="__main__")
    finally:
        shutdown_distributed(made)
    return 0


if __name__ == "__main__":
    sys.exit(main())
