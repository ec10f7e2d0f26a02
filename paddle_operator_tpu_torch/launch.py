"""In-pod bootstrap: ``python -m paddle_operator_tpu_torch.launch train.py``.

The port of ``paddle_operator_tpu/launch.py``. :func:`detect_env` reads
the env the operator injects (``TPU_WORKER_ID`` per pod,
``TPU_WORKER_HOSTNAMES`` / ``TPUJOB_COORDINATOR`` from the ConfigMap
barrier, with ``PADDLE_*`` names accepted for parity) into a
:class:`LaunchConfig`: the rank, the world size, the coordinator, the
role and the parameter servers of PS mode (``TRAINING_ROLE``,
``PADDLE_PSERVERS_IP_PORT_LIST``) and the elastic server.
:func:`initialize_distributed` brings every worker into one
``torch.distributed`` process group at ``tcp://<coordinator>``: NCCL on
CUDA, gloo on the CPU; a world of one process is a no-op.
:func:`main` detects the env, initialises (over NCCL, or the backend
``TPUJOB_DIST_BACKEND`` names), runs the script as ``__main__`` and
destroys the group it made. PS pods do not go through :func:`main`: they
run their script directly (``examples/train_wide_deep_ps.py``), which
dispatches on the role. The elastic agent is not ported.
"""

from __future__ import annotations

import os
import runpy
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.distributed as dist

from .device import DeviceLike, resolve_device


@dataclass
class LaunchConfig:
    """The launch fields the runner and the parameter-server mode
    (:mod:`.ps`) read. The multislice and elastic fields of the JAX
    package's config wait for the slices that use them."""

    worker_id: int = 0             # GLOBAL rank across all slices
    num_workers: int = 1           # total hosts across all slices
    coordinator: str = ""          # host:port of slice-0 worker-0
    role: str = "TRAINER"          # TRAINING_ROLE: TRAINER or PSERVER
    # PS mode (operator env PADDLE_PSERVERS_IP_PORT_LIST): host:port of
    # every parameter server; read by ps.run_ps_training
    ps_endpoints: List[str] = field(default_factory=list)
    elastic_server: str = ""

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
            elastic_server=_env("TPUJOB_ELASTIC_SERVER", "PADDLE_ELASTIC_SERVER"),
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
    if backend is None:
        cuda = resolve_device(device, "initialize_distributed").type == "cuda"
        backend = "nccl" if cuda else "gloo"
    if backend == "nccl" and torch.cuda.is_available():
        # one card a worker: a pod that sees one card takes it; workers
        # that share a host with a card each take card rank % cards
        torch.cuda.set_device(cfg.worker_id % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method="tcp://%s" % cfg.coordinator,
        world_size=cfg.num_workers, rank=cfg.worker_id)
    return True


def shutdown_distributed(made: bool) -> None:
    """Destroy the process group if ``made`` (what
    :func:`initialize_distributed` returned)."""
    if made and dist.is_initialized():
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
    # NCCL unless TPUJOB_DIST_BACKEND names another (gloo: CPU workers,
    # or several workers sharing one card, which NCCL refuses)
    made = initialize_distributed(
        cfg, backend=os.environ.get("TPUJOB_DIST_BACKEND") or None)
    try:
        script, sys.argv = argv[0], argv
        runpy.run_path(script, run_name="__main__")
    finally:
        shutdown_distributed(made)
    return 0


if __name__ == "__main__":
    sys.exit(main())
