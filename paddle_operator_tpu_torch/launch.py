"""In-pod bootstrap: the port's copy of ``paddle_operator_tpu/launch.py``'s
environment detection.

:func:`detect_env` reads the env the operator injects (``TPU_WORKER_ID``
per pod, ``TPU_WORKER_HOSTNAMES`` from the ConfigMap barrier, with
``PADDLE_*`` names accepted for parity) into a :class:`LaunchConfig`
holding the rank, the world size and the elastic server.
:func:`initialize_distributed` is a no-op for a world of one process; a
larger world needs the data-parallel slice of the port
(``torch.distributed``), which is not ported yet, and raises. The elastic
agent is not ported either.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class LaunchConfig:
    """The launch fields the single-process runner reads. The multislice,
    parameter-server and elastic fields of the JAX package's config wait
    for the slices that use them."""

    worker_id: int = 0             # GLOBAL rank across all slices
    num_workers: int = 1           # total hosts across all slices
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
            elastic_server=_env("TPUJOB_ELASTIC_SERVER", "PADDLE_ELASTIC_SERVER"),
        )
    finally:
        if environ is not None:
            os.environ = saved  # type: ignore[assignment]


def initialize_distributed(cfg: LaunchConfig) -> None:
    """Bring up the process group for a multi-worker world. The port is
    single-process so far: a world of one is a no-op, a larger one
    raises."""
    if not cfg.is_distributed:
        return
    raise NotImplementedError(
        "the port trains on one process so far; a %d-worker world needs the "
        "data-parallel slice (torch.distributed), not ported yet"
        % cfg.num_workers)
