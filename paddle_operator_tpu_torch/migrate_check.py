"""The live-migration MOVE, checked: the destination's entry, and the
helpers of ``chip_smoke.py``'s train_migrate phase and of
``tests/test_torch_migrate.py``.

A MOVE has two sides. The source is a running job whose drain notice
carries a migrate intent: the operator writes ``{"namespace", "name"}``
to ``TPUJOB_MIGRATE_FILE`` (:class:`MigrateNotice` plays it, from a
step's loss call), and the runner drains at the next boundary, cuts the
checkpoint and publishes it as a state bundle through the artifact store
(``TPUJOB_ARTIFACT_URL``; ``TPUJOB_ARTIFACT_STORE=0`` keeps the local
tier out, so the bundle rides HTTP only). The destination is a new pod
that the operator starts with ``TPUJOB_MIGRATE_STATE=<ns>/<name>:<step>``
and a checkpoint dir the source never wrote::

    TPUJOB_MIGRATE_STATE=smoke/resnet50:13 \\
    TPUJOB_ARTIFACT_URL=http://127.0.0.1:<port> TPUJOB_ARTIFACT_STORE=0 \\
        python -m paddle_operator_tpu_torch.launch \\
            paddle_operator_tpu_torch/migrate_check.py SPEC.json

(:func:`launch` starts it so, a world of one of
:func:`.dp_check.launch_workers`). It runs the spec's scenarios in order
and prints one JSON line each: each step's loss as a float hex, the
restored steps, ``migrate_prefetched_step``, ``migrate_stages``, the
cycle's stages, the host clock at each step's start and end (each after
a device sync; ``time.perf_counter``, CLOCK_MONOTONIC on Linux, one clock
for every process of the machine), the clock when the process was ready
to train (its imports, the CUDA context and the B1 library loaded), the
kernel launches and a digest of the final state.

Jobs: ``resnet50`` (the chip phase's ResNet-50 v1.5 job, the one
``chip_smoke.phase_train`` runs, at the spec's depth, classes, image and
batch) and ``gpt_tiny`` (:func:`.elastic_check.gpt_tiny_job`, fp32 on the
CPU, the CPU tests' job).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from paddle_operator_tpu_torch import dp_check, elastic_check
from paddle_operator_tpu_torch.device import resolve_device
from paddle_operator_tpu_torch.launch import detect_env
from paddle_operator_tpu_torch.models import resnet
from paddle_operator_tpu_torch.ops import _kernels, optim
from paddle_operator_tpu_torch.parallel import sharding
from paddle_operator_tpu_torch.runner import TrainJob, run_training


class MigrateNotice:
    """The operator's drain notice for a MOVE: :meth:`request` writes the
    intent as JSON to the migrate file (tmp + rename, so the runner never
    reads half of it), or ``raw`` text in its place (a torn notice). An
    :class:`.elastic_check.Recorder` calls it from a step's loss call."""

    def __init__(self, path: str, intent: Optional[dict] = None,
                 raw: Optional[str] = None) -> None:
        self.path, self.intent, self.raw = path, intent, raw

    def request(self) -> None:
        text = self.raw if self.raw is not None else json.dumps(self.intent)
        tmp = "%s.tmp.%d" % (self.path, os.getpid())
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, self.path)


@contextlib.contextmanager
def environ(**env: Optional[str]):
    """``os.environ`` with ``env`` set (None: unset) for the block, every
    variable restored after it."""
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def resnet_optimizer(kind: str, total: int) -> optim.Optimizer:
    """``optim.<kind>`` (``fused_sgd``, B1, or ``sgd``) as the ResNet-50
    job takes it: ``cosine_schedule(0.4, total, total // 20 or 1)``,
    momentum 0.9, wd 1e-4."""
    sched = optim.cosine_schedule(0.4, total, max(1, total // 20))
    return getattr(optim, kind)(sched, momentum=0.9, weight_decay=1e-4)


def resnet_job(sc: dict, optimizer: Optional[optim.Optimizer] = None,
               make_batch=None) -> TrainJob:
    """ResNet v1.5 as ``chip_smoke.py``'s phases train it (their one
    definition): depth ``sc["depth"]``, ``sc["classes"]`` classes,
    ``sc["batch"]`` synthetic images of ``sc["image"]`` pixels a side
    from ``(seed 0, step)`` (or ``make_batch``), bf16 compute on fp32
    params, ``optimizer`` or else ``resnet_optimizer("fused_sgd",
    sc["schedule"])``, ``sc["steps"]`` steps, on the mesh ``sc["mesh"]``
    (default: none, or dp over a world of several) with the reference's
    ``resnet_rules()`` (the classifier split over an fsdp axis)."""
    depth, classes = sc["depth"], sc["classes"]
    image, batch = sc["image"], sc["batch"]
    return TrainJob(
        init_params=lambda gen: resnet.init(gen, depth, classes),
        loss_fn=resnet.loss_fn,
        optimizer=optimizer or resnet_optimizer("fused_sgd",
                                                sc["schedule"]),
        make_batch=make_batch or (lambda gen, step: resnet.synthetic_batch(
            gen, batch, image, classes)),
        merge_stats=resnet.merge_stats, total_steps=sc["steps"],
        log_every=10, seed=0, device=sc.get("device"),
        mesh_axes=sc.get("mesh"), rules=sharding.resnet_rules())


def make_job(sc: dict) -> TrainJob:
    """The scenario's job, checkpointing every ``sc["every"]`` steps into
    ``sc["ckpt_dir"]``."""
    if sc["model"] == "resnet50":
        job = resnet_job(sc)
    elif sc["model"] == "gpt_tiny":
        job = elastic_check.gpt_tiny_job(sc)
    else:
        raise ValueError("unknown model %r" % sc["model"])
    job.checkpoint_dir = sc["ckpt_dir"]
    job.checkpoint_every = sc["every"]
    return job


def run_scenario(sc: dict, keep_state: bool = False) -> Dict[str, Any]:
    """``run_training`` of the scenario's job under the env's launch
    config, in this process. A ``notice`` (``{"file", "intent"}`` or
    ``{"file", "raw"}``) is written during loss call ``notice["at"]``
    (step ``at + 1``). Returns the scenario's JSON line (with the final
    state under ``"state"`` when ``keep_state``)."""
    job = make_job(sc)
    drain, at = None, -1
    if sc.get("notice"):
        n = sc["notice"]
        drain, at = MigrateNotice(n["file"], n.get("intent"),
                                  n.get("raw")), n["at"]
    rec = job.loss_fn = elastic_check.Recorder(job.loss_fn, drain=drain,
                                               drain_at=at)
    job.optimizer = rec.wrap(job.optimizer)
    if resolve_device(job.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elastic_check.zero_counts()
    t0 = time.perf_counter()
    out = run_training(job, detect_env())
    line = {"steps": out.get("steps"),
            "resume_steps": out.get("resume_steps", []),
            "drained": out.get("drained", False),
            "drain_step": out.get("drain_step"),
            "drain_reason": out.get("drain_reason"),
            "migrate_published": out.get("migrate_published"),
            "migrate_prefetched_step": out.get("migrate_prefetched_step"),
            "migrate_stages": out.get("migrate_stages", {}),
            "cycle_stages": out["cycle_stages"],
            "losses": [float.hex(x.item()) for x in rec.losses],
            "clock": rec.clock, "done": rec.done, "started": t0,
            "launches": elastic_check.launches(),
            "wall_s": time.perf_counter() - t0}
    if "state" in out:
        line["final_digest"] = dp_check.digest(out["state"])
        if keep_state:
            line["state"] = out["state"]
    return line


def losses(line: dict) -> List[float]:
    """A line's per-step losses as floats."""
    return [float.fromhex(h) for h in line["losses"]]


def worker_main(spec_path: str) -> int:
    """The destination pod: make the CUDA context and load B1's library
    (on a machine with a card), then run the spec's scenarios, printing a
    line each with the clock when this process was ready to train."""
    with open(spec_path) as f:
        spec = json.load(f)
    if torch.cuda.is_available():
        torch.cuda.init()
        _kernels.load("fused_sgd")
    ready = time.perf_counter()
    for sc in spec["scenarios"]:
        line = run_scenario(sc)
        print(json.dumps({"scenario": sc["name"], "ready": ready, **line}),
              flush=True)
    return 0


def launch(spec: dict, env: Dict[str, str], timeout: float = 300.0
           ) -> Dict[str, dict]:
    """Start the destination pod, a world of one running this file's
    :func:`worker_main` under ``env`` (the operator's MOVE env), wait for
    it and return its lines by scenario, each with ``"spawned"``: the
    clock just before the process was started."""
    spawned = time.perf_counter()
    lines, = dp_check.launch_workers(
        spec, world=1, timeout=timeout, env=env,
        script=os.path.abspath(__file__))
    return {line["scenario"]: dict(line, spawned=spawned) for line in lines}


def blackout(src: dict, dst: dict) -> Dict[str, float]:
    """A MOVE's blackout in host seconds by part, from the end of the
    source's last step to the end of the destination's first step
    (docs/design.md "Live migration"): the source's drain save (the cut
    and the writer's drain), its publish (pack + PUT), the
    destination's process start with its CUDA context and kernel load,
    its set-up before run_training, the pre-stage (the GETs + the
    assembly), the step build, the restore, the rest up to its first
    step's start (the first batch), and its first step. ``source_other_s``
    is the rest of the source's side: its boundary poll and its exit,
    up to the destination's spawn. The parts sum to ``total_s``."""
    cyc_s, cyc_d = src["cycle_stages"][-1], dst["cycle_stages"][0]
    t_end = src["done"][-1]
    save = cyc_s.get("interrupt_save_s", 0.0)
    publish = src["migrate_stages"].get("publish_s", 0.0)
    prestage = dst["migrate_stages"].get("prestage_s", 0.0)
    build, restore = cyc_d["build_s"], cyc_d["restore_s"]
    return {"drain_save_s": save, "publish_s": publish,
           "source_other_s": dst["spawned"] - t_end - save - publish,
           "process_start_s": dst["ready"] - dst["spawned"],
           "setup_s": dst["started"] - dst["ready"],
           "prestage_s": prestage, "build_s": build, "restore_s": restore,
           "first_batch_s": dst["clock"][0] - dst["started"] - prestage
           - build - restore,
           "first_step_s": dst["done"][0] - dst["clock"][0],
           "total_s": dst["done"][0] - t_end}


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1]))
