"""Elastic training checks, run as the workers of a real elastic world.

A worker is started as the operator starts a pod of an ``elastic: 1``
job, through the in-pod entry::

    TPUJOB_NUM_WORKERS=4 TPUJOB_WORKER_ID=<rank> \\
    TPUJOB_COORDINATOR=localhost:<port> TPUJOB_DIST_BACKEND=gloo \\
    TPUJOB_ELASTIC_SERVER=http://localhost:<port> \\
    PADDLE_ELASTIC_JOB_ID=<namespace>-<name> \\
        python -m paddle_operator_tpu_torch.launch \\
            paddle_operator_tpu_torch/elastic_check.py SPEC.json

and runs the spec's scenarios in order. Each is ``run_training`` of one
elastic job under the env's config, with the scenario's job id and
coordinator port (so one world of processes can run several jobs): the
agent polls the membership server, and every cycle forms its own
process group. A scenario prints one JSON line a rank: per loss call
(one a step, steps re-run after a restore included) the loss of this
rank's block, a fingerprint of the parameters it starts from and of the
block it trains on, and its host seconds from the forward's start to the
update's end (each after a device sync); the
runner's ``cycles``, ``mesh_history``, ``resume_steps``,
``left_at_epoch`` and ``cycle_stages``; the kernel launches; a digest of
the final state (and with ``save_state`` the state itself, as
``<out>/<name>.rank<r>.npz``).

The parent starts the world through :func:`launch`, which writes each
job's ``np`` and ``epoch`` to the membership server, plays the operator
(:class:`Trigger`: once a step's manifest is on disk, write ``np`` and
bump the epoch, then start the ranks that join at a grow) and collects
the lines. Rank 0 holds a step (``hold_at``) until the operator has
acted, and the trigger waits for that hold, so that a run cannot finish
before the restart it checks and the restart lands at the boundary
after the held step; rank ``drain["rank"]`` may request a drain during
step ``drain["at"]``. Workers get the rendezvous timeout the operator
renders (:data:`OPERATOR_ELASTIC_TIMEOUT`).

Jobs: ``gpt_tiny`` (fp32 GPT from a saved tree, numpy batches from
``(seed, step)``, adamw; the CPU tests' job, which the JAX package's
runner runs too) and the card's ResNet-50 and GPT-2 small jobs of
:func:`.dp_check.card_job`. Planted faults (:data:`FAULTS`):
``fresh_restart`` (every cycle skips the restore) and ``stale_shard``
(rank 1 keeps the dp block of its first world after a resize).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_operator_tpu_torch import bridge, dp_check, runner
from paddle_operator_tpu_torch.data import step_generator
from paddle_operator_tpu_torch.device import deterministic_algorithms
from paddle_operator_tpu_torch.elastic.store import connect as kv_connect
from paddle_operator_tpu_torch.elastic.sync import JobRef, bump_epoch, \
    epoch_key, np_key
from paddle_operator_tpu_torch.launch import detect_env
from paddle_operator_tpu_torch.models import gpt
from paddle_operator_tpu_torch.ops import attention, optim
from paddle_operator_tpu_torch.runner import DrainMonitor, TrainJob, \
    bind_mesh, run_training
from paddle_operator_tpu_torch.utils.checkpoint import restore_checkpoint

#: the planted faults, each of which a gate must reject
FAULTS = ("fresh_restart", "stale_shard")


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def numpy_batch(seed: int, step: int, batch: int, seq: int,
                vocab: int) -> np.ndarray:
    """The token ids of step ``step``'s global batch, from ``(seed,
    step)`` with numpy: both packages' jobs draw the same ids."""
    return np.random.default_rng([seed, step]).integers(
        0, vocab, (batch, seq)).astype(np.int32)


def gpt_tiny_job(sc: dict) -> TrainJob:
    """GPT at the JAX package's ``TINY_CONFIG`` in fp32 on the CPU,
    started from the tree saved at ``sc["tree"]``, adamw at 1e-3, the
    global batch of :func:`numpy_batch`, a dp mesh over the world."""
    tree = dp_check.load_tree(sc["tree"])
    batch, seq, vocab = sc["batch"], sc["seq"], sc["vocab"]
    return TrainJob(
        init_params=lambda gen: bridge.params_from_numpy(tree, "cpu"),
        loss_fn=lambda p, b: gpt.loss_fn(p, b, dtype=torch.float32),
        optimizer=optim.adamw(1e-3),
        make_batch=lambda gen, step: {"input_ids": torch.from_numpy(
            numpy_batch(sc["seed"], step, batch, seq, vocab))},
        mesh_axes=lambda world: {"dp": world},
        total_steps=sc["steps"], log_every=0, device="cpu")


def make_job(sc: dict) -> TrainJob:
    """The scenario's job, checkpointing every ``sc["every"]`` steps
    into ``sc["ckpt_dir"]``, its mesh dp over the cycle's world."""
    if sc["model"] == "gpt_tiny":
        job = gpt_tiny_job(sc)
    else:
        job = dp_check.card_job(sc["model"], sc["steps"], sc.get("seed", 0))
        job.mesh_axes = lambda world: {"dp": world}
    job.checkpoint_dir = sc["ckpt_dir"]
    job.checkpoint_every = sc["every"]
    return job


def bits_print(tree: Any) -> torch.Tensor:
    """Two int64 sums over the bits of every leaf (each viewed as the
    signed integers of its width): the sum and the sum of squares,
    wrapping. Equal trees give equal prints; computed on the leaves'
    device without a host sync."""
    views = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    bits = torch.cat([t.detach().reshape(-1).view(views[t.element_size()])
                      .to(torch.int64) for t in bridge.leaves(tree)])
    return torch.stack([bits.sum(), (bits * bits).sum()])


class Recorder:
    """The job's loss and optimizer, wrapped: at each loss call (one a
    step) a host clock after a device sync, a
    :func:`.dp_check.fingerprint` of the parameters and a
    :func:`bits_print` of the block, and the block's loss; after each
    update, a host clock after a device sync (the step's end, before the
    boundary's save and poll). Rank 0 may hold step ``hold_at`` of its
    first cycle until the job's epoch has moved; a rank may request a
    drain during one step (``drain``: a :class:`.runner.DrainMonitor`, or
    anything with its ``request()``, such as the MOVE notice of
    :class:`.migrate_check.MigrateNotice`)."""

    def __init__(self, loss_fn: Callable, hold: Optional[Callable] = None,
                 hold_at: int = -1,
                 drain: Optional[DrainMonitor] = None,
                 drain_at: int = -1) -> None:
        self.loss_fn, self.hold, self.hold_at = loss_fn, hold, hold_at
        self.drain, self.drain_at = drain, drain_at
        self.losses: List[torch.Tensor] = []
        self.prints: List[torch.Tensor] = []
        self.batch_prints: List[torch.Tensor] = []
        self.clock: List[float] = []
        self.done: List[float] = []

    def __call__(self, params, batch, mesh=None):
        call = len(self.losses)
        if call == self.hold_at and self.hold is not None:
            self.hold()
        if call == self.drain_at and self.drain is not None:
            self.drain.request()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.clock.append(time.perf_counter())
        self.prints.append(dp_check.fingerprint(params))
        self.batch_prints.append(bits_print(batch))
        loss, aux = bind_mesh(self.loss_fn, mesh)(params, batch)
        self.losses.append(loss.detach())
        return loss, aux

    def wrap(self, opt: optim.Optimizer) -> optim.Optimizer:
        def update(grads, state, params):
            out = opt.update(grads, state, params)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.done.append(time.perf_counter())
            return out
        return optim.Optimizer(opt.init, update)


def held_key(key: JobRef) -> str:
    """The key rank 0 sets while it holds a step (the checks' own)."""
    return "/tpujob/%s-%s/held" % (key.namespace, key.name)


def hold_until_moved(store, key: JobRef, epoch: str,
                     timeout: float = 600.0) -> None:
    """Say that rank 0 holds, then block until the job's epoch differs
    from ``epoch``."""
    store.put(held_key(key), "1")
    deadline = time.monotonic() + timeout
    while store.get(epoch_key(*key)) == epoch:
        if time.monotonic() > deadline:
            raise TimeoutError("the epoch of %r stayed %s for %.0f s"
                               % (key, epoch, timeout))
        time.sleep(0.005)


@contextlib.contextmanager
def planted(fault: str, rank: int):
    """Plant ``fault`` (one of :data:`FAULTS`, or "" for none) for the
    block: ``fresh_restart`` makes every restore find nothing (on every
    rank, so the restore's collectives stay in step); ``stale_shard``
    has rank 1 cut its batch as the first world it trained in did."""
    if not fault:
        yield
        return
    if fault == "fresh_restart":
        def restore(*a, **k):
            raise FileNotFoundError("restore skipped (planted fault)")
        name, patched = "restore_latest", restore
    elif fault == "stale_shard":
        orig, first = runner.process_shard, []

        def stale(batch, process_index, process_count, axis=0):
            if not first:
                first.append((process_index, process_count))
            if rank == 1:
                process_index, process_count = first[0]
            return orig(batch, process_index, process_count, axis)
        name, patched = "process_shard", stale
    else:
        raise ValueError("unknown fault %r" % fault)
    orig_attr = getattr(runner, name)
    setattr(runner, name, patched)
    try:
        yield
    finally:
        setattr(runner, name, orig_attr)


def zero_counts() -> None:
    """Every kernel launch count this path reads set to 0."""
    optim.multi_tensor_sgd.launches = 0
    dp_check.zero_counts()


def launches() -> Dict[str, int]:
    return {"fused_sgd": optim.multi_tensor_sgd.launches,
            **{"flash_" + k: v for k, v in
               attention.flash_attention.launches.items()}}


def run_scenario(sc: dict, out_dir: str) -> Dict[str, Any]:
    """``run_training`` of the scenario's job on this rank, elastically:
    the env's launch config with the scenario's job id and coordinator
    port. Returns the rank's JSON line."""
    cfg = dataclasses.replace(detect_env(), job_id=sc["job"],
                              coordinator="localhost:%d" % sc["port"])
    rank = cfg.worker_id
    key = JobRef.of(sc["job"])
    store = kv_connect(cfg.elastic_server)
    epoch0 = store.get(epoch_key(*key))
    job = make_job(sc)
    drain = sc.get("drain") or {}
    if drain.get("rank") == rank:
        job.drain_monitor = DrainMonitor()
    rec = job.loss_fn = Recorder(
        job.loss_fn,
        hold=lambda: hold_until_moved(store, key, epoch0),
        hold_at=sc.get("hold_at", -1) if rank == 0 else -1,
        drain=job.drain_monitor, drain_at=drain.get("at", -1))
    job.optimizer = rec.wrap(job.optimizer)
    if sc["model"] != "gpt_tiny":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    if sc["model"].startswith("gpt2"):
        # the embedding's index backward is atomic otherwise; a restart
        # must give the uninterrupted run's bits
        deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    zero_counts()
    t0 = time.perf_counter()
    with planted(sc.get("fault", ""), rank):
        out = run_training(job, cfg, poll_interval=0.0)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    end = time.perf_counter()
    line = {"steps": out.get("steps"), "cycles": out["cycles"],
            "mesh_history": out["mesh_history"],
            "resume_steps": out.get("resume_steps", []),
            "left_at_epoch": out.get("left_at_epoch"),
            "drained": out.get("drained", False),
            "drain_step": out.get("drain_step"),
            "cycle_stages": out["cycle_stages"],
            "losses": [x.item() for x in rec.losses],
            "prints": [p.tolist() for p in rec.prints],
            "batch_prints": [p.tolist() for p in rec.batch_prints],
            "step_s": [b - a for a, b in zip(rec.clock, rec.done)],
            "recovery": recovery(out["cycle_stages"], rec.clock, rec.done),
            "launches": launches(), "wall_s": end - t0}
    if "state" in out:
        line["final_digest"] = dp_check.digest(out["state"])
        if sc.get("save_state"):
            dp_check.save_tree(os.path.join(
                out_dir, "%s.rank%d.npz" % (sc["name"], rank)),
                bridge.params_to_numpy(out["state"]))
    return line


def checkpointed(model: str, steps: int, ckpt_dir: str, step: int,
                 seed: int = 0, device: str = "cuda") -> Dict[str, Any]:
    """The checkpoint of a card job's run at ``step``: a
    :func:`.dp_check.fingerprint` of its parameters, the epoch it was cut
    in, and its loss on step ``step``'s global batch in one process."""
    job = dp_check.card_job(model, steps, seed)
    tree, manifest = restore_checkpoint(ckpt_dir, step=step)
    params = bridge.params_from_numpy(tree["params"], device)
    batch = job.make_batch(step_generator(job.seed, step, device), step)
    with torch.no_grad():
        loss = bind_mesh(job.loss_fn, None)(params, batch)[0].item()
    return {"print": dp_check.fingerprint(params).tolist(), "loss": loss,
            "epoch": manifest["meta"].get("epoch")}


def recovery(stages: Sequence[dict], clock: Sequence[float],
             done: Sequence[float]) -> List[Dict[str, float]]:
    """The time to recover of each restart, by part, in host seconds:
    the stopped cycle's interrupt save and leave, the next cycle's
    rendezvous (with its mesh), step build and restore, its first step
    (from the forward's start to the update's end, each after a device
    sync: ``clock`` and ``done`` hold one time a step) and the whole,
    from the stop decision to the end of that first step."""
    out, call = [], 0
    for prev, cur in zip(stages, stages[1:]):
        call += prev["end_step"] - prev["start_step"]
        if "stopped_at" not in prev or call >= len(done):
            continue
        out.append({"interrupt_save_s": prev.get("interrupt_save_s", 0.0),
                    "leave_s": prev["leave_s"],
                    "rendezvous_s": cur["rendezvous_s"],
                    "build_s": cur["build_s"],
                    "restore_s": cur["restore_s"],
                    "first_step_s": done[call] - clock[call],
                    "total_s": done[call] - prev["stopped_at"]})
    return out


def worker_main(spec_path: str) -> int:
    """Run a spec's scenarios on this worker, printing a line each."""
    with open(spec_path) as f:
        spec = json.load(f)
    rank = detect_env().worker_id
    for sc in spec["scenarios"]:
        line = run_scenario(sc, spec["out"])
        print(json.dumps({"scenario": sc["name"], "rank": rank, **line}),
              flush=True)
    return 0


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trigger:
    """The operator's move on one job: once ``ckpt_dir`` holds step
    ``after_step``'s manifest and rank 0 holds a step (``hold_at``: the
    move then lands at the boundary after the held step), write ``np``
    (if given) and bump the epoch ``bumps`` times back to back, as the
    controller does (``np`` first); then start the ``joiners`` ranks of
    a grow."""

    job: str
    ckpt_dir: str
    after_step: int
    np: Optional[int] = None
    joiners: Sequence[int] = ()
    bumps: int = 1

    def run(self, store, start: Callable[[int], None],
            timeout: float) -> None:
        """Act once the step is on disk and rank 0 holds."""
        manifest = os.path.join(self.ckpt_dir, "step_%012d" % self.after_step,
                                "manifest.json")
        deadline = time.monotonic() + timeout
        key = JobRef.of(self.job)
        while not os.path.exists(manifest) or store.get(
                held_key(key)) is None:
            if time.monotonic() > deadline:
                raise TimeoutError("step %d of %s never appeared"
                                   % (self.after_step, self.job))
            time.sleep(0.002)
        if self.np is not None:
            store.put(np_key(*key), str(self.np))
        for _ in range(self.bumps):
            bump_epoch(store, key)
        for rank in self.joiners:
            start(rank)


#: the rendezvous timeout the operator renders for every elastic job
#: (``PADDLE_ELASTIC_TIMEOUT``, paddle_operator_tpu/controllers/helper.py)
OPERATOR_ELASTIC_TIMEOUT = "60"


def launch(spec: dict, world: int, server_endpoint: str,
           triggers: Sequence[Trigger] = (), backend: str = "gloo",
           timeout: float = 600.0, env: Optional[Dict[str, str]] = None
           ) -> Dict[str, List[dict]]:
    """Start ``world`` workers of the spec's scenarios (each scenario's
    ``np`` and epoch 1 written first, its ``port`` chosen here), play the
    ``triggers`` while they run, and return each scenario's lines by
    rank."""
    store = kv_connect(server_endpoint)
    for sc in spec["scenarios"]:
        key = JobRef.of(sc["job"])
        sc.setdefault("port", dp_check.free_port())
        store.put(np_key(*key), str(sc.get("np", world)))
        store.put(epoch_key(*key), "1")

    def during(start: Callable[[int], None]) -> None:
        errors: List[BaseException] = []

        def act(t: Trigger) -> None:
            try:
                t.run(store, start, timeout)
            except BaseException as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=act, args=(t,), daemon=True)
                   for t in triggers]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout)
        if errors:
            raise errors[0]

    lines = dp_check.launch_workers(
        spec, world=world, backend=backend, timeout=timeout,
        env=dict(env or {}, TPUJOB_ELASTIC_SERVER=server_endpoint,
                 PADDLE_ELASTIC_JOB_ID=spec["scenarios"][0]["job"],
                 PADDLE_ELASTIC_TIMEOUT=OPERATOR_ELASTIC_TIMEOUT),
        script=os.path.abspath(__file__), during=during)
    by_name: Dict[str, List[dict]] = {}
    for rank_lines in lines:
        for line in rank_lines:
            by_name.setdefault(line["scenario"], []).append(line)
    return {k: sorted(v, key=lambda r: r["rank"]) for k, v in by_name.items()}


def step_losses(lines: Sequence[dict]) -> Dict[int, float]:
    """The global batch's loss at each step of an elastic run, from its
    ranks' lines: each loss call of a rank is one step, from the start
    step of its cycle (``cycle_stages``); a step's loss is the mean of
    the blocks' losses (equal blocks) over the ranks of the last epoch
    that ran it (a step re-run after a restore keeps its re-run)."""
    per: Dict[int, tuple] = {}
    for r in lines:
        calls = iter(r["losses"])
        for cyc in r["cycle_stages"]:
            for step in range(cyc["start_step"], cyc["end_step"]):
                loss = next(calls)
                epoch, by_rank = per.get(step, (cyc["epoch"], {}))
                if cyc["epoch"] > epoch:
                    by_rank = {}
                if cyc["epoch"] >= epoch:
                    by_rank[r["rank"]] = loss
                    per[step] = (cyc["epoch"], by_rank)
    return {step: float(np.mean(list(by_rank.values())))
            for step, (_, by_rank) in sorted(per.items())}

if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1]))
