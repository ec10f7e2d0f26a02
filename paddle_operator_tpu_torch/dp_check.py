"""Data-parallel checks, run as the workers of a real multi-process world.

A worker is started as the operator starts one, through the in-pod entry::

    TPUJOB_NUM_WORKERS=2 TPUJOB_WORKER_ID=<rank> \\
    TPUJOB_COORDINATOR=localhost:<port> TPUJOB_DIST_BACKEND=gloo \\
        python -m paddle_operator_tpu_torch.launch \\
            paddle_operator_tpu_torch/dp_check.py SPEC.json

and runs the scenarios of the JSON spec in order, over the process group
``launch`` made, writing ``<out>/<scenario name>.rank<r>.npz`` (and a
JSON line a scenario on its standard output). :func:`launch_workers`
starts such a world from a parent process and waits for it.
``tests/test_torch_dp.py`` drives it on the CPU (gloo), against the JAX
package's dp mesh; ``chip_smoke.py``'s train_dp phase drives it on the
card with two workers sharing it (gloo: NCCL refuses two ranks on one
device).

Scenarios (``kind``):

* ``bn``: sync :func:`.ops.nn.batchnorm` alone on the rank's block of
  :func:`bn_case`;
* ``train``: ``build_train_step`` calls on a dp mesh, each call started
  from a given state, on given global batches (ResNet or GPT);
* ``drain``: ``run_training`` with a drain requested on one rank only,
  then a resume of the step it saved;
* ``run``: ``run_training`` of a ResNet-50 or GPT job on the card, with
  per-step fingerprints of the parameters (BatchNorm's running stats
  included) and a digest of the final state, for the replica-identity
  gate;
* ``nccl_pair``: an NCCL group over the ranks, to record what NCCL says;
* ``world``: the rank, size and backend, and a sum over the ranks.

A scenario may plant a fault (:func:`planted`) that a gate must reject.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from paddle_operator_tpu_torch import bridge
from paddle_operator_tpu_torch.data import process_shard
from paddle_operator_tpu_torch.models import gpt, resnet
from paddle_operator_tpu_torch.ops import attention, nn, optim
from paddle_operator_tpu_torch.parallel import build_train_step, collectives
from paddle_operator_tpu_torch.parallel.mesh import make_mesh
from paddle_operator_tpu_torch.parallel.train import batch_axis_of
from paddle_operator_tpu_torch.runner import DrainMonitor, TrainJob, \
    run_training
from paddle_operator_tpu_torch.utils.checkpoint import load_into

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the planted faults, each of which a gate must reject
FAULTS = ("skip_grad_allreduce", "local_bn")
#: layers of the card's GPT-2 small job (full width; depth cut to fit the
#: time limit)
GPT_LAYERS = 2


# ---------------------------------------------------------------------------
# trees on disk
# ---------------------------------------------------------------------------

def save_tree(path: str, tree: Any) -> None:
    """A dict/list tree of arrays or tensors as one ``.npz`` (flat path
    names, and the structure as JSON)."""
    flat = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in bridge.flatten(tree).items()}
    np.savez(path, __structure__=np.array(json.dumps(bridge.structure(tree))),
             **flat)


def load_tree(path: str) -> Any:
    with np.load(path) as z:
        struct = json.loads(str(z["__structure__"]))
        flat = {k: z[k] for k in z.files if k != "__structure__"}
    return bridge.unflatten(struct, flat)


def digest(tree: Any) -> str:
    """sha256 over every leaf's bytes, in :func:`bridge.flatten` order."""
    h = hashlib.sha256()
    for leaf in bridge.leaves(tree):
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def fingerprint(tree: Any) -> torch.Tensor:
    """Two int64 sums over the bit patterns of every 4-byte leaf (the sum
    and the sum of squares, wrapping), computed on the leaves' device
    without a host sync: equal trees give equal fingerprints, and a
    changed bit changes them."""
    bits = torch.cat([t.detach().reshape(-1).view(torch.int32)
                      for t in bridge.leaves(tree)
                      if t.element_size() == 4]).to(torch.int64)
    return torch.stack([bits.sum(), (bits * bits).sum()])


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def planted(fault: str, rank: int):
    """Plant ``fault`` (one of :data:`FAULTS`, or "" for none) for the
    block, keeping every rank's collectives in step:

    * ``skip_grad_allreduce``: rank 1 keeps its local gradients (it still
      joins the collective, on a copy);
    * ``local_bn``: BatchNorm normalises each rank's block alone."""
    if not fault:
        yield
        return
    if fault == "skip_grad_allreduce":
        name, orig = "mean_grads", collectives.mean_grads

        def patched(grads, group, *a, **k):
            reduced = orig(bridge.tree_map(torch.clone, grads), group,
                           *a, **k)
            return grads if rank == 1 else reduced
    elif fault == "local_bn":
        name, orig = "batch_group", collectives.batch_group

        def patched():
            return None
    else:
        raise ValueError("unknown fault %r" % fault)
    setattr(collectives, name, patched)
    try:
        yield
    finally:
        setattr(collectives, name, orig)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def bn_case(seed: int = 0, batch: int = 8) -> Dict[str, np.ndarray]:
    """fp32 inputs of the sync-BatchNorm check: NHWC ``x`` whose channels
    have means far from 0, BatchNorm params with running stats, and a
    cotangent for ``y``."""
    rng = np.random.default_rng(seed)
    ch = 6
    return {
        "x": (rng.standard_normal((batch, 4, 4, ch)) * 2.0
              + rng.standard_normal(ch) * 3.0).astype(np.float32),
        "scale": rng.uniform(0.5, 1.5, ch).astype(np.float32),
        "bias": rng.standard_normal(ch).astype(np.float32),
        "mean": rng.standard_normal(ch).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, ch).astype(np.float32),
        "cot": rng.standard_normal((batch, 4, 4, ch)).astype(np.float32),
    }


def bn_grads(case: Dict[str, np.ndarray], group: collectives.Group = None
             ) -> Dict[str, np.ndarray]:
    """``y``, the new running stats and the gradients of ``sum(y * cot)``
    with respect to ``x``, ``scale`` and ``bias``, in fp32, with batch
    statistics over ``group`` (``None``: this block alone)."""
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    x = t["x"].clone().requires_grad_()
    params = {k: t[k].clone().requires_grad_(k in ("scale", "bias"))
              for k in ("scale", "bias", "mean", "var")}
    with collectives.sync_batch(group):
        y, stats = nn.batchnorm(params, x, train=True, dtype=torch.float32)
    gx, gs, gb = torch.autograd.grad((y * t["cot"]).sum(),
                                     [x, params["scale"], params["bias"]])
    return {"y": y.detach().numpy(), "dx": gx.numpy(), "dscale": gs.numpy(),
            "dbias": gb.numpy(), "mean": stats["mean"].numpy(),
            "var": stats["var"].numpy()}


def _bn(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    mesh = make_mesh({"dp": size})
    full = bn_case(sc.get("seed", 0))
    block = dict(full)
    for k in ("x", "cot"):
        block[k] = process_shard(full[k], rank, size)
    return bn_grads(block, mesh.group)


def cpu_train_setup(kind: str):
    """(loss_fn, optimizer, merge_stats, grad_clip) of the CPU train
    checks, in fp32: ResNet with SGD, GPT with adamw and clipping."""
    if kind == "resnet":
        return (lambda p, b: resnet.loss_fn(p, b, dtype=torch.float32),
                optim.sgd(0.01, momentum=0.9, weight_decay=1e-4),
                resnet.merge_stats, None)
    if kind == "gpt":
        return (lambda p, b: gpt.loss_fn(p, b, dtype=torch.float32),
                optim.adamw(optim.cosine_schedule(3e-4, 3, 1),
                            weight_decay=0.1), None, 1.0)
    raise ValueError("unknown model %r" % kind)


def _train(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """``build_train_step`` on a dp mesh: call i starts from
    ``starts[i]`` and takes ``batches[i]`` (global; a ``[K, ...]`` window
    for a fused call). With ``host_local`` the worker cuts its own block
    and the step takes it as it is."""
    dev = sc.get("device", "cpu")
    loss_fn, opt, merge, clip = cpu_train_setup(sc["model"])
    accum, K = sc.get("accum_steps", 1), sc.get("steps_per_call", 1)
    calls = [load_tree(p) for p in sc["batches"]]
    starts = [load_tree(p) for p in sc["starts"]]
    host_local = sc.get("host_local", False)
    mesh = make_mesh({"dp": size})
    sample = calls[0] if K == 1 else bridge.tree_map(lambda x: x[0],
                                                     calls[0])
    build = dict(mesh=mesh, merge_stats=merge, grad_clip=clip,
                 accum_steps=accum, host_local_batches=host_local)
    params = bridge.params_from_numpy(load_tree(sc["tree"]), device=dev)
    step, state = build_train_step(loss_fn, opt, params,
                                   bridge.params_from_numpy(sample, dev),
                                   steps_per_call=K, **build)
    fns = [step] * len(calls)
    if K > 1:
        single, _ = build_train_step(loss_fn, opt, state["params"],
                                     bridge.params_from_numpy(sample, dev),
                                     init_state=False, **build)
        fns = [step] + [single] * (len(calls) - 1)
    losses, states = [], []
    with planted(sc.get("fault", ""), rank):
        for i, (fn, batch, start) in enumerate(zip(fns, calls, starts)):
            if host_local:
                window = K > 1 and i == 0
                batch = process_shard(batch, rank, size, axis=batch_axis_of(
                    accum, K if window else 1))
            load_into(state, start)
            state, m = fn(state, bridge.params_from_numpy(batch, dev))
            losses.append(m["loss"].detach().cpu().numpy())
            states.append(bridge.params_to_numpy(state))
    return {"losses": losses, "states": states}


def _drain(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """A small ResNet through ``run_training`` on the CPU, a drain
    requested on ``drain_rank`` only, during step ``drain_at``; then the
    world resumes from the step it saved and runs two more steps."""
    def job(total: int, monitor: Optional[DrainMonitor] = None) -> TrainJob:
        calls = {"n": 0}

        def loss_fn(params, batch):
            calls["n"] += 1
            if monitor is not None and rank == sc["drain_rank"] \
                    and calls["n"] == sc["drain_at"]:
                monitor.request()
            return resnet.loss_fn(params, batch, dtype=torch.float32)

        return TrainJob(
            init_params=lambda gen: resnet.init(gen, depth=18,
                                                num_classes=10),
            loss_fn=loss_fn,
            optimizer=optim.fused_sgd(0.02, momentum=0.9, weight_decay=1e-4),
            make_batch=lambda gen, step: resnet.synthetic_batch(
                gen, 4 * size, 16, 10),
            merge_stats=resnet.merge_stats, total_steps=total, log_every=2,
            checkpoint_every=100, checkpoint_dir=sc["ckpt_dir"],
            drain_monitor=monitor, device="cpu")

    out = run_training(job(sc["total_steps"], DrainMonitor()))
    resumed = run_training(job(out["drain_step"] + 2))
    return {"steps": out["steps"], "drain_step": out["drain_step"],
            "drained": out.get("drained", False),
            "mesh_history": out["mesh_history"],
            "state": bridge.params_to_numpy(out["state"]),
            "resume_steps": resumed.get("resume_steps"),
            "resumed_steps": resumed["steps"], "resumed_loss": resumed["loss"]}


class _Recorder:
    """The loss of a card job, wrapped: each step's loss and a
    :func:`fingerprint` of the parameters it starts from (the state after
    the previous step, BatchNorm's running stats included) kept on the
    card and read at the end, and an event at each forward's start."""

    def __init__(self, loss_fn) -> None:
        self.loss_fn, self.losses, self.starts, self.prints = \
            loss_fn, [], [], []

    def __call__(self, params, batch):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.starts.append(ev)
        self.prints.append(fingerprint(params))
        loss, aux = self.loss_fn(params, batch)
        self.losses.append(loss.detach())
        return loss, aux


def card_job(model: str, steps: int) -> TrainJob:
    """The train_dp phase's jobs, at full width: ResNet-50 (224x224,
    global batch 128, ``fused_sgd`` at a constant lr of 0.01), or GPT-2
    small cut to :data:`GPT_LAYERS` layers (``examples/train_gpt.py``'s
    job: 16 x 1024, adamw, remat, the flash kernels). The lr is small
    because the run is compared with one process's: at the example's
    0.4 the first steps on random labels are chaotic, and rounding
    differences between the two runs would grow past any useful bound
    (a CPU rehearsal at depth 18 parted by 20 % in 5 steps)."""
    if model == "resnet50":
        return TrainJob(
            init_params=lambda gen: resnet.init(gen, 50, 1000),
            loss_fn=resnet.loss_fn,
            optimizer=optim.fused_sgd(0.01, momentum=0.9,
                                      weight_decay=1e-4),
            make_batch=lambda gen, step: resnet.synthetic_batch(gen, 128),
            merge_stats=resnet.merge_stats, total_steps=steps,
            log_every=steps, seed=0)
    if model == "gpt2_2layers":
        from paddle_operator_tpu_torch.examples import train_gpt

        return train_gpt.make_job({"TPUJOB_LAYERS": str(GPT_LAYERS),
                                   "TPUJOB_STEPS": str(steps)})
    raise ValueError("unknown card model %r" % model)


def card_run(model: str, steps: int) -> Dict[str, Any]:
    """Train a :func:`card_job` through ``run_training`` on the card and
    return its losses, per-step fingerprints (index i: the parameters
    after step i), a digest of the final state (parameters and optimizer
    state), step ms, kernel launches and wall seconds."""
    job = card_job(model, steps)
    rec = job.loss_fn = _Recorder(job.loss_fn)
    optim.multi_tensor_sgd.launches = 0
    for k in attention.flash_attention.launches:
        attention.flash_attention.launches[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_training(job)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    marks = rec.starts + [end]
    return {"losses": torch.stack(rec.losses).cpu().tolist(),
            "fingerprints": [p.tolist() for p in rec.prints[1:]]
            + [fingerprint(out["state"]["params"]).tolist()],
            "final_digest": digest(out["state"]),
            "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
            "wall_s": time.perf_counter() - t0,
            "mesh_history": out["mesh_history"],
            "launches": {"fused_sgd": optim.multi_tensor_sgd.launches,
                         **{"flash_" + k: v for k, v in
                            attention.flash_attention.launches.items()}}}


def _run(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    with planted(sc.get("fault", ""), rank):
        return card_run(sc["model"], sc["steps"])


def _nccl_pair(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """An NCCL group over the ranks and one all-reduce: returns what NCCL
    said (it refuses two ranks on one device)."""
    try:
        group = dist.new_group(backend="nccl")
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t, group=group)
        torch.cuda.synchronize()
        return {"ok": True, "value": t.tolist()}
    except (RuntimeError, dist.DistBackendError) as e:
        return {"ok": False, "error": str(e).strip().splitlines()[-1]}


def _world(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """The world as this rank sees it, and a sum over it."""
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    return {"size": size, "backend": dist.get_backend(),
            "sum_of_ranks_plus_1": t.item()}


SCENARIOS = {"bn": _bn, "train": _train, "drain": _drain, "run": _run,
             "nccl_pair": _nccl_pair, "world": _world}
#: scenarios that print their result as a JSON line, not to a file
PRINTED = ("run", "nccl_pair", "world")


def worker_main(spec_path: str) -> int:
    """Run a spec's scenarios on this rank of the world ``launch`` made."""
    with open(spec_path) as f:
        spec = json.load(f)
    rank, size = dist.get_rank(), dist.get_world_size()
    for sc in spec["scenarios"]:
        out = SCENARIOS[sc["kind"]](sc, rank, size)
        if sc["kind"] in PRINTED:
            print(json.dumps({"scenario": sc["name"], "rank": rank, **out}),
                  flush=True)
        else:
            save_tree(os.path.join(spec["out"], "%s.rank%d.npz"
                                   % (sc["name"], rank)), out)
    return 0


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_workers(spec: dict, world: int = 2, backend: str = "gloo",
                   timeout: float = 600.0,
                   env: Optional[Dict[str, str]] = None) -> List[List[dict]]:
    """Write ``spec`` to ``<spec["out"]>/spec.json``, start ``world``
    workers through ``python -m paddle_operator_tpu_torch.launch`` with
    the operator's env (and ``env``), wait for them (killing every one if
    any fails or the time runs out), and return each rank's JSON lines."""
    os.makedirs(spec["out"], exist_ok=True)
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs = []
    for rank in range(world):
        penv = dict(os.environ, **(env or {}))
        penv.update(TPUJOB_NUM_WORKERS=str(world),
                    TPUJOB_WORKER_ID=str(rank),
                    TPUJOB_COORDINATOR="localhost:%d" % port,
                    TPUJOB_DIST_BACKEND=backend,
                    PYTHONPATH=os.pathsep.join(
                        [REPO] + [p for p in os.environ.get(
                            "PYTHONPATH", "").split(os.pathsep) if p]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paddle_operator_tpu_torch.launch",
             os.path.abspath(__file__), path],
            cwd=REPO, env=penv, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    results = []
    try:
        for rank, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError("dp worker %d timed out after %.0f s"
                                   % (rank, timeout))
            if p.returncode != 0:
                raise RuntimeError("dp worker %d exited %d:\n%s"
                                   % (rank, p.returncode, err[-4000:]))
            results.append([json.loads(line) for line in out.splitlines()
                            if line.startswith("{")])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1]))
