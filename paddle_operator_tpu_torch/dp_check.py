"""Data- and sequence-parallel checks, run as the workers of a real
multi-process world.

A worker is started as the operator starts one, through the in-pod entry::

    TPUJOB_NUM_WORKERS=2 TPUJOB_WORKER_ID=<rank> \\
    TPUJOB_COORDINATOR=localhost:<port> TPUJOB_DIST_BACKEND=gloo \\
        python -m paddle_operator_tpu_torch.launch \\
            paddle_operator_tpu_torch/dp_check.py SPEC.json

and runs the scenarios of the JSON spec in order, over the process group
``launch`` made, writing ``<out>/<scenario name>.rank<r>.npz`` (and a
JSON line a scenario on its standard output). :func:`launch_workers`
starts such a world from a parent process and waits for it.
``tests/test_torch_dp.py`` and ``tests/test_torch_{context,sp}.py`` drive
it on the CPU (gloo), against the JAX package's dp and dp x sp meshes;
``chip_smoke.py``'s train_dp and train_sp phases drive it on the card
with two or four workers sharing it (gloo: NCCL refuses two ranks on one
device).

Scenarios (``kind``):

* ``bn``: sync :func:`.ops.nn.batchnorm` alone on the rank's block of
  :func:`bn_case`;
* ``train``: ``build_train_step`` calls on a dp mesh, or a dp x sp mesh
  with ``seq_axis="sp"`` and ring attention in the GPT loss, each call
  started from a given state, on given global batches (ResNet or GPT);
* ``attn``: ring or Ulysses attention alone on this rank's block of
  seeded inputs, with its gradients (saved, or held against one
  process's flash attention over the whole sequence on the card);
* ``bert``: ``bert.encode`` with ring attention on this rank's dp and sp
  block;
* ``sprun``: ``run_training`` of ``examples/train_gpt.make_job`` with
  ``TPUJOB_SP`` on the CPU, writing a checkpoint;
* ``drain``: ``run_training`` with a drain requested on one rank only,
  then a resume of the step it saved;
* ``run``: ``run_training`` of a ResNet-50 or GPT job on the card (GPT
  also over a dp x sp mesh), with per-step fingerprints of the parameters
  (BatchNorm's running stats included) and a digest of the final state,
  for the replica-identity gate;
* ``grads``: step 0's gradients of a card GPT job under its mesh,
  against one process's saved ones;
* ``mesh``: a dp x sp mesh's coordinates and axis groups;
* ``nccl_pair``: an NCCL group over the ranks, to record what NCCL says;
* ``world``: the rank, size and backend, and a sum over the ranks.

A scenario may plant a fault (:func:`planted`) that a gate must reject.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from paddle_operator_tpu_torch import bridge, testing
from paddle_operator_tpu_torch.data import process_shard, step_generator
from paddle_operator_tpu_torch.device import resolve_device
from paddle_operator_tpu_torch.models import bert, gpt, resnet
from paddle_operator_tpu_torch.ops import attention, nn, optim
from paddle_operator_tpu_torch.parallel import build_train_step, \
    collectives, context
from paddle_operator_tpu_torch.parallel import train as train_step
from paddle_operator_tpu_torch.parallel.mesh import make_mesh
from paddle_operator_tpu_torch.parallel.train import batch_axis_of
from paddle_operator_tpu_torch.runner import DrainMonitor, TrainJob, \
    bind_mesh, run_training
from paddle_operator_tpu_torch.utils.checkpoint import load_into

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the planted faults, each of which a gate must reject: of the dp path
FAULTS = ("skip_grad_allreduce", "local_bn")
#: and of the sp path
SP_FAULTS = ("causal_flipped", "rope_local", "skip_sp_grad_sum")
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

def _fault_patch(fault: str, rank: int):
    """``(object, attribute, replacement)`` of a planted fault."""
    if fault == "skip_grad_allreduce":
        orig = collectives.mean_grads

        def keep_local(grads, group, *a, **k):
            reduced = orig(bridge.tree_map(torch.clone, grads), group,
                           *a, **k)
            return grads if rank == 1 else reduced
        return collectives, "mean_grads", keep_local
    if fault == "local_bn":
        return collectives, "batch_group", lambda: None
    if fault == "causal_flipped":
        return context, "_invisible", lambda src, my: src <= my
    if fault == "rope_local":
        return gpt, "block_positions", \
            lambda index, s_local, device: torch.arange(s_local,
                                                        device=device)
    if fault == "skip_sp_grad_sum":
        return train_step, "_reduce_grads", \
            lambda grads, mesh, shards: collectives.mean_grads(
                grads, mesh.axis_group("dp"))
    raise ValueError("unknown fault %r" % fault)


@contextlib.contextmanager
def planted(fault: str, rank: int):
    """Plant ``fault`` (one of :data:`FAULTS` or :data:`SP_FAULTS`, or ""
    for none) for the block, keeping every rank's collectives in step:

    * ``skip_grad_allreduce``: rank 1 keeps its local gradients (it still
      joins the collective, on a copy);
    * ``local_bn``: BatchNorm normalises each rank's block alone;
    * ``causal_flipped``: the ring's causal test on rotated hops turned
      from ``src >= my`` (invisible) to ``src <= my``;
    * ``rope_local``: rope at the block's local positions;
    * ``skip_sp_grad_sum``: the gradients averaged over dp only, each sp
      rank keeping its block's part."""
    if not fault:
        yield
        return
    obj, name, patched = _fault_patch(fault, rank)
    orig = getattr(obj, name)
    setattr(obj, name, patched)
    try:
        yield
    finally:
        setattr(obj, name, orig)


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


def cpu_train_setup(kind: str, mesh=None, impl: str = "auto"):
    """(loss_fn, optimizer, merge_stats, grad_clip) of the CPU train
    checks, in fp32: ResNet with SGD, GPT with adamw and clipping; with a
    ``mesh`` that has an sp axis above 1, GPT's attention is causal ring
    attention over it (``impl``)."""
    if kind == "resnet":
        return (lambda p, b: resnet.loss_fn(p, b, dtype=torch.float32),
                optim.sgd(0.01, momentum=0.9, weight_decay=1e-4),
                resnet.merge_stats, None)
    if kind == "gpt":
        attn = "auto"
        if mesh is not None and mesh.axis_size("sp") > 1:
            attn = functools.partial(context.ring_attention, mesh=mesh,
                                     axis="sp", causal=True, impl=impl)
        return (lambda p, b: gpt.loss_fn(p, b, dtype=torch.float32,
                                         attn_impl=attn),
                optim.adamw(optim.cosine_schedule(3e-4, 3, 1),
                            weight_decay=0.1), None, 1.0)
    raise ValueError("unknown model %r" % kind)


def _train(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """``build_train_step`` on a dp mesh: call i starts from
    ``starts[i]`` and takes ``batches[i]`` (global; a ``[K, ...]`` window
    for a fused call). With ``host_local`` the worker cuts its own block
    and the step takes it as it is."""
    dev = sc.get("device", "cpu")
    mesh = make_mesh(sc.get("mesh") or {"dp": size})
    loss_fn, opt, merge, clip = cpu_train_setup(sc["model"], mesh,
                                                sc.get("impl", "auto"))
    accum, K = sc.get("accum_steps", 1), sc.get("steps_per_call", 1)
    calls = [load_tree(p) for p in sc["batches"]]
    starts = [load_tree(p) for p in sc["starts"]]
    host_local = sc.get("host_local", False)
    sample = calls[0] if K == 1 else bridge.tree_map(lambda x: x[0],
                                                     calls[0])
    build = dict(mesh=mesh, merge_stats=merge, grad_clip=clip,
                 accum_steps=accum, host_local_batches=host_local,
                 seq_axis=sc.get("seq_axis"))
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
                batch = process_shard(
                    batch, mesh.axis_rank("dp"), mesh.axis_size("dp"),
                    axis=batch_axis_of(accum, K if window else 1))
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
    card and read at the end, and an event at each forward's start. It
    takes the runner's ``mesh`` keyword and hands it on."""

    def __init__(self, loss_fn) -> None:
        self.loss_fn, self.losses, self.starts, self.prints = \
            loss_fn, [], [], []

    def __call__(self, params, batch, mesh=None):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.starts.append(ev)
        self.prints.append(fingerprint(params))
        loss, aux = bind_mesh(self.loss_fn, mesh)(params, batch)
        self.losses.append(loss.detach())
        return loss, aux


#: the card's GPT-2 small jobs: ``examples/train_gpt.make_job``'s env
#: (full width; depth and steps cut to fit the time limit). The sp jobs
#: and their one-process counterparts: 4 x 4096 tokens a step
#: (``train_gpt``'s 16,384), the whole sequence in one process or split
#: over sp workers
CARD_GPT = {
    "gpt2_2layers": {"TPUJOB_LAYERS": str(GPT_LAYERS)},
    "gpt2_seq4096": {"TPUJOB_SEQ": "4096", "TPUJOB_BATCH": "4"},
    "gpt2_sp4": {"TPUJOB_SEQ": "4096", "TPUJOB_BATCH": "4",
                 "TPUJOB_SP": "4"},
    "gpt2_2layers_seq4096": {"TPUJOB_LAYERS": "2", "TPUJOB_SEQ": "4096",
                             "TPUJOB_BATCH": "4"},
    "gpt2_2layers_dp2_sp2": {"TPUJOB_LAYERS": "2", "TPUJOB_SEQ": "4096",
                             "TPUJOB_BATCH": "4", "TPUJOB_SP": "2"},
}


#: the card's ResNet-50 jobs: the compute type of each
CARD_RESNET = {"resnet50": torch.bfloat16, "resnet50_fp32": torch.float32}


def _nudged(init: Callable) -> Callable:
    """``init`` with every floating leaf moved one ulp up."""
    def nudged(gen):
        params = init(gen)
        with torch.no_grad():
            for t in bridge.leaves(params):
                if t.is_floating_point():
                    t.copy_(torch.nextafter(t, torch.full_like(t, np.inf)))
        return params
    return nudged


def card_job(model: str, steps: int, seed: int = 0,
             nudge: bool = False) -> TrainJob:
    """The train_dp and train_sp phases' jobs, at full width: ResNet-50
    (224x224, global batch 128, ``fused_sgd`` at a constant lr of 0.01;
    bf16 on fp32 parameters, or fp32 throughout for ``resnet50_fp32``),
    or a GPT-2 small job of :data:`CARD_GPT` (``examples/train_gpt.py``'s
    job: adamw, remat, the flash kernels; ring attention with
    ``TPUJOB_SP``); ``seed`` draws the parameters and the batches, and
    ``nudge`` moves every parameter one ulp up (a difference as small as
    one rounding, to see what the steps make of it). The lr is small
    because the run is compared with one process's: at the example's 0.4
    the first steps on random labels are chaotic, and rounding
    differences between the two runs would grow past any useful bound
    (a CPU rehearsal at depth 18 parted by 20 % in 5 steps)."""
    if model in CARD_RESNET:
        job = TrainJob(
            init_params=lambda gen: resnet.init(gen, 50, 1000),
            loss_fn=functools.partial(resnet.loss_fn,
                                      dtype=CARD_RESNET[model]),
            optimizer=optim.fused_sgd(0.01, momentum=0.9,
                                      weight_decay=1e-4),
            make_batch=lambda gen, step: resnet.synthetic_batch(gen, 128),
            merge_stats=resnet.merge_stats, total_steps=steps,
            log_every=steps, seed=seed)
    elif model in CARD_GPT:
        from paddle_operator_tpu_torch.examples import train_gpt

        job = train_gpt.make_job(dict(CARD_GPT[model],
                                      TPUJOB_STEPS=str(steps)))
        job.seed = seed
    else:
        raise ValueError("unknown card model %r" % model)
    if nudge:
        job.init_params = _nudged(job.init_params)
    return job


def flash_device_ms(prof) -> float:
    """Device ms of the flash-attention kernels in a profile."""
    from torch.autograd import DeviceType

    return sum((e.time_range.end - e.time_range.start) / 1e3
               for e in prof.events() if e.device_type == DeviceType.CUDA
               and any(n in e.name for n in ("flash_fwd", "flash_dq",
                                             "flash_dkv")))


def card_run(model: str, steps: int, profile: bool = False,
             seed: int = 0, nudge: bool = False) -> Dict[str, Any]:
    """Train a :func:`card_job` through ``run_training`` on the card and
    return its losses, per-step fingerprints (index i: the parameters
    after step i), a digest of the final state (parameters and optimizer
    state), step ms, kernel launches, the sequence collectives' traffic
    and wall seconds; with ``profile``, the flash kernels' device ms a
    step from ``torch.profiler`` over the run."""
    job = card_job(model, steps, seed, nudge)
    rec = job.loss_fn = _Recorder(job.loss_fn)
    optim.multi_tensor_sgd.launches = 0
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof or contextlib.nullcontext():
        out = run_training(job)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
    marks = rec.starts + [end]
    got = {"losses": torch.stack(rec.losses).cpu().tolist(),
           "fingerprints": [p.tolist() for p in rec.prints[1:]]
           + [fingerprint(out["state"]["params"]).tolist()],
           "final_digest": digest(out["state"]),
           "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
           "wall_s": time.perf_counter() - t0,
           "mesh_history": out["mesh_history"],
           "transfers": dict(collectives.transfers),
           "launches": {"fused_sgd": optim.multi_tensor_sgd.launches,
                        **{"flash_" + k: v for k, v in
                           attention.flash_attention.launches.items()}}}
    if prof is not None:
        got["flash_ms_per_step"] = flash_device_ms(prof) / steps
    return got


def _run(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    with planted(sc.get("fault", ""), rank):
        return card_run(sc["model"], sc["steps"], sc.get("profile", False))


def step0_grads(model: str) -> Dict[str, torch.Tensor]:
    """Step 0's gradients of a :data:`CARD_GPT` job's loss on the card,
    by leaf: the job's parameters and first global batch, as
    ``run_training`` draws them; under a mesh (the job's ``mesh_axes``)
    this rank's part, reduced as the train step reduces it (summed over
    sp, averaged over dp)."""
    job = card_job(model, 1)
    mesh = make_mesh(job.mesh_axes) if job.mesh_axes else None
    dev = resolve_device(None, "step0_grads")
    params = job.init_params(torch.Generator(device=dev).manual_seed(
        job.seed))
    batch = job.make_batch(step_generator(job.seed, 0, dev), 0)
    if mesh is not None:
        batch = process_shard(batch, mesh.axis_rank("dp"),
                              mesh.axis_size("dp"))
    loss_fn = functools.partial(job.loss_fn, mesh=mesh)
    sp = mesh.axis_size("sp") if mesh is not None else 1
    with collectives.sequence_shards(
            mesh.axis_group("sp") if mesh is not None else None):
        _, grads = train_step._grads_of(loss_fn, params, batch)
    grads = train_step._reduce_grads(grads, mesh, sp)
    return {k: g for k, g in bridge.flatten(grads).items() if g is not None}


def grad_reading(got: Dict[str, torch.Tensor],
                 ref: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The largest ||g - g_ref|| / ||g_ref|| over the leaves, and its
    leaf (``chip_smoke``'s train_gpt gradient gate's measure)."""
    rel = {k: (torch.linalg.vector_norm(g.float() - ref[k].float())
               / torch.linalg.vector_norm(ref[k].float())).item()
           for k, g in got.items()}
    worst = max(rel, key=rel.get)
    return {"max_rel_diff": rel[worst], "leaf": worst}


def _grads(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """:func:`step0_grads` of ``model`` with ``fault`` planted, against
    the one-process gradients saved at ``ref`` (``torch.save``)."""
    ref = torch.load(sc["ref"], map_location=resolve_device(None, "grads"))
    with planted(sc.get("fault", ""), rank):
        got = step0_grads(sc["model"])
    return grad_reading(got, ref)


# ---------------------------------------------------------------------------
# sequence parallelism: attention alone, BERT's encoder, a CPU job
# ---------------------------------------------------------------------------

#: the bf16 forward class of ``attn`` on the card, per element:
#: ``BF16_HOP * attention(q, k, |v|) + 2 bf16 ulps of the one-process
#: value + 2 * BF16_ATOL``. Each ring hop's kernel output is within one
#: bf16 ulp (<= 2^-7 of its magnitude) plus BF16_ATOL of its exact value;
#: the fp32 merge weighs the hops by w_r >= 0 summing to 1, and
#: sum_r w_r |o_r| <= sum_k p_k |v_k| = attention(q, k, |v|); the merged
#: value is rounded to bf16 once more, and the one-process output is
#: within one ulp of its own exact value
BF16_HOP = 2.0 ** -7
#: the bf16 gradients' class, relative to the one-process gradient's norm:
#: (n + 2) * 2^-8 for an n-rank ring, each gradient being n hop terms of
#: one kernel rounding each, from a cotangent rounded to bf16 once, added
#: in bf16 n - 1 times (2^-8 of the sum each), against a one-process
#: gradient of one rounding
def bf16_grad_rtol(n: int) -> float:
    return (n + 2) * 2.0 ** -8


def attn_case(shape, seed: int = 0) -> Dict[str, np.ndarray]:
    """The global fp32 q, k, v and output cotangent g of an ``attn``
    scenario, from ``seed``."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(tuple(shape), dtype=np.float32)
            for k in ("q", "k", "v", "g")}


def attn_fn(kind: str):
    """``ring`` or ``ulysses``, as (q, k, v, mesh, axis, causal, impl)."""
    return {"ring": context.ring_attention,
            "ulysses": context.ulysses_attention}[kind]


def zero_counts() -> None:
    """The flash kernels' launch counts and the sequence collectives'
    traffic set to 0."""
    for k in attention.flash_attention.launches:
        attention.flash_attention.launches[k] = 0
    for k in collectives.transfers:
        collectives.transfers[k] = type(collectives.transfers[k])(0)


def _attn_errors(got: Dict[str, torch.Tensor],
                 want: Dict[str, torch.Tensor], bound_fwd, grad_rtol
                 ) -> Dict[str, Any]:
    """The block's output against the one-process one element by element
    (within ``bound_fwd``, a tensor or a number), its gradients by their
    largest error within ``grad_rtol`` of the magnitude (fp32: the
    reference's allclose) or of the norm (bf16: ``grad_rtol`` a
    function)."""
    out: Dict[str, Any] = {}
    err = (got["out"].float() - want["out"].float()).abs()
    out["out"] = {"max_abs_err": err.max().item(),
                  "within": bool((err <= bound_fwd).all()),
                  "bitwise": bool(torch.equal(got["out"], want["out"]))}
    for k in ("dq", "dk", "dv"):
        g, w = got[k].float(), want[k].float()
        diff = (g - w).abs()
        if callable(grad_rtol):
            rel = (diff.norm() / w.norm()).item()
            ok = rel <= grad_rtol()
        else:
            rel = (diff / (grad_rtol + grad_rtol * w.abs())).max().item()
            ok = rel <= 1.0
        out[k] = {"max_abs_err": diff.max().item(), "rel": rel,
                  "within": bool(ok),
                  "bitwise": bool(torch.equal(got[k], want[k]))}
    return out


def _attn(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """``ring`` or ``ulysses`` attention on this rank's block of
    :func:`attn_case`, forward and backward of ``sum(out * g)``: the
    blocks of the output and the gradients (``compare``: held against
    one process's flash attention over the whole sequence, with the
    flash launches of the call), with ``fault`` planted."""
    mesh = make_mesh(sc.get("mesh") or {"sp": size})
    dev = sc.get("device", "cpu")
    dtype = getattr(torch, sc.get("dtype", "float32"))
    full = {k: torch.from_numpy(v).to(dev)
            for k, v in attn_case(sc["shape"], sc.get("seed", 0)).items()}
    for k in ("q", "k", "v"):
        full[k] = full[k].to(dtype)
    block = {k: context.local_block(t, mesh).clone()
             for k, t in full.items()}
    q, k, v = (block[n].requires_grad_() for n in ("q", "k", "v"))
    fn = attn_fn(sc["fn"])
    zero_counts()
    t0 = time.perf_counter()
    with planted(sc.get("fault", ""), rank):
        out = fn(q, k, v, mesh, axis="sp", causal=sc["causal"],
                 impl=sc.get("impl", "auto"))
        fwd = dict(attention.flash_attention.launches)
        dq, dk, dv = torch.autograd.grad((out.float() * block["g"]).sum(),
                                         [q, k, v])
    got = {"out": out.detach(), "dq": dq, "dk": dk, "dv": dv}
    if dev == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not sc.get("compare"):
        return {n: t.float().cpu().numpy() for n, t in got.items()}
    launches = {"forward": fwd,
                "call": dict(attention.flash_attention.launches)}
    # one process, the whole sequence, the flash kernels
    ref = {n: full[n].clone().requires_grad_() for n in ("q", "k", "v")}
    ref_out = attention.flash_attention(ref["q"], ref["k"], ref["v"],
                                        causal=sc["causal"])
    grads = torch.autograd.grad((ref_out.float() * full["g"]).sum(),
                                [ref["q"], ref["k"], ref["v"]])
    want = {"out": context.local_block(ref_out.detach(), mesh)}
    for n, g in zip(("dq", "dk", "dv"), grads):
        want[n] = context.local_block(g, mesh)
    n = mesh.axis_size("sp")
    if dtype == torch.float32:
        errors = _attn_errors(got, want, 2e-5 + 2e-5 * want["out"].abs(),
                              2e-4)
    else:
        mag = attention.flash_attention(full["q"].float(), full["k"].float(),
                                        full["v"].float().abs(),
                                        causal=sc["causal"])
        ulp = torch.exp2(torch.floor(torch.log2(
            want["out"].float().abs().clamp(min=2.0 ** -126))) - 7)
        bound = (BF16_HOP * context.local_block(mag, mesh) + 2 * ulp
                 + 2 * testing.BF16_ATOL)
        errors = _attn_errors(got, want, bound,
                              lambda: bf16_grad_rtol(n))
    return {"fn": sc["fn"], "dtype": sc.get("dtype", "float32"),
            "shape": sc["shape"], "causal": sc["causal"],
            "launches": launches, "errors": errors,
            "ok": all(e["within"] for e in errors.values()),
            "seconds": seconds, "transfers": dict(collectives.transfers)}


def _bert(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """``bert.encode`` in fp32 with ring attention over the mesh's sp
    axis, on this rank's dp block of the batch and sp block of the
    sequence (global positions)."""
    mesh = make_mesh(sc["mesh"])
    params = bridge.params_from_numpy(load_tree(sc["tree"]), device="cpu")
    ids = torch.from_numpy(load_tree(sc["batch"])["input_ids"]).long()
    ids = process_shard(ids, mesh.axis_rank("dp"), mesh.axis_size("dp"))
    ids = context.local_block(ids, mesh, dim=1)
    s_local = ids.shape[1]
    hidden, _ = bert.encode(
        params, ids, dtype=torch.float32,
        attn_impl=functools.partial(context.ring_attention, mesh=mesh,
                                    axis="sp"),
        positions=gpt.block_positions(mesh.axis_rank("sp"), s_local,
                                      ids.device))
    return {"hidden": hidden.detach().numpy()}


def _sprun(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """``examples/train_gpt.make_job`` with the scenario's env (e.g.
    ``TPUJOB_SP=2``) through ``run_training`` on the CPU, saving at the
    end."""
    from paddle_operator_tpu_torch.examples import train_gpt

    job = train_gpt.make_job(sc["env"])
    job.device = "cpu"
    job.checkpoint_every = job.total_steps
    job.log_every = job.total_steps
    out = run_training(job)
    return {"steps": out["steps"], "loss": out["loss"],
            "mesh_history": out["mesh_history"],
            "state": bridge.params_to_numpy(out["state"])}


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


def _mesh(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """The mesh of ``sc["mesh"]`` as this rank sees it: its coordinates,
    and for each axis its rank and size there, the world ranks of its
    group and a sum of the world ranks over that group."""
    mesh = make_mesh(sc["mesh"])
    out: Dict[str, Any] = {"coords": mesh.coords()}
    for name in mesh.shape:
        group = mesh.axis_group(name)
        t = torch.tensor([float(rank)])
        if group is not None:
            dist.all_reduce(t, group=group)
        out[name] = {"rank": mesh.axis_rank(name),
                     "size": mesh.axis_size(name),
                     "ranks": (dist.get_process_group_ranks(group)
                               if group is not None else [rank]),
                     "sum": t.item()}
    return out


def _world(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """The world as this rank sees it, and a sum over it."""
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    return {"size": size, "backend": dist.get_backend(),
            "sum_of_ranks_plus_1": t.item()}


SCENARIOS = {"bn": _bn, "train": _train, "drain": _drain, "run": _run,
             "nccl_pair": _nccl_pair, "world": _world, "attn": _attn,
             "bert": _bert, "sprun": _sprun, "grads": _grads,
             "mesh": _mesh}
#: scenarios that print their result as a JSON line, not to a file
PRINTED = ("run", "nccl_pair", "world", "grads", "mesh")


def printed(sc: dict) -> bool:
    return sc["kind"] in PRINTED or bool(sc.get("compare"))


def worker_main(spec_path: str) -> int:
    """Run a spec's scenarios on this rank of the world ``launch`` made."""
    with open(spec_path) as f:
        spec = json.load(f)
    rank, size = dist.get_rank(), dist.get_world_size()
    for sc in spec["scenarios"]:
        out = SCENARIOS[sc["kind"]](sc, rank, size)
        if printed(sc):
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
                   env: Optional[Dict[str, str]] = None,
                   script: str = os.path.abspath(__file__),
                   during: Optional[Callable] = None) -> List[List[dict]]:
    """Write ``spec`` to ``<spec["out"]>/spec.json``, start ``world``
    workers of ``script`` (default: this file) through ``python -m
    paddle_operator_tpu_torch.launch`` with the operator's env (and
    ``env``), wait for them (killing every one if any fails or the time
    runs out), and return each rank's JSON lines.

    ``during(start)``, if given, runs on a thread of the parent while the
    workers do, and must return before they all have; ``start(rank)``
    starts one more rank of the world (a worker that joins later, at an
    elastic grow). A rank may exit before the others (an elastic
    shrink). The workers' output goes to
    ``<spec["out"]>/rank<r>.{out,err}``."""
    os.makedirs(spec["out"], exist_ok=True)
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs: Dict[int, subprocess.Popen] = {}
    # ``during`` may start a rank while the world is torn down
    lock, closed = threading.Lock(), []

    def start(rank: int) -> None:
        penv = dict(os.environ, **(env or {}))
        penv.update(TPUJOB_NUM_WORKERS=str(world),
                    TPUJOB_WORKER_ID=str(rank),
                    TPUJOB_COORDINATOR="localhost:%d" % port,
                    TPUJOB_DIST_BACKEND=backend,
                    PYTHONPATH=os.pathsep.join(
                        [REPO] + [p for p in os.environ.get(
                            "PYTHONPATH", "").split(os.pathsep) if p]))
        logs = [open(os.path.join(spec["out"], "rank%d.%s" % (rank, ext)),
                     "w") for ext in ("out", "err")]
        with logs[0], logs[1], lock:
            if closed:
                raise RuntimeError("the world of %s has ended" % path)
            procs[rank] = subprocess.Popen(
                [sys.executable, "-m", "paddle_operator_tpu_torch.launch",
                 script, path], cwd=REPO, env=penv, stdout=logs[0],
                stderr=logs[1])

    def read(rank: int, ext: str) -> str:
        with open(os.path.join(spec["out"], "rank%d.%s" % (rank, ext))) as f:
            return f.read()

    deadline = time.monotonic() + timeout
    errors: List[BaseException] = []

    def run_during() -> None:
        try:
            during(start)
        except BaseException as e:  # re-raised below
            errors.append(e)

    thread = threading.Thread(target=run_during, daemon=True)
    try:
        for rank in range(world):
            start(rank)
        if during is not None:
            thread.start()
        # a failed rank fails the world at once, also while ``during``
        # runs: its peers would wait in a collective until the time runs
        # out (``procs`` gains the ranks ``during`` starts: read it whole)
        while any(p.poll() is None for p in list(procs.values())) \
                or thread.is_alive():
            if any(p.poll() for p in list(procs.values())) or errors:
                break
            if time.monotonic() > deadline:
                raise RuntimeError("dp workers timed out after %.0f s"
                                   % timeout)
            time.sleep(0.05)
        for rank in sorted(procs):
            if procs[rank].poll():
                raise RuntimeError("dp worker %d exited %d:\n%s"
                                   % (rank, procs[rank].returncode,
                                      read(rank, "err")[-4000:]))
        if errors:
            raise errors[0]
        results = [[json.loads(line) for line in read(rank, "out").splitlines()
                    if line.startswith("{")] for rank in sorted(procs)]
    finally:
        with lock:
            closed.append(True)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return results

if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1]))
