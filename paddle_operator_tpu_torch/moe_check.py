"""MoE across worker processes: checks run as the workers of a real
multi-process world.

A worker is started as the operator starts one, through the in-pod entry
(:func:`.dp_check.launch_workers` does it, with this file as the
script)::

    TPUJOB_NUM_WORKERS=4 TPUJOB_WORKER_ID=<rank> \\
    TPUJOB_COORDINATOR=localhost:<port> TPUJOB_DIST_BACKEND=gloo \\
        python -m paddle_operator_tpu_torch.launch \\
            paddle_operator_tpu_torch/moe_check.py SPEC.json

and runs the scenarios of the JSON spec in order, writing
``<out>/<scenario>.rank<r>.npz`` or, for the card's scenarios, a JSON
line. ``tests/test_torch_moe_ep.py`` drives it on the CPU (gloo) against
the JAX package's meshes; ``chip_smoke.py``'s train_moe_ep phase drives
it on the card (four workers sharing one card over gloo, or a card each
over NCCL).

Scenarios (``kind``):

* ``route``: ``ops.moe._route`` on this rank's block of a global batch
  under a mesh's contexts (dp, sp, ep), the routing integers and the aux
  term;
* ``moe``: ``moe_apply`` (dense, or fused on the kernels' plain
  versions) on a ``{"dp": 2, "ep": 2}`` mesh with this rank's experts,
  its output and gradients, reduced as the train step reduces them;
* ``step``: one ``build_train_step`` call of GPT or BERT TINY_MOE on a
  mesh with the reference's rules, in fp32;
* ``run``: ``run_training`` of a small GPT-MoE job, writing a
  checkpoint; ``restore``: its newest step restored into a state built
  on another mesh;
* ``job``: ``run_training`` of ``examples/train_gpt.make_job`` with
  ``TPUJOB_SP`` and ``TPUJOB_MOE_EXPERTS``;
* ``card``: ``run_training`` of a :data:`CARD_RUNS` job on the card, with
  per-step losses, gradient norms, fingerprints of the replicated and the
  expert leaves, the first MoE layer's routing against one process's,
  step-0 gradients against one process's, B4 launches, peak memory and
  the MoE collectives' host seconds.

A scenario may plant a fault (:data:`FAULTS`) that a gate must reject.

``python -m paddle_operator_tpu_torch.moe_check --seeds 0 1 2 3
--backend gloo`` (on a card) reads the loss class of the card's runs:
one process, one process with its parameters one ulp up, and the
four-worker dp4 and dp2 x ep2 worlds, seed by seed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from paddle_operator_tpu_torch import bridge, dp_check
from paddle_operator_tpu_torch.data import process_shard, step_generator
from paddle_operator_tpu_torch.device import deterministic_algorithms, \
    resolve_device
from paddle_operator_tpu_torch.models import bert, gpt
from paddle_operator_tpu_torch.ops import attention, moe, optim
from paddle_operator_tpu_torch.parallel import build_train_step, \
    collectives, sharding
from paddle_operator_tpu_torch.parallel import train as train_step
from paddle_operator_tpu_torch.parallel.mesh import make_mesh
from paddle_operator_tpu_torch.runner import TrainJob, bind_mesh, \
    run_training
from paddle_operator_tpu_torch.utils.checkpoint import load_into, \
    restore_latest

#: the planted faults, each of which a gate must reject: positions and
#: capacity counted over this rank's tokens alone (the behaviour the
#: port refused before it routed globally); the ep sum left out of the
#: dispatched tokens' cotangent; the clip's global norm without the ep
#: sum of the expert leaves' squares
FAULTS = ("route_per_rank", "ep_x_cotangent", "norm_without_ep")


def _fault_patch(fault: str):
    """``(object, attribute, replacement)`` of a planted fault."""
    if fault == "route_per_rank":
        orig = collectives.moe_split
        return collectives, "moe_split", \
            lambda: collectives.Split(expert=orig().expert)
    if fault == "ep_x_cotangent":
        orig = collectives.sum_backward
        # the dispatched tokens are [T, D]; the gate [T] keeps its sum,
        # and the tp layers' inputs (their own traffic) theirs
        return collectives, "sum_backward", \
            lambda x, group, traffic=None: x \
            if x.dim() == 2 and traffic is None else orig(x, group, traffic)
    if fault == "norm_without_ep":
        orig = train_step._global_norm
        return train_step, "_global_norm", \
            lambda grads, groups: orig(grads, dict.fromkeys(groups))
    raise ValueError("unknown fault %r" % fault)


@contextlib.contextmanager
def planted(fault: str):
    """Plant ``fault`` (one of :data:`FAULTS`, or "" for none) for the
    block; every rank plants it, so the collectives stay in step."""
    if not fault:
        yield
        return
    obj, name, patched = _fault_patch(fault)
    orig = getattr(obj, name)
    setattr(obj, name, patched)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def block_of(x: np.ndarray, mesh, seq: bool = True) -> np.ndarray:
    """This rank's block of a global ``[B, S, ...]`` array: its dp rows
    and, with ``seq``, its sp block of the token axis."""
    rows = process_shard(x, mesh.axis_rank("dp"), mesh.axis_size("dp"))
    if seq and mesh.axis_size("sp") > 1:
        n = rows.shape[1] // mesh.axis_size("sp")
        i = mesh.axis_rank("sp")
        rows = rows[:, i * n:(i + 1) * n]
    return np.ascontiguousarray(rows)


def expert_where(mesh) -> tuple:
    """(this rank's ep index, ep size)."""
    return mesh.axis_rank("ep"), mesh.axis_size("ep")


# ---------------------------------------------------------------------------
# CPU scenarios
# ---------------------------------------------------------------------------

def _route(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    mesh = make_mesh(sc["mesh"])
    tree = dp_check.load_tree(sc["tree"])
    x = torch.from_numpy(block_of(dp_check.load_tree(sc["x"])["x"], mesh))
    params = bridge.params_from_numpy(tree, device="cpu")
    seq_axis = "sp" if mesh.axis_size("sp") > 1 else None
    with planted(sc.get("fault", "")), \
            train_step.shard_contexts(mesh, "dp", seq_axis):
        gate, choice, pos, cap, aux = moe._route(
            params, x, sc["capacity_factor"], collectives.moe_split())
    return {"gate": gate.numpy(), "choice": choice.numpy(),
            "pos": pos.numpy(), "keep": (pos < cap).numpy(),
            "capacity": np.asarray(cap), "aux": aux["moe_aux_loss"].numpy()}


def moe_loss(out: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """The MoE checks' loss of a block: the mean over its tokens of the
    squared output's row sums, plus the aux term (averaged over dp, the
    global batch's loss)."""
    return torch.mean(torch.sum(out.float() ** 2, dim=-1)) + aux


def _moe(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """``moe_apply`` on ``{"dp": 2, "ep": 2}``: this rank's experts,
    dense or fused (the kernels' plain versions on the CPU)."""
    mesh = make_mesh(sc["mesh"])
    where = expert_where(mesh)
    # a bare moe_init tree: its wi/wo at the root
    tree = bridge.ep_slice(dp_check.load_tree(sc["tree"]), *where,
                           rules=[(r"^w(i|o)$", ("ep", None, None))])
    params = {k: torch.from_numpy(np.asarray(v)).requires_grad_()
              for k, v in bridge.flatten(tree).items()}
    x = torch.from_numpy(block_of(dp_check.load_tree(sc["x"])["x"], mesh)
                         ).requires_grad_()
    nested = bridge.unflatten(bridge.structure(tree), params)
    apply = moe.moe_apply_fused if sc.get("fused") else \
        lambda *a, **k: moe.moe_apply(*a, fused=False, **k)
    with planted(sc.get("fault", "")), \
            train_step.shard_contexts(mesh, "dp"):
        out, aux = apply(nested, x, capacity_factor=sc["capacity_factor"],
                         dtype=torch.float32)
        loss = moe_loss(out, aux["moe_aux_loss"])
        grads = torch.autograd.grad(loss, [x] + list(params.values()))
    named = dict(zip(params, grads[1:]))
    experts = {k: ("ep",) for k in named if k in ("wi", "wo")}
    reduced = bridge.flatten(train_step.reduce_step_grads(
        bridge.unflatten(bridge.structure(tree), named), mesh, 1, experts))
    return {"out": out.detach().numpy(), "aux": aux["moe_aux_loss"]
            .detach().numpy(), "dx": grads[0].numpy(),
            **{"d_" + k.replace("/", "_"): v.numpy()
               for k, v in reduced.items()}}


def cpu_model(model: str):
    """(module, config, fp32 loss) of the CPU step checks: GPT or BERT
    TINY_MOE."""
    mod = {"gpt": gpt, "bert": bert}[model]
    return mod, mod.TINY_MOE_CONFIG, \
        lambda p, b: mod.loss_fn(p, b, dtype=torch.float32)


def _step(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """One ``build_train_step`` call on a mesh with the rules, in fp32,
    adamw(1e-3) with a wd mask, clipped at ``clip``."""
    mesh = make_mesh(sc["mesh"])
    mod, _, loss_fn = cpu_model(sc["model"])
    tree = dp_check.load_tree(sc["tree"])
    batch = bridge.params_from_numpy(dp_check.load_tree(sc["batch"]), "cpu")
    params = bridge.params_from_numpy(tree, device="cpu")
    rules = (sharding.gpt_rules() if sc["model"] == "gpt"
             else sharding.bert_rules()) + sharding.moe_rules()
    opt = optim.adamw(1e-3, weight_decay=0.01,
                      wd_mask=optim.make_wd_mask(params))
    with planted(sc.get("fault", "")):
        step, state = build_train_step(loss_fn, opt, params, batch,
                                       mesh=mesh, rules=rules,
                                       grad_clip=sc.get("clip"))
        state, m = step(state, batch)
    experts = set(step.layout)
    flat = bridge.flatten(state)
    return {"loss": m["loss"].numpy(), "grad_norm": m["grad_norm"].numpy(),
            "moe_aux": m["moe_aux"].numpy(),
            "state": bridge.params_to_numpy(state),
            "dense_digest": np.asarray(dp_check.digest(
                [v for k, v in flat.items() if k not in experts])),
            "expert_digest": np.asarray(dp_check.digest(
                [v for k, v in flat.items() if k in experts]))}


def tiny_moe_job(steps: int, mesh_axes: Optional[dict], ckpt: str) -> TrainJob:
    """GPT TINY_MOE (fp32 loss, adamw, clip 1.0, the reference's rules)
    on the CPU: the checkpoint checks' job."""
    cfg = dict(gpt.TINY_MOE_CONFIG, max_seq=32)
    return TrainJob(
        init_params=lambda gen: gpt.init(gen, cfg),
        loss_fn=lambda p, b: gpt.loss_fn(p, b, dtype=torch.float32),
        optimizer=optim.adamw(1e-3, weight_decay=0.1),
        make_batch=lambda gen, step: gpt.synthetic_batch(
            gen, 4, 32, cfg["vocab_size"]),
        grad_clip=1.0, total_steps=steps, log_every=0,
        checkpoint_every=steps, checkpoint_dir=ckpt, device="cpu",
        mesh_axes=mesh_axes,
        rules=sharding.gpt_rules() + sharding.moe_rules())


def _run(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    out = run_training(tiny_moe_job(sc["steps"], sc["mesh"], sc["ckpt"]))
    return {"state": bridge.params_to_numpy(out["state"]),
            "steps": np.asarray(out["steps"]),
            "resume_steps": np.asarray(out.get("resume_steps", [])),
            "mesh_history": np.asarray(json.dumps(out["mesh_history"]))}


def _restore(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """The newest step of ``ckpt`` restored into a fresh state of
    :func:`tiny_moe_job` built on ``mesh`` (the runner's restore)."""
    job = tiny_moe_job(1, sc["mesh"], sc["ckpt"])
    mesh = make_mesh(sc["mesh"])
    params = job.init_params(torch.Generator().manual_seed(1))
    step, state = build_train_step(
        job.loss_fn, job.optimizer, params,
        job.make_batch(torch.Generator().manual_seed(0), 0), mesh=mesh,
        rules=job.rules, grad_clip=job.grad_clip)
    restored, _ = restore_latest(sc["ckpt"], group=mesh.control)
    load_into(state, restored, step.layout)
    return {"state": bridge.params_to_numpy(state)}


class Losses:
    """A job's loss wrapped: each call's loss, kept on the device."""

    def __init__(self, loss_fn) -> None:
        self.loss_fn, self.losses = loss_fn, []

    def __call__(self, params, batch, mesh=None):
        loss, aux = bind_mesh(self.loss_fn, mesh)(params, batch)
        self.losses.append(loss.detach())
        return loss, aux


def _job(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """``run_training`` of ``examples/train_gpt.make_job(env)`` on the
    CPU, with its per-step losses (this rank's part)."""
    from paddle_operator_tpu_torch.examples import train_gpt

    job = train_gpt.make_job(sc["env"])
    rec = job.loss_fn = Losses(job.loss_fn)
    job.device = "cpu"
    out = run_training(job)
    return {"losses": torch.stack(rec.losses).float().numpy(),
            "mesh_history": np.asarray(json.dumps(out["mesh_history"])),
            "state": bridge.params_to_numpy(out["state"])}


# ---------------------------------------------------------------------------
# the card: GPT-2 small with 8-expert MoE FFNs (examples/train_gpt.py)
# ---------------------------------------------------------------------------

#: examples/train_gpt.make_job's env of the card runs: phase
#: train_gpt_moe's (16 x 1024, 8 experts on every second layer, a 10-step
#: cosine schedule, of which a run takes the first ``steps``)
CARD_ENV = {"TPUJOB_BATCH": "16", "TPUJOB_SEQ": "1024", "TPUJOB_STEPS": "10",
            "TPUJOB_MOE_EXPERTS": "8"}
#: run name -> (env over CARD_ENV, mesh_axes set on the job): GPT-2 small
#: at 12 layers on dp4 (the example's own path at four workers) and on
#: dp2 x ep2 (the reference's rules, set as its tests set them); at 2
#: layers with TPUJOB_SP=2 (dp2 x sp2 on four workers) and on dp2 x ep2
CARD_RUNS = {
    "dp4": ({}, None),
    "dp2_ep2": ({}, {"dp": 2, "ep": 2}),
    "sp2_2layers": ({"TPUJOB_LAYERS": "2", "TPUJOB_SP": "2"}, None),
    "dp2_ep2_2layers": ({"TPUJOB_LAYERS": "2"}, {"dp": 2, "ep": 2}),
}
#: the one-process run each world run is held against: its depth
ONE_PROCESS = {"dp4": "12layers", "dp2_ep2": "12layers",
               "sp2_2layers": "2layers", "dp2_ep2_2layers": "2layers"}


def card_job(run: str, steps: int, seed: int = 0) -> TrainJob:
    """A :data:`CARD_RUNS` job (or, for ``"12layers"``/``"2layers"``, the
    one-process job of that depth) on the card, ``steps`` steps of the
    10-step schedule, parameters and batches from ``seed``."""
    from paddle_operator_tpu_torch.examples import train_gpt

    if run in ("12layers", "2layers"):
        env, axes = ({} if run == "12layers" else {"TPUJOB_LAYERS": "2"},
                     None)
    else:
        env, axes = CARD_RUNS[run]
    job = train_gpt.make_job(dict(CARD_ENV, **env))
    if axes is not None:
        job.mesh_axes = axes
    return dataclasses.replace(job, total_steps=steps, seed=seed,
                               log_every=steps)


@contextlib.contextmanager
def card_setting(deterministic: bool = True):
    """The card runs' numerics, as the one-process phases run: TF32 off,
    deterministic cuDNN without autotuning (phase train), the MoE
    kernels, and with ``deterministic`` deterministic algorithms (phase
    train_gpt: the embedding's index backward is atomic otherwise;
    ResNet's pooling backward has no deterministic kernel)."""
    cudnn = torch.backends.cudnn
    saved = (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
             cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             os.environ.get("TPUJOB_MOE_FUSED"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = \
        False, True, False
    if deterministic:
        deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    os.environ["TPUJOB_MOE_FUSED"] = "1"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
         cudnn.deterministic, cudnn.benchmark) = saved[:4]
        deterministic_algorithms(saved[4])
        if saved[5] is None:
            os.environ.pop("TPUJOB_MOE_FUSED", None)
        else:
            os.environ["TPUJOB_MOE_FUSED"] = saved[5]


@contextlib.contextmanager
def first_route(log: list):
    """While open, the first ``moe._route`` call's routing (the first MoE
    layer's forward at step 0) is put in ``log`` as a ``[3, B, S]`` int64
    tensor (choice, position, kept) over the call's tokens."""
    route = moe._route

    def logged(*args):
        out = route(*args)
        if not log:
            log.append(torch.stack((out[1], out[2], (out[2] < out[3]).long()
                                    )).reshape(3, *args[1].shape[:2]))
        return out

    moe._route = logged
    try:
        yield
    finally:
        moe._route = route


def step0(job: TrainJob, mesh=None, routes: Optional[list] = None):
    """Step 0's gradients of ``job`` on the card (its parameters and
    first global batch as ``run_training`` draws them), reduced as the
    train step reduces them; under a mesh this rank's block, its tiles'
    gradients only (the leaves its rules split over ep, tp or fsdp).
    Returns ``{leaf: grad}`` and ``{leaf: LeafTile}`` of the split
    parameter leaves."""
    dev = resolve_device(None, "moe_check.step0")
    params = job.init_params(torch.Generator(device=dev).manual_seed(
        job.seed))
    batch = job.make_batch(step_generator(job.seed, 0, dev), 0)
    tiles, shards = {}, 1
    if mesh is not None:
        batch = process_shard(batch, mesh.axis_rank("dp"),
                              mesh.axis_size("dp"))
        tiles = train_step.layout(params, job.optimizer, mesh, job.rules)
        shards = mesh.axis_size(job.seq_axis) if job.seq_axis else 1
    layout = {k[len("params/"):]: v for k, v in tiles.items()
              if k.startswith("params/")}
    flat = bridge.flatten(params)
    for k, where in layout.items():
        flat[k] = train_step.local_block(flat[k], where)
    params = bridge.unflatten(bridge.structure(params), flat)
    with train_step.shard_contexts(
            mesh, "dp", job.seq_axis,
            train_step.model_tiles(mesh, tiles) if tiles else None), \
            first_route(routes if routes is not None else []):
        _, grads = train_step._grads_of(bind_mesh(job.loss_fn, mesh),
                                        params, batch)
    grads = train_step.reduce_step_grads(
        grads, mesh, shards, {k: t.axes for k, t in layout.items()})
    return {k: g for k, g in bridge.flatten(grads).items()
            if g is not None}, layout


def one_process(run: str, steps: int, out_dir: str, seed: int = 0
                ) -> Dict[str, Any]:
    """One process's reference for world runs of depth ``run``
    (``"12layers"``, ``"2layers"``): step 0's gradients and the first MoE
    layer's routing, saved under ``out_dir`` for the workers, and (for
    ``steps`` above 0) :func:`card_run`'s readings of ``steps`` steps."""
    with card_setting():
        routes: list = []
        grads, _ = step0(card_job(run, 1, seed), routes=routes)
        paths = {"grads": os.path.join(out_dir, "%s.s%d.grads.pt"
                                       % (run, seed)),
                 "routes": os.path.join(out_dir, "%s.s%d.routes.pt"
                                        % (run, seed))}
        torch.save(grads, paths["grads"])
        torch.save(routes[0].cpu(), paths["routes"])
        del grads
        torch.cuda.empty_cache()
        got = card_run(card_job(run, steps, seed)) if steps else {}
    return dict(got, **paths)


class _Recorder:
    """A card job's loss wrapped: each step's loss, fingerprints of the
    replicated and of the expert leaves it starts from, and an event at
    each forward's start. The expert leaves are read from the mesh the
    runner hands the loss, on the first call."""

    def __init__(self, job: TrainJob) -> None:
        self.job, self.loss_fn = job, job.loss_fn
        self.experts: Optional[set] = None
        self.losses, self.starts, self.prints = [], [], []

    def prints_of(self, params) -> List[torch.Tensor]:
        flat = bridge.flatten(params)
        dense = [v for k, v in flat.items() if k not in self.experts]
        expert = [v for k, v in flat.items() if k in self.experts]
        return [dp_check.fingerprint(dense)] + (
            [dp_check.fingerprint(expert)] if expert else [])

    def __call__(self, params, batch, mesh=None):
        if self.experts is None:
            self.experts = {k[len("params/"):] for k in
                            train_step.layout(
                                params, self.job.optimizer, mesh,
                                self.job.rules, local=True)
                            if k.startswith("params/")}
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.starts.append(ev)
        self.prints.append(self.prints_of(params))
        loss, aux = bind_mesh(self.loss_fn, mesh)(params, batch)
        self.losses.append(loss.detach())
        return loss, aux


def card_run(job: TrainJob, routes_ref: str = "",
             grads_ref: str = "") -> Dict[str, Any]:
    """``job`` through ``run_training`` on the card: per-step losses and
    gradient norms, per-step fingerprints (replicated leaves; expert
    leaves), digests of the final state's two parts, step ms, B4 and
    flash launches, peak GB, the MoE collectives' traffic, and the run's
    step profile, straggler events and last gang view; with
    ``routes_ref``, the tokens of the first MoE layer at step 0 routed
    apart from one process's; with ``grads_ref``, step 0's gradients
    against one process's (replicated leaves whole, expert leaves this
    rank's block)."""
    got: Dict[str, Any] = {}
    if routes_ref or grads_ref:
        mesh = make_mesh(job.mesh_axes) if job.mesh_axes else make_mesh()
        routes: list = []
        grads, layout = step0(job, mesh, routes)
        if routes_ref:
            got["routing_apart"] = routing_apart(
                routes[0], torch.load(routes_ref), mesh)
        if grads_ref:
            ref = torch.load(grads_ref, map_location=grads[next(iter(grads))]
                             .device)
            for k, where in layout.items():
                ref[k] = train_step.local_block(ref[k], where)
            got["grads_dense"] = dp_check.grad_reading(
                {k: g for k, g in grads.items() if k not in layout}, ref)
            if layout:
                got["grads_expert"] = dp_check.grad_reading(
                    {k: g for k, g in grads.items() if k in layout}, ref)
        del grads
        torch.cuda.empty_cache()
    rec = _Recorder(job)
    job = dataclasses.replace(job, loss_fn=rec)
    norms: list = []
    clip = train_step.clip_by_global_norm

    def recorded_clip(tree, max_norm, norm=None):
        out = clip(tree, max_norm, norm)
        norms.append(out[1].detach())
        return out

    for counts in (moe.moe_apply_fused.launches,
                   moe.moe_apply_fused.path_launches):
        counts.update(dict.fromkeys(counts, 0))
    dp_check.zero_counts()
    for k in collectives.moe_traffic:
        collectives.moe_traffic[k] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_step.clip_by_global_norm = recorded_clip
    try:
        out = run_training(job)
    finally:
        train_step.clip_by_global_norm = clip
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    marks = rec.starts + [end]
    state = out["state"]
    experts = {"params/" + k for k in rec.experts}
    experts |= {k for k in bridge.flatten(state)
                if any(k.endswith("/" + e) for e in rec.experts)}
    flat = bridge.flatten(state)
    got.update({
        "losses": torch.stack(rec.losses).cpu().tolist(),
        "grad_norms": torch.stack(norms).cpu().tolist(),
        "fingerprints": [[p.tolist() for p in ps]
                         for ps in rec.prints[1:] + [rec.prints_of(
                             state["params"])]],
        "dense_digest": dp_check.digest(
            [v for k, v in flat.items() if k not in experts]),
        "expert_digest": dp_check.digest(
            [v for k, v in flat.items() if k in experts]),
        "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
        "wall_s": time.perf_counter() - t0,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "mesh_history": out["mesh_history"],
        "moe_traffic": dict(collectives.moe_traffic),
        "launches": {**dict(moe.moe_apply_fused.launches),
                     **{"flash_" + k: v for k, v in
                        attention.flash_attention.launches.items()}},
        "path_launches": dict(moe.moe_apply_fused.path_launches),
        "step_profile": out["step_profile"],
        "straggler_events": out["straggler_events"],
        "gang_p50": {str(k): v for k, v in out.get("gang_p50", {}).items()},
    })
    return got


def routing_apart(got: torch.Tensor, ref: torch.Tensor, mesh
                  ) -> Dict[str, int]:
    """This rank's block ``got`` ``[3, B, S]`` (choice, position, kept)
    against one process's routing ``ref`` ``[3, B, S]`` of the global
    batch: tokens sent to another expert, tokens kept in one and dropped
    in the other, and the largest shift of a position among the tokens
    of the same expert (a token routed elsewhere earlier in the global
    order shifts every later one of its expert by one)."""
    want = torch.from_numpy(block_of(ref.permute(1, 2, 0).numpy(), mesh)
                            ).permute(2, 0, 1).to(got.device)
    same = got[0] == want[0]
    shift = (got[1] - want[1]).abs()[same]
    return {"expert": int((~same).sum()),
            "drop": int((got[2] != want[2]).sum()),
            "position_shift": int(shift.max()) if shift.numel() else 0}


def _card(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    with card_setting(), planted(sc.get("fault", "")):
        got = card_run(card_job(sc["run"], sc["steps"], sc.get("seed", 0)),
                       sc.get("routes_ref", ""), sc.get("grads_ref", ""))
    return dict(got, run=sc["run"], fault=sc.get("fault", ""))


SCENARIOS = {"route": _route, "moe": _moe, "step": _step, "run": _run,
             "restore": _restore, "job": _job, "card": _card}
#: scenarios that print their result as a JSON line, not to a file
PRINTED = ("card",)


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
            dp_check.save_tree(os.path.join(spec["out"], "%s.rank%d.npz"
                                            % (sc["name"], rank)), out)
    return 0


def launch(spec: dict, world: int = 4, backend: str = "gloo",
           timeout: float = 600.0, env: Optional[Dict[str, str]] = None):
    """:func:`.dp_check.launch_workers` with this file as the script."""
    return dp_check.launch_workers(spec, world=world, backend=backend,
                                   timeout=timeout, env=env,
                                   script=os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# the loss class of the card's runs
# ---------------------------------------------------------------------------

#: steps of each class reading (the phase's)
CLASS_STEPS = 5


def rel_diffs(got: List[float], want: List[float]) -> List[float]:
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def class_readings(seeds, backend: str, tmp: str) -> Dict[str, Any]:
    """Per seed: one process's losses of CLASS_STEPS steps at 12 layers,
    the same one process with every parameter one ulp up (what rounding
    alone makes of the steps), and the dp4 and dp2 x ep2 worlds' (four
    workers over ``backend``), each world's per-step relative differences
    from one process and from each other."""
    one, nudged = {}, {}
    with card_setting():
        for s in seeds:
            one[s] = card_run(card_job("12layers", CLASS_STEPS, s))["losses"]
            job = card_job("12layers", CLASS_STEPS, s)
            job.init_params = dp_check._nudged(job.init_params)
            nudged[s] = card_run(job)["losses"]
    torch.cuda.empty_cache()
    scenarios = [{"kind": "card", "name": "%s_s%d" % (run, s), "run": run,
                  "steps": CLASS_STEPS, "seed": s}
                 for s in seeds for run in ("dp4", "dp2_ep2")]
    lines = launch({"out": tmp, "scenarios": scenarios}, world=4,
                   backend=backend, timeout=3000)
    got = {}
    for s in seeds:
        runs = {run: np.mean([ln["losses"] for r in lines for ln in r
                              if ln["scenario"] == "%s_s%d" % (run, s)],
                             axis=0).tolist()
                for run in ("dp4", "dp2_ep2")}
        got[s] = {"one_process": one[s], "one_ulp_up": nudged[s], **runs,
                  "one_ulp_up_vs_one": rel_diffs(nudged[s], one[s]),
                  "dp4_vs_one": rel_diffs(runs["dp4"], one[s]),
                  "dp2_ep2_vs_one": rel_diffs(runs["dp2_ep2"], one[s]),
                  "dp2_ep2_vs_dp4": rel_diffs(runs["dp2_ep2"], runs["dp4"])}
    return got


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = parser.parse_args(argv)
    smi = dp_check.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="moe_class_") as tmp:
        got = class_readings(args.seeds, args.backend, tmp)
    print(json.dumps({"card": smi, "backend": args.backend,
                      "steps": CLASS_STEPS, "readings": got}), flush=True)
    for s, r in got.items():
        print("seed %d (%s, %s): dp4 %.3g, dp2 x ep2 %.3g from one process, "
              "%.3g apart; one process one ulp up %.3g" % (
                  s, args.backend, smi, max(r["dp4_vs_one"]),
                  max(r["dp2_ep2_vs_one"]), max(r["dp2_ep2_vs_dp4"]),
                  max(r["one_ulp_up_vs_one"])), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1].endswith(".json"):
        sys.exit(worker_main(sys.argv[1]))
    sys.exit(main())
