"""Tensor parallelism checked: scenarios run as the workers of a real
multi-process world.

A worker is started as the operator starts one, through the in-pod entry
(:func:`launch` does it, with this file as the script)::

    TPUJOB_NUM_WORKERS=4 TPUJOB_WORKER_ID=<rank> \\
    TPUJOB_COORDINATOR=localhost:<port> TPUJOB_DIST_BACKEND=gloo \\
        python -m paddle_operator_tpu_torch.launch \\
            paddle_operator_tpu_torch/tp_check.py SPEC.json

and runs the scenarios of the JSON spec in order, writing
``<out>/<scenario>.rank<r>.npz`` or, for the card's scenarios, a JSON
line. ``tests/test_torch_tp.py`` drives it on the CPU (gloo) against the
JAX package's meshes; ``chip_smoke.py``'s train_tp phase drives it on
the card (workers sharing one card over gloo, or a card each over NCCL).

Scenarios (``kind``):

* ``step``: ``build_train_step`` of GPT or BERT TINY (dense or MoE) in
  fp32 on a mesh with the reference's rules (``steps_per_call`` and
  ``init_state`` too; under an sp axis ``seq_axis="sp"`` with ring or
  Ulysses attention, ``attn``), or of ResNet-18 over fsdp with
  ``resnet_rules``: the losses, the clip's norm, the state (this rank's
  tiles) and digests of its replicated and split leaves;
* ``run``: ``run_training`` of a small GPT job on a mesh, writing a
  checkpoint; ``restore``: its newest step restored into a state built
  on another mesh, shard-wise, with the files each rank opened;
* ``job``: ``run_training`` of ``examples/train_gpt.make_job`` on a
  caller's ``mesh_axes``;
* ``card``: ``run_training`` of a :data:`CARD_RUNS` job on the card, with
  per-step losses, clip norms and fingerprints of the replicated leaves
  and of this rank's tiles, step-0 gradients against one process's
  (each tile against its slice), the B1 and B2 launches, peak memory and
  the tp collectives' count, bytes and host seconds.

A scenario may plant a fault (:data:`FAULTS`, :data:`CPU_FAULTS`) that a
gate must reject.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from paddle_operator_tpu_torch import bridge, dp_check, migrate_check, \
    moe_check
from paddle_operator_tpu_torch.models import bert, gpt, resnet
from paddle_operator_tpu_torch.ops import attention, moe, nn, optim
from paddle_operator_tpu_torch.parallel import build_train_step, \
    collectives, context, sharding
from paddle_operator_tpu_torch.parallel import train as train_step
from paddle_operator_tpu_torch.parallel.mesh import make_mesh
from paddle_operator_tpu_torch.runner import TrainJob, bind_mesh, \
    run_training
from paddle_operator_tpu_torch.utils import checkpoint

#: the planted faults, each of which a gate must reject: the row-parallel
#: sum left out (each rank keeps its partial product); the sum over tp of
#: a column-parallel input's gradient left out; the clip's global norm
#: without the tp sum of the split leaves' squares; the vocabulary rows
#: of the embedding looked up one tile off; the fsdp gather's backward
#: cutting the first tile on every rank instead of the rank's own
FAULTS = ("row_sum_dropped", "column_input_unsummed", "norm_without_tp",
          "vocab_shifted", "fsdp_gather_slice")
#: the CPU tests' one more: a row-parallel layer's bias added on every
#: rank before the sum (biases are zero at init: only a tree with
#: non-zero biases shows it)
CPU_FAULTS = FAULTS + ("row_bias_every_rank",)
#: the faults of the model axes beside sp and ep (``hybrid_check``): under
#: tp x sp, the LayerNorms' gradients left as each sp rank's block made
#: them (averaged over the other axes, not summed over sp); under tp x
#: ep, the MoE layers' expert leaves taken for tiles over tp as well
#: (their gradients averaged over dp x sp alone, their squares counted
#: over the ep x tp group in the clip's norm)
HYBRID_FAULTS = ("ln_grad_unsummed_over_sp", "moe_leaves_as_tp_tiles")


def _is_ln(path: str) -> bool:
    parts = path.split("/")
    return len(parts) > 1 and parts[-2].endswith("ln")


def _fault_patch(fault: str):
    """``(object, attribute, replacement)`` of a planted fault."""
    if fault == "row_sum_dropped":
        orig = nn.row_parallel
        return nn, "row_parallel", \
            lambda x, kernel, bias, dtype, group: orig(x, kernel, bias,
                                                       dtype, None)
    if fault == "row_bias_every_rank":
        orig = nn.row_parallel

        def every_rank(x, kernel, bias, dtype, group):
            out = orig(x, kernel, bias, dtype, group)
            n = collectives.size(group)
            return out if bias is None else out + (n - 1) * bias.to(dtype)
        return nn, "row_parallel", every_rank
    if fault == "column_input_unsummed":
        orig = collectives.sum_backward
        return collectives, "sum_backward", \
            lambda x, group, traffic=None: x \
            if traffic is collectives.tp_traffic else orig(x, group, traffic)
    if fault == "norm_without_tp":
        orig = train_step._global_norm
        return train_step, "_global_norm", \
            lambda grads, groups: orig(grads, dict.fromkeys(groups))
    if fault == "vocab_shifted":
        orig = collectives.vocab_lookup
        return collectives, "vocab_lookup", \
            lambda table, ids, tile, dtype: orig(
                table, ids, tile._replace(index=(tile.index + 1)
                                          % tile.count), dtype)
    if fault == "fsdp_gather_slice":
        orig = collectives.last_tile
        return collectives, "last_tile", \
            lambda grad, index, count: orig(grad, 0, count)
    if fault == "ln_grad_unsummed_over_sp":
        orig = train_step._reduce_grads

        def partial_ln(grads, mesh, shards):
            out = orig(train_step._part(grads, lambda k: not _is_ln(k)),
                       mesh, shards)
            ln = collectives.mean_grads(
                train_step._part(grads, _is_ln),
                train_step.replica_group(mesh, ("sp",)))
            return train_step._merge(out, ln)
        return train_step, "_reduce_grads", partial_ln
    if fault == "moe_leaves_as_tp_tiles":
        orig = train_step.layout

        def with_tp(params, optimizer, mesh, rules, local=False):
            out = orig(params, optimizer, mesh, rules, local)
            if mesh is None or mesh.axis_size("tp") == 1:
                return out
            return {k: (t._replace(axes=tuple(sorted(t.axes + ("tp",))))
                        if "/moe/" in k else t) for k, t in out.items()}
        return train_step, "layout", with_tp
    raise ValueError("unknown fault %r" % fault)


@contextlib.contextmanager
def planted(fault: str):
    """Plant ``fault`` ("" for none) for the block; every rank plants it,
    so the collectives stay in step."""
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


def model_rules(model: str) -> list:
    """The rules a model's job carries: the reference's table of the
    model, and ``moe_rules`` for GPT and BERT (BERT's in the reference's
    dry-run order)."""
    if model == "bert":
        return sharding.moe_rules() + sharding.bert_rules()
    if model == "gpt":
        return sharding.gpt_rules() + sharding.moe_rules()
    return sharding.resnet_rules()


def sp_attention(kind: Optional[str], mesh, causal: bool) -> Any:
    """The attention a loss runs on ``mesh``: ring or Ulysses attention
    (``kind``) over its sp axis, or ``"auto"`` without one."""
    if not kind or mesh.axis_size("sp") == 1:
        return "auto"
    fn = {"ring": context.ring_attention,
          "ulysses": context.ulysses_attention}[kind]
    return functools.partial(fn, mesh=mesh, axis="sp", causal=causal)


def leaf_digests(state: Any) -> Dict[str, str]:
    """The sha256 digest of each leaf of a state, by path: hashed once,
    grouped by :func:`digests` and :func:`axes_digests`."""
    return {k: dp_check.digest([v]) for k, v in bridge.flatten(state).items()}


def _joined(hashes: Dict[str, str], keys) -> str:
    return hashlib.sha256("".join(hashes[k] for k in keys).encode()
                          ).hexdigest()


def digests(state: Any, layout: Dict[str, Any],
            hashes: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Digests of a state's replicated leaves and of its tiles (from the
    leaves' ``hashes``, :func:`leaf_digests`)."""
    hashes = hashes or leaf_digests(state)
    return {"replicated": _joined(hashes, [k for k in hashes
                                           if k not in layout]),
            "tiles": _joined(hashes, [k for k in hashes if k in layout])}


# ---------------------------------------------------------------------------
# CPU scenarios
# ---------------------------------------------------------------------------

def _cpu_loss(model: str, attn: Any = "auto"):
    if model == "resnet":
        return functools.partial(resnet.loss_fn, dtype=torch.float32)
    mod = {"gpt": gpt, "bert": bert}[model]
    return lambda p, b: mod.loss_fn(p, b, dtype=torch.float32,
                                    attn_impl=attn)


def cpu_optimizer(model: str, params: Any) -> optim.Optimizer:
    """The CPU step checks' optimizer: adamw(1e-3, wd 0.01 under the wd
    mask) for GPT and BERT, sgd(0.01, momentum 0.9, wd 1e-4 under the
    mask) for ResNet, as ``tests/test_parallel.py`` builds them."""
    if model == "resnet":
        return optim.sgd(0.01, momentum=0.9, weight_decay=1e-4,
                         wd_mask=optim.make_wd_mask(params))
    return optim.adamw(1e-3, weight_decay=0.01,
                       wd_mask=optim.make_wd_mask(params))


def _step(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """A call of ``build_train_step`` on ``sc["mesh"]`` a batch, with the
    model's rules, in fp32, clipped at ``clip``; under an sp axis with
    ``seq_axis="sp"`` and ``sc["attn"]`` attention; ``windows``:
    ``steps_per_call`` 2 on stacked batches; ``stateless``: the calls
    after the first through a step built with ``init_state=False`` on
    the live state."""
    mesh = make_mesh(sc["mesh"])
    model = sc["model"]
    loss = _cpu_loss(model, sp_attention(sc.get("attn"), mesh,
                                         causal=model == "gpt"))
    params = bridge.params_from_numpy(dp_check.load_tree(sc["tree"]), "cpu")
    batches = [bridge.params_from_numpy(dp_check.load_tree(b), "cpu")
               for b in sc["batches"]]
    opt = cpu_optimizer(model, params)
    k = 2 if sc.get("windows") else 1
    sample = batches[0]
    if k > 1:
        batches = [bridge.tree_map(lambda *xs: torch.stack(xs),
                                   *batches[i:i + k])
                   for i in range(0, len(batches), k)]
    build = dict(mesh=mesh, rules=model_rules(model),
                 grad_clip=sc.get("clip"), steps_per_call=k,
                 seq_axis="sp" if mesh.axis_size("sp") > 1 else None,
                 merge_stats=resnet.merge_stats if model == "resnet"
                 else None)
    losses, norms = [], []
    with planted(sc.get("fault", "")):
        step, state = build_train_step(loss, opt, params, sample, **build)
        for i, batch in enumerate(batches):
            fn = step
            if sc.get("stateless") and i > 0:
                fn, none = build_train_step(
                    loss, opt, state["params"], sample,
                    init_state=False, tiles=step.layout, **build)
                assert none is None
            state, m = fn(state, batch)
            losses.append(m["loss"].reshape(-1))
            if "grad_norm" in m:
                norms.append(m["grad_norm"].reshape(-1))
    got = {"losses": torch.cat(losses).numpy(),
           "state": bridge.params_to_numpy(state),
           "split": np.asarray(sorted(step.layout)),
           **{k: np.asarray(v)
              for k, v in digests(state, step.layout).items()}}
    if norms:
        got["grad_norms"] = torch.cat(norms).numpy()
    return got


def tiny_job(steps: int, mesh_axes: Optional[dict], ckpt: str) -> TrainJob:
    """GPT TINY (fp32 loss, adamw, clip 1.0, ``gpt_rules``) on the CPU:
    the checkpoint checks' job."""
    cfg = dict(gpt.TINY_CONFIG, max_seq=32)
    return TrainJob(
        init_params=lambda gen: gpt.init(gen, cfg),
        loss_fn=lambda p, b: gpt.loss_fn(p, b, dtype=torch.float32),
        optimizer=optim.adamw(1e-3, weight_decay=0.1),
        make_batch=lambda gen, step: gpt.synthetic_batch(
            gen, 4, 32, cfg["vocab_size"]),
        grad_clip=1.0, total_steps=steps, log_every=0,
        checkpoint_every=steps, checkpoint_dir=ckpt, device="cpu",
        mesh_axes=mesh_axes, rules=sharding.gpt_rules())


def _run(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    out = run_training(tiny_job(sc["steps"], sc["mesh"], sc["ckpt"]))
    return {"state": bridge.params_to_numpy(out["state"]),
            "mesh_history": np.asarray(json.dumps(out["mesh_history"]))}


def _restore(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """The newest step of ``ckpt`` restored, as the runner restores it,
    into a fresh state of :func:`tiny_job` built on ``mesh``: each rank
    reads its own blocks (:func:`..utils.checkpoint.restore_tiles`). The
    shard files each rank opened are recorded."""
    job = tiny_job(1, sc["mesh"], sc["ckpt"])
    mesh = make_mesh(sc["mesh"])
    params = job.init_params(torch.Generator().manual_seed(1))
    step, state = build_train_step(
        job.loss_fn, job.optimizer, params,
        job.make_batch(torch.Generator().manual_seed(0), 0), mesh=mesh,
        rules=job.rules, grad_clip=job.grad_clip)
    opened = []
    load = checkpoint._load_shard

    def counted(path, *a):
        opened.append(os.path.basename(path))
        return load(path, *a)

    checkpoint._load_shard = counted
    try:
        restored, _ = checkpoint.restore_latest(sc["ckpt"], group=mesh.control,
                                                tiles=step.layout)
    finally:
        checkpoint._load_shard = load
    checkpoint.load_into(state, restored)
    return {"state": bridge.params_to_numpy(state),
            "opened": np.asarray(sorted(opened)),
            "split": np.asarray(sorted(step.layout))}


def _job(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    """``run_training`` of ``examples/train_gpt.make_job(env)`` on the
    CPU with the caller's ``mesh_axes``, with its per-step losses."""
    from paddle_operator_tpu_torch.examples import train_gpt

    job = train_gpt.make_job(sc["env"])
    rec = job.loss_fn = moe_check.Losses(job.loss_fn)
    job.device, job.mesh_axes = "cpu", sc["mesh"]
    out = run_training(job)
    return {"losses": torch.stack(rec.losses).float().numpy(),
            "mesh_history": np.asarray(json.dumps(out["mesh_history"])),
            "state": bridge.params_to_numpy(out["state"])}


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

#: examples/train_gpt.make_job's env of the card's GPT runs: phase
#: train_gpt's (16 x 1024 on its 20-step cosine schedule, of which a run
#: takes the first steps)
GPT_ENV = {"TPUJOB_BATCH": "16", "TPUJOB_SEQ": "1024", "TPUJOB_STEPS": "20"}
#: examples/train_bert.make_job's env of the card's BERT run: phase
#: train_bert's sequence at 16 sequences (at its 64, each of four workers
#: would hold [64, 512, 30522] fp32 logits and their log-softmax)
BERT_ENV = {"TPUJOB_BATCH": "16", "TPUJOB_SEQ": "512", "TPUJOB_STEPS": "5"}
#: run name -> (model, layers, mesh_axes, workers): (a) GPT-2 small at full
#: depth on tp2; (b) at 2 layers on dp2 x tp2; (c) BERT-base at 2 layers
#: on tp4 (the vocabulary's leaves fall back to whole there); (d) phase
#: train's ResNet-50 job on dp2 x fsdp2
CARD_RUNS = {
    "gpt_tp2": ("gpt", 12, {"tp": 2}, 2),
    "gpt_2layers_dp2_tp2": ("gpt", 2, {"dp": 2, "tp": 2}, 4),
    "bert_2layers_tp4": ("bert", 2, {"tp": 4}, 4),
    "resnet50_dp2_fsdp2": ("resnet", 50, {"dp": 2, "fsdp": 2}, 4),
}
#: phase train's ResNet-50 job (migrate_check.resnet_job's scenario keys)
RESNET_SC = {"depth": 50, "classes": 1000, "image": 224, "batch": 128,
             "schedule": 30}


def card_job(run: str, steps: int, mesh: bool = True,
             seed: int = 0) -> TrainJob:
    """A :data:`CARD_RUNS` job for ``steps`` steps, on its mesh or (for
    ``mesh=False``) as one process; parameters and batches from
    ``seed``."""
    model, layers, axes, _ = CARD_RUNS[run]
    if model == "gpt":
        from paddle_operator_tpu_torch.examples import train_gpt

        env = dict(GPT_ENV)
        if layers != gpt.BASE_CONFIG["layers"]:
            env["TPUJOB_LAYERS"] = str(layers)
        job = train_gpt.make_job(env)
    elif model == "bert":
        from paddle_operator_tpu_torch.examples import train_bert

        job = train_bert.make_job(BERT_ENV)
        job.init_params = lambda gen: bert.init(gen, {"layers": layers})
    else:
        job = migrate_check.resnet_job(dict(RESNET_SC, steps=steps))
    return dataclasses.replace(job, total_steps=steps, seed=seed,
                               log_every=steps, checkpoint_dir="",
                               mesh_axes=axes if mesh else None)


def card_setting(run: str):
    """A card run's numerics (:func:`..moe_check.card_setting`): GPT and
    BERT under deterministic algorithms, as phase train_gpt runs; ResNet
    without, as phase train runs (its pooling backward has no
    deterministic kernel)."""
    return moe_check.card_setting(CARD_RUNS[run][0] != "resnet")


def grad_job(job: TrainJob, run: str) -> TrainJob:
    """The job whose step-0 gradients a run's gradient gate reads: the
    run's own, but ResNet's loss in fp32 compute. In bf16 its step-0
    gradient parts from one process's over the whole tree by about 1
    (1.08 on the card): ResNet-50 at init, without zero-initialised
    residual BatchNorm, turns its bf16 rounding into gradients of the
    same size, so only fp32 reads the split's own differences."""
    if CARD_RUNS[run][0] != "resnet":
        return job
    return dataclasses.replace(job, loss_fn=functools.partial(
        resnet.loss_fn, dtype=torch.float32))


def leaf_readings(got: Dict[str, torch.Tensor],
                  ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``{leaf: ||g - g_ref|| / ||g_ref||}`` over the leaves of ``got``."""
    return {k: (torch.linalg.vector_norm(g.float() - ref[k].float())
                / torch.linalg.vector_norm(ref[k].float())).item()
            for k, g in got.items()}


def one_process(run: str, steps: int, out_dir: str) -> Dict[str, Any]:
    """One process's reference for a :data:`CARD_RUNS` run: step 0's
    gradients of :func:`grad_job`, saved under ``out_dir`` for the
    workers (``grads``), and for ``steps`` above 0 the losses of
    ``steps`` steps."""
    with card_setting(run):
        path = os.path.join(out_dir, "%s.grads.pt" % run)
        grads, _ = moe_check.step0(grad_job(card_job(run, 1, mesh=False),
                                            run))
        torch.save(grads, path)
        del grads
        torch.cuda.empty_cache()
        got = {"grads": path}
        if steps:
            rec = moe_check.Losses(card_job(run, steps, mesh=False).loss_fn)
            job = dataclasses.replace(card_job(run, steps, mesh=False),
                                      loss_fn=rec)
            run_training(job)
            got["losses"] = torch.stack(rec.losses).cpu().tolist()
        torch.cuda.empty_cache()
    return got


class _Recorder:
    """A card job's loss wrapped: each step's loss, fingerprints of the
    replicated leaves and of this rank's tiles it starts from, and an
    event at each forward's start. The split leaves are read from the
    step's contexts (:attr:`.collectives.Split.tiles`)."""

    def __init__(self, job: TrainJob) -> None:
        self.loss_fn = job.loss_fn
        self.split: Optional[set] = None
        self.losses, self.starts, self.prints = [], [], []

    def prints_of(self, params) -> list:
        flat = bridge.flatten(params)
        rep = [v for k, v in flat.items() if k not in self.split]
        tiles = [v for k, v in flat.items() if k in self.split]
        return [dp_check.fingerprint(rep)] + (
            [dp_check.fingerprint(tiles)] if tiles else [])

    def __call__(self, params, batch, mesh=None):
        if self.split is None:
            self.split = set(collectives.moe_split().tiles or ())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.starts.append(ev)
        self.prints.append(self.prints_of(params))
        loss, aux = bind_mesh(self.loss_fn, mesh)(params, batch)
        self.losses.append(loss.detach())
        return loss, aux


#: leaves whose step-0 gradient is zero in exact arithmetic, left out of
#: the gradient reading by model: BERT's key bias (without rope, q . b_k
#: is the same for every key of a query, and softmax ignores it), whose
#: computed gradient is rounding noise
ZERO_GRAD_LEAVES = {"bert": ("attn/k/bias",)}


def axes_digests(hashes: Dict[str, str],
                 layout: Dict[str, Any]) -> Dict[str, str]:
    """Digests of a state's leaves (their ``hashes``,
    :func:`leaf_digests`) grouped by the axes they are split over
    (``layout``: parameter path -> ``LeafTile``; an optimizer leaf goes
    with its parameter), ``""`` for the replicated ones: equal on the
    ranks that hold the same tiles."""
    groups: Dict[str, list] = {}
    for k in hashes:
        p = k.split("/", 1)[1] if k.startswith("params/") else next(
            (q for q in layout if k.endswith("/" + q)), None)
        groups.setdefault(",".join(layout[p].axes) if p in layout else "",
                          []).append(k)
    return {a: _joined(hashes, keys) for a, keys in groups.items()}


def card_run(job: TrainJob, grads_ref: str = "", skip=(),
             gjob: Optional[TrainJob] = None) -> Dict[str, Any]:
    """``job`` through ``run_training`` on the card: per-step losses and
    clip norms, per-step fingerprints (replicated leaves; this rank's
    tiles), digests of the final state's two parts (and, with
    ``grads_ref``, by the axes the leaves are split over:
    :func:`axes_digests`), step ms, B1, B2 and B4 launches, peak GB and
    the tp, sp and MoE collectives' traffic; with ``grads_ref``, step 0's
    gradients of ``gjob`` (default ``job``, :func:`grad_job`) against one
    process's, leaf by leaf (replicated leaves whole, each tile against
    its slice, :func:`leaf_readings`), and the largest over the leaves
    not in ``skip`` (leaves ending in one of its entries)."""
    got: Dict[str, Any] = {}
    mesh = make_mesh(job.mesh_axes)
    got["coords"] = mesh.coords()
    layout: Dict[str, Any] = {}
    if grads_ref:
        grads, layout = moe_check.step0(gjob or job, mesh)
        ref = torch.load(grads_ref, map_location=grads[next(iter(grads))]
                         .device)
        for k, t in layout.items():
            ref[k] = train_step.local_block(ref[k], t)
        rel = leaf_readings(grads, ref)
        held = [k for k in rel if not k.endswith(tuple(skip))]
        worst = max(held, key=rel.get)
        got["grads"] = {"max_rel_diff": rel[worst], "leaf": worst}
        got["grads_leaves"] = rel
        del grads, ref
        torch.cuda.empty_cache()
    rec = _Recorder(job)
    job = dataclasses.replace(job, loss_fn=rec)
    norms: list = []
    clip = train_step.clip_by_global_norm

    def recorded_clip(tree, max_norm, norm=None):
        out = clip(tree, max_norm, norm)
        norms.append(out[1].detach())
        return out

    dp_check.zero_counts()
    optim.multi_tensor_sgd.launches = 0
    for traffic in (collectives.tp_traffic, collectives.moe_traffic,
                    moe.moe_apply_fused.launches):
        for k in traffic:
            traffic[k] = 0
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
    hashes = leaf_digests(state)
    split = {"params/" + k for k in rec.split}
    split |= {k for k in bridge.flatten(state)
              if k.startswith("opt/") and any(k.endswith("/" + s)
                                              for s in rec.split)}
    got.update({
        "losses": torch.stack(rec.losses).cpu().tolist(),
        "grad_norms": torch.stack(norms).cpu().tolist() if norms else [],
        "fingerprints": [[p.tolist() for p in ps]
                         for ps in rec.prints[1:] + [rec.prints_of(
                             state["params"])]],
        **digests(state, split, hashes),
        "split_leaves": len(rec.split),
        "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
        "wall_s": time.perf_counter() - t0,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "mesh_history": out["mesh_history"],
        "tp_traffic": dict(collectives.tp_traffic),
        "sp_traffic": dict(collectives.transfers),
        "moe_traffic": dict(collectives.moe_traffic),
        "launches": {"fused_sgd": optim.multi_tensor_sgd.launches,
                     **{"flash_" + k: v for k, v in
                        attention.flash_attention.launches.items()},
                     **moe.moe_apply_fused.launches},
    })
    if layout:
        got["axes_digests"] = axes_digests(hashes, layout)
    return got


def _card(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    with card_setting(sc["run"]), planted(sc.get("fault", "")):
        job = card_job(sc["run"], sc["steps"], seed=sc.get("seed", 0))
        got = card_run(job, sc.get("grads_ref", ""),
                       ZERO_GRAD_LEAVES.get(CARD_RUNS[sc["run"]][0], ()),
                       grad_job(job, sc["run"]))
    return dict(got, run=sc["run"], fault=sc.get("fault", ""))


SCENARIOS = {"step": _step, "run": _run, "restore": _restore, "job": _job,
             "card": _card}
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

def tree_reading(got: Dict[str, torch.Tensor],
                 ref: Dict[str, torch.Tensor]) -> float:
    """||g - g_ref|| / ||g_ref|| over every leaf of ``got`` together."""
    diff = sum(torch.sum(torch.square(g.float() - ref[k].float()))
               for k, g in got.items())
    norm = sum(torch.sum(torch.square(ref[k].float())) for k in got)
    return float(torch.sqrt(diff / norm))


def class_readings(run: str, seeds, backend: str, tmp: str,
                   steps: int = 3) -> Dict[str, Any]:
    """Per seed: the :data:`CARD_RUNS` run ``run``'s job for ``steps``
    steps as one process, as the same one process with every parameter
    one ulp up (what rounding alone makes of the steps), and on its mesh
    (its workers over ``backend``), with each per-step relative
    difference from the one process; and step 0's gradients of the
    gradient gate's job (:func:`grad_job`, fp32 for ResNet) one ulp up
    and on the mesh against one process's, over the tree
    (:func:`tree_reading`) and leaf by leaf (:func:`leaf_readings`), and
    one ulp up in the run's own compute type over the tree."""
    one, nudged, grads = {}, {}, {}
    with card_setting(run):
        for s in seeds:
            step0s = {}
            for out, nudge in ((one, False), (nudged, True)):
                job = card_job(run, steps, mesh=False, seed=s)
                if nudge:
                    job.init_params = dp_check._nudged(job.init_params)
                step0s[nudge] = {
                    "own": moe_check.step0(job)[0],
                    "gate": moe_check.step0(grad_job(job, run))[0]}
                rec = job.loss_fn = moe_check.Losses(job.loss_fn)
                run_training(job)
                out[s] = torch.stack(rec.losses).cpu().tolist()
                torch.cuda.empty_cache()
            ref, up = step0s[False]["gate"], step0s[True]["gate"]
            grads[s] = {
                "one_ulp_up_step0_grads_own": tree_reading(
                    step0s[True]["own"], step0s[False]["own"]),
                "one_ulp_up_step0_grads": tree_reading(up, ref),
                "one_ulp_up_step0_leaves": leaf_readings(up, ref),
                "ref_norms": {k: float(torch.linalg.vector_norm(g.float()))
                              for k, g in ref.items()}}
            torch.save(ref, os.path.join(tmp, "s%d.grads.pt" % s))
            del step0s, ref, up
            torch.cuda.empty_cache()
    lines = launch({"out": tmp, "scenarios": [
        {"kind": "card", "name": "s%d" % s, "run": run, "steps": steps,
         "seed": s, "grads_ref": os.path.join(tmp, "s%d.grads.pt" % s)}
        for s in seeds]}, world=CARD_RUNS[run][3], backend=backend,
        timeout=3000)
    got = {}
    for s in seeds:
        ranks = sorted((ln for r in lines for ln in r
                        if ln["scenario"] == "s%d" % s),
                       key=lambda ln: ln["rank"])
        world = np.mean([ln["losses"] for ln in ranks], axis=0).tolist()
        got[s] = {"one_process": one[s], "one_ulp_up": nudged[s],
                  "world": world,
                  "one_ulp_up_vs_one": moe_check.rel_diffs(nudged[s],
                                                           one[s]),
                  "world_vs_one": moe_check.rel_diffs(world, one[s]),
                  **grads[s],
                  "world_step0_leaves": [ln["grads_leaves"]
                                         for ln in ranks]}
    return got


def main(argv=None) -> int:
    import argparse
    import subprocess
    import tempfile

    parser = argparse.ArgumentParser(
        description="the loss class of a train_tp run on a card")
    parser.add_argument("--run", default="resnet50_dp2_fsdp2",
                        choices=sorted(CARD_RUNS))
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = parser.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="tp_class_") as tmp:
        got = class_readings(args.run, args.seeds, args.backend, tmp)
    print(json.dumps({"card": smi, "run": args.run, "backend": args.backend,
                      "readings": got}), flush=True)
    for s, r in got.items():
        print("%s seed %d (%s, %s): losses: the world %.3g from one "
              "process, one ulp up %.3g; step-0 gradients one ulp up: "
              "%.3g over the tree (%.3g in the run's compute type), %.3g "
              "at the farthest leaf; the world's farthest leaf %.3g" % (
                  args.run, s, args.backend, smi, max(r["world_vs_one"]),
                  max(r["one_ulp_up_vs_one"]),
                  r["one_ulp_up_step0_grads"],
                  r["one_ulp_up_step0_grads_own"],
                  max(r["one_ulp_up_step0_leaves"].values()),
                  max(max(w.values()) for w in r["world_step0_leaves"])),
              flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1].endswith(".json"):
        sys.exit(worker_main(sys.argv[1]))
    sys.exit(main())
