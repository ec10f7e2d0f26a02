"""Pipeline parallelism checked: scenarios run as the workers of a real
multi-process world.

A worker is started as the operator starts one, through the in-pod entry
(:func:`launch` does it, with this file as the script)::

    TPUJOB_NUM_WORKERS=4 TPUJOB_WORKER_ID=<rank> \\
    TPUJOB_COORDINATOR=localhost:<port> TPUJOB_DIST_BACKEND=gloo \\
        python -m paddle_operator_tpu_torch.launch \\
            paddle_operator_tpu_torch/pp_check.py SPEC.json

and runs the scenarios of the JSON spec in order, writing
``<out>/<scenario>.rank<r>.npz`` or, for the card's scenario, a JSON
line. ``tests/test_torch_pipeline.py`` drives it on the CPU (gloo)
against the JAX package's ``pipeline_apply``; ``chip_smoke.py``'s
train_pp phase drives it on the card.

Scenarios (``kind``):

* ``mlp``: :func:`..parallel.pipeline.pipeline_apply` of the reference
  tests' two-layer ReLU stage on a stacked tree and an input (npz), on
  a mesh with ``pp``: the output and, with ``grad``, the gradients of
  ``sum(out ** 2)`` with respect to the stacked tree (whole, or this
  rank's block with ``form="local"``) and the input;
* ``gpt``: GPT whose blocks are split into stages (:func:`split_gpt`):
  the embedding, the final LayerNorm and the LM head on every rank, the
  blocks pipelined (:func:`gpt_pipeline_loss`); the loss and the
  gradients of the whole tree;
* ``shard``: :func:`..parallel.pipeline.shard_stacked_params` of a
  stacked tree, this rank's blocks;
* ``card``: GPT-2 small's 12 blocks as four stages of three on
  ``{"pp": 4}`` on the card, :data:`CARD_STEPS` adamw steps of a batch
  of :data:`CARD_BATCH` sequences as :data:`CARD_MICRO` microbatches:
  per-step losses, fingerprints of the replicated leaves, step-0
  gradients against one process's (this rank's stage against its
  block), flash launches, the pipeline's traffic, step ms and peak GB.

A scenario may plant a fault (:data:`FAULTS`) that a gate must reject.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from paddle_operator_tpu_torch import bridge, dp_check, moe_check
from paddle_operator_tpu_torch.data import step_generator
from paddle_operator_tpu_torch.device import resolve_device
from paddle_operator_tpu_torch.models import gpt
from paddle_operator_tpu_torch.ops import attention, nn, optim
from paddle_operator_tpu_torch.parallel import collectives, pipeline
from paddle_operator_tpu_torch.parallel.mesh import Mesh, make_mesh

#: the planted faults, each of which a gate must reject: (i) the output
#: sum's backward all-reduces the cotangent (every rank's gradient S
#: times too large); (ii) the last stage banks its output at t - S, a
#: tick early; (iii) the parameters of stages 0 and 1 swapped
FAULTS = ("sum_backward_reduces", "bank_one_early", "stages_swapped")


def _fault_patch(fault: str):
    """``(object, attribute, replacement)`` of a planted fault."""
    if fault == "sum_backward_reduces":
        orig = collectives.sum_forward

        def reduced(x, group, traffic=None):
            out = orig(x, group, traffic)
            if traffic is collectives.pp_traffic:
                out = collectives.sum_backward(out, group, traffic)
            return out
        return collectives, "sum_forward", reduced
    if fault == "bank_one_early":
        return pipeline, "bank_index", lambda t, n_stages: t - n_stages
    if fault == "stages_swapped":
        return pipeline, "param_slot", \
            lambda stage, n_stages: {0: 1, 1: 0}.get(stage, stage)
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


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def mlp_stage(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The reference tests' stage: ``relu(x @ w1) @ w2``."""
    return torch.relu(x @ params["w1"]) @ params["w2"]


def split_gpt(params: Dict, n_stages: int):
    """``(rest, stacked)``: a GPT tree's embedding, final LayerNorm and LM
    head, and its blocks as ``n_stages`` stages of consecutive blocks
    stacked (each stage a list of blocks, each leaf with a leading stage
    axis)."""
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError("%d blocks do not split into %d stages"
                         % (len(layers), n_stages))
    k = len(layers) // n_stages
    rest = {key: v for key, v in params.items() if key != "layers"}
    return rest, pipeline.stack_stage_params(
        [layers[s * k:(s + 1) * k] for s in range(n_stages)])


def gpt_stage_fn(dtype: torch.dtype, attn_impl: Any = "auto"):
    """A stage of GPT blocks: each block of the stage's list in turn
    (``models.gpt._block``, causal attention), its zero aux dropped."""
    def stage_fn(blocks, x):
        for layer in blocks:
            x, _ = gpt._block(layer, x, dtype, attn_impl, None)
        return x
    return stage_fn


def gpt_pipeline_loss(tree: Dict, batch: Dict, mesh: Optional[Mesh],
                      n_micro: int, dtype: torch.dtype = torch.bfloat16,
                      ce_chunk: int = 1024) -> torch.Tensor:
    """GPT's next-token loss with its blocks pipelined: ``tree`` is
    ``{"rest", "stages"}`` (:func:`split_gpt`; stages whole or this
    rank's block). The token embedding, the final LayerNorm and the
    chunked LM-head cross-entropy run on every rank; ``mesh=None`` runs
    the stages in sequence in one process (the reference's sequential
    check)."""
    rest, stages = tree["rest"], tree["stages"]
    ids = batch["input_ids"]
    labels = ids[:, 1:].long()
    x = nn.embedding(rest["embed"]["tok"], ids, dtype)
    stage_fn = gpt_stage_fn(dtype)
    if mesh is None:
        n = int(bridge.leaves(stages)[0].shape[0])
        for s in range(n):
            x = stage_fn(bridge.tree_map(lambda a: a[s], stages), x)
    else:
        x = pipeline.pipeline_apply(stages, x, stage_fn, mesh, n_micro)
    h = nn.layernorm(rest["final_ln"], x, dtype=dtype)
    if ce_chunk:
        loss, _ = nn.chunked_lm_xent(rest["lm_head"], h[:, :-1], labels,
                                     chunk=ce_chunk, dtype=dtype)
        return loss
    logits = nn.dense(rest["lm_head"], h[:, :-1], dtype=torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None]).mean()


def value_and_grads(fn, tree: Any):
    """``(fn(tree), grads)``, the grads in the tree's structure."""
    flat = bridge.flatten(tree)
    views = {k: t.detach().requires_grad_(True) for k, t in flat.items()}
    with torch.enable_grad():
        out = fn(bridge.unflatten(bridge.structure(tree), views))
        got = torch.autograd.grad(out, list(views.values()),
                                  allow_unused=True)
    grads = {k: (torch.zeros_like(views[k]) if g is None else g)
             for k, g in zip(views, got)}
    return out.detach(), bridge.unflatten(bridge.structure(tree), grads)


# ---------------------------------------------------------------------------
# CPU scenarios
# ---------------------------------------------------------------------------

def _load(path: str) -> Any:
    return bridge.params_from_numpy(dp_check.load_tree(path), "cpu")


def _mlp(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    mesh = make_mesh(sc["mesh"])
    stacked = _load(sc["stacked"])
    x = _load(sc["x"])["x"]
    if sc.get("form") == "local":
        stacked = pipeline.shard_stacked_params(stacked, mesh)
    with planted(sc.get("fault", "")):
        if not sc.get("grad"):
            out = pipeline.pipeline_apply(stacked, x, mlp_stage, mesh,
                                          sc["n_micro"])
            return {"out": out.numpy()}
        tree = {"stacked": stacked, "x": x}
        out = {}

        def loss(t):
            y = pipeline.pipeline_apply(t["stacked"], t["x"], mlp_stage,
                                        mesh, sc["n_micro"])
            out["out"] = y.detach()
            return torch.sum(y ** 2)
        value, grads = value_and_grads(loss, tree)
    return {"out": out["out"].numpy(), "loss": value.numpy(),
            "grads": bridge.params_to_numpy(grads)}


def _gpt(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    mesh = make_mesh(sc["mesh"])
    params = _load(sc["tree"])
    batch = {k: v.long() for k, v in _load(sc["batch"]).items()}
    rest, stacked = split_gpt(params, mesh.axis_size("pp"))
    with planted(sc.get("fault", "")):
        value, grads = value_and_grads(
            lambda t: gpt_pipeline_loss(t, batch, mesh, sc["n_micro"],
                                        dtype=torch.float32, ce_chunk=0),
            {"rest": rest, "stages": stacked})
    return {"loss": value.numpy(), "grads": bridge.params_to_numpy(grads)}


def _shard(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    mesh = make_mesh(sc["mesh"])
    return {"blocks": bridge.params_to_numpy(pipeline.shard_stacked_params(
        _load(sc["stacked"]), mesh)), "coords": np.asarray(
            json.dumps(mesh.coords()))}


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

#: the card's run: GPT-2 small at full width and depth, four stages of
#: three blocks, a batch of 8 x 1024 as 4 microbatches of 2, 3 adamw
#: steps
CARD_STAGES, CARD_BATCH, CARD_MICRO, CARD_STEPS = 4, 8, 4, 3
CARD_SEQ = 1024
CARD_LR = 3e-4


def card_batch(seed: int, step: int, dev) -> Dict:
    """Step ``step``'s batch of the card's run, drawn on ``dev``."""
    return gpt.synthetic_batch(step_generator(seed, step, dev), CARD_BATCH,
                               CARD_SEQ, gpt.BASE_CONFIG["vocab_size"])


def card_tree(seed: int, dev) -> Dict:
    """GPT-2 small's parameters from ``seed`` as ``{"rest", "stages"}``,
    the stages whole."""
    params = gpt.init(torch.Generator(device=dev).manual_seed(seed),
                      dict(gpt.BASE_CONFIG, max_seq=CARD_SEQ))
    rest, stacked = split_gpt(params, CARD_STAGES)
    return {"rest": rest, "stages": stacked}


def launches_per_step(n_stages: int = CARD_STAGES,
                      n_micro: int = CARD_MICRO,
                      blocks: int = 12 // CARD_STAGES) -> Dict[str, int]:
    """B2's launches of a rank a step on the pipelined path, from the
    code: every stage runs its blocks on each of the M + S - 1 ticks
    (the bubble's junk ticks too), each block's attention one flash
    forward; the backward runs through every tick (a junk tick's
    cotangent is zero, and still flows), one dq and one dkv a block a
    tick; no remat."""
    n = (n_micro + n_stages - 1) * blocks
    return {"flash_fwd": n, "flash_dq": n, "flash_dkv": n}


def one_process(out_dir: str, seed: int = 0, steps: int = CARD_STEPS,
                nudge: bool = False) -> Dict[str, Any]:
    """One process's reference of the card's run: the 12 blocks in
    sequence on the same parameters and whole batches (the reference's
    ``test_pipeline_matches_sequential`` at full width): step 0's
    gradients (saved under ``out_dir``) and the losses of ``steps``
    adamw steps. ``nudge``: every parameter one ulp up (what rounding
    alone makes of the run)."""
    dev = resolve_device(None, "pp_check.one_process")
    with moe_check.card_setting(True):
        tree = card_tree(seed, dev)
        if nudge:
            with torch.no_grad():
                for t in bridge.leaves(tree):
                    t.copy_(torch.nextafter(t, torch.full_like(t, np.inf)))
        batch0 = card_batch(seed, 0, dev)
        _, grads = value_and_grads(
            lambda t: gpt_pipeline_loss(t, batch0, None, CARD_MICRO), tree)
        path = os.path.join(out_dir, "pp%s.s%d.grads.pt"
                            % ("_nudged" if nudge else "", seed))
        torch.save(bridge.flatten(grads), path)
        del grads
        losses = _train(tree, None, seed, steps)["losses"]
        del tree
        torch.cuda.empty_cache()
    return {"grads": path, "losses": losses}


def _train(tree: Dict, mesh: Optional[Mesh], seed: int, steps: int
           ) -> Dict[str, Any]:
    """``steps`` adamw steps of the pipelined loss (in sequence without a
    mesh) on ``tree``, in place: per-step losses, fingerprints of the
    replicated leaves before each step and after the last, each step's
    start event."""
    dev = bridge.leaves(tree)[0].device
    opt = optim.adamw(CARD_LR, weight_decay=0.1)
    state = opt.init(tree)
    losses, prints, starts = [], [], []
    for step in range(steps):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        starts.append(ev)
        prints.append(dp_check.fingerprint(bridge.leaves(tree["rest"])))
        batch = card_batch(seed, step, dev)
        loss, grads = value_and_grads(
            lambda t: gpt_pipeline_loss(t, batch, mesh, CARD_MICRO), tree)
        opt.update(grads, state, tree)
        losses.append(loss)
    prints.append(dp_check.fingerprint(bridge.leaves(tree["rest"])))
    return {"losses": torch.stack(losses).cpu().tolist(), "starts": starts,
            "prints": [p.tolist() for p in prints]}


def leaf_readings(got: Dict[str, torch.Tensor],
                  ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``{leaf: ||g - g_ref|| / ||g_ref||}``."""
    return {k: (torch.linalg.vector_norm(g.float() - ref[k].float())
                / torch.linalg.vector_norm(ref[k].float())).item()
            for k, g in got.items()}


def card_run(mesh: Mesh, seed: int, steps: int, grads_ref: str
             ) -> Dict[str, Any]:
    """The card's run on ``mesh``: step 0's gradients against one
    process's (``grads_ref``: the rest whole, this rank's stage against
    its block), then ``steps`` steps with their losses, fingerprints,
    step ms, flash launches, the pipeline's traffic and peak GB."""
    dev = resolve_device(None, "pp_check.card_run")
    tree = card_tree(seed, dev)
    tree["stages"] = bridge.tree_map(
        lambda a: a.clone(),
        pipeline.shard_stacked_params(tree["stages"], mesh))
    got: Dict[str, Any] = {}
    if grads_ref:
        batch0 = card_batch(seed, 0, dev)
        _, grads = value_and_grads(
            lambda t: gpt_pipeline_loss(t, batch0, mesh, CARD_MICRO), tree)
        ref = torch.load(grads_ref, map_location=dev)
        # this rank's stage is its pp coordinate's block
        stage = mesh.axis_rank("pp")
        for k in ref:
            if k.startswith("stages/"):
                ref[k] = ref[k].narrow(0, stage, 1)
        rel = leaf_readings(bridge.flatten(grads), ref)
        worst = max(rel, key=rel.get)
        got["grads"] = {"max_rel_diff": rel[worst], "leaf": worst}
        del grads, ref
        torch.cuda.empty_cache()
    dp_check.zero_counts()
    for k in collectives.pp_traffic:
        collectives.pp_traffic[k] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = _train(tree, mesh, seed, steps)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    marks = run["starts"] + [end]
    got.update({
        "losses": run["losses"], "fingerprints": run["prints"][1:],
        "rest_digest": dp_check.digest(bridge.leaves(tree["rest"])),
        "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
        "wall_s": time.perf_counter() - t0,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "pp_traffic": dict(collectives.pp_traffic),
        "launches": {"flash_" + k: v for k, v in
                     attention.flash_attention.launches.items()}})
    return got


def _card(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    mesh = make_mesh(sc["mesh"])
    with moe_check.card_setting(True), planted(sc.get("fault", "")):
        got = card_run(mesh, sc.get("seed", 0), sc["steps"],
                       sc.get("grads_ref", ""))
    return dict(got, fault=sc.get("fault", ""), coords=mesh.coords())


SCENARIOS = {"mlp": _mlp, "gpt": _gpt, "shard": _shard, "card": _card}
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
# the loss class of the card's run
# ---------------------------------------------------------------------------

def class_readings(seeds, backend: str, tmp: str) -> Dict[str, Any]:
    """Per seed: the card's run as one process, as the same one process
    with every parameter one ulp up, and pipelined on ``{"pp": 4}`` (its
    workers over ``backend``): each per-step relative difference from
    the one process, and step 0's gradients one ulp up and pipelined
    against one process's, leaf by leaf (the pipelined ranks' stage
    against its block)."""
    one, readings = {}, {}
    for s in seeds:
        one[s] = one_process(tmp, s)
        up = one_process(tmp, s, nudge=True)
        ref = torch.load(one[s]["grads"])
        readings[s] = {
            "one_ulp_up_vs_one": moe_check.rel_diffs(up["losses"],
                                                     one[s]["losses"]),
            "one_ulp_up_step0_leaves": leaf_readings(
                torch.load(up["grads"]), ref)}
        del ref
    lines = launch({"out": tmp, "scenarios": [
        {"kind": "card", "name": "s%d" % s, "mesh": {"pp": CARD_STAGES},
         "steps": CARD_STEPS, "seed": s, "grads_ref": one[s]["grads"]}
        for s in seeds]}, world=CARD_STAGES, backend=backend, timeout=3000)
    for s in seeds:
        ranks = [ln for r in lines for ln in r if ln["scenario"] == "s%d" % s]
        readings[s].update({
            "one_process": one[s]["losses"],
            "world": ranks[0]["losses"],
            "world_vs_one": moe_check.rel_diffs(ranks[0]["losses"],
                                                one[s]["losses"]),
            "world_step0_max_leaf": max(ln["grads"]["max_rel_diff"]
                                        for ln in ranks)})
    return readings


def main(argv=None) -> int:
    import argparse
    import subprocess
    import tempfile

    parser = argparse.ArgumentParser(
        description="the loss class of the train_pp run on a card")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = parser.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="pp_class_") as tmp:
        got = class_readings(args.seeds, args.backend, tmp)
    print(json.dumps({"card": smi, "backend": args.backend,
                      "readings": got}), flush=True)
    for s, r in got.items():
        print("train_pp seed %d (%s, %s): losses: pipelined %.3g from one "
              "process, one ulp up %.3g; step-0 gradients: one ulp up %.3g "
              "at the farthest leaf, pipelined %.3g" % (
                  s, args.backend, smi, max(r["world_vs_one"]),
                  max(r["one_ulp_up_vs_one"]),
                  max(r["one_ulp_up_step0_leaves"].values()),
                  r["world_step0_max_leaf"]), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1].endswith(".json"):
        sys.exit(worker_main(sys.argv[1]))
    sys.exit(main())
