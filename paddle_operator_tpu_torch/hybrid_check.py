"""The model axes beside each other and beside sp, checked on the card:
tp or fsdp with sp or ep, and MoE layers under tp, as the workers of a
real multi-process world.

A worker is started as the operator starts one, through the in-pod entry
(:func:`launch` does it, with this file as the script)::

    TPUJOB_NUM_WORKERS=8 TPUJOB_WORKER_ID=<rank> \\
    TPUJOB_COORDINATOR=localhost:<port> TPUJOB_DIST_BACKEND=gloo \\
        python -m paddle_operator_tpu_torch.launch \\
            paddle_operator_tpu_torch/hybrid_check.py SPEC.json

and runs the ``card`` scenarios of the JSON spec in order, each printing
a JSON line: ``run_training`` of a :data:`CARD_RUNS` job
(``tp_check.card_run``): per-step losses and clip norms, step-0
gradients against one process's (each tile against its slice), digests
of the state by the axes its leaves are split over, the B2 and B4
launches and the tp, sp and MoE collectives. ``chip_smoke.py``'s
train_hybrid phase drives it. A scenario may plant a fault
(``tp_check.HYBRID_FAULTS``: (iv) under tp x sp, the LayerNorms'
gradients left unsummed over sp; (v) under tp x ep, the MoE leaves taken
for tiles over tp) that a gate must reject. The CPU checks of the same
meshes against the JAX package (``tests/test_torch_hybrid.py``) run
``tp_check``'s ``step`` scenarios.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from paddle_operator_tpu_torch import dp_check, moe_check, tp_check
from paddle_operator_tpu_torch.models import bert, gpt
from paddle_operator_tpu_torch.ops import optim
from paddle_operator_tpu_torch.parallel import context
from paddle_operator_tpu_torch.runner import TrainJob

#: run name -> (model, mesh_axes): (a) the reference's dry-run program 1
#: (BERT TINY, 2 ep experts a rank in every layer, on dp1 x tp2 x sp2 x
#: ep2); (b) GPT-2 small's width cut to 2 layers, 8 experts in every
#: layer, on tp2 x sp2 x ep2. One world of eight workers runs both
CARD_RUNS = {
    "program1_bert_tiny_moe": ("bert", {"dp": 1, "tp": 2, "sp": 2,
                                        "ep": 2}),
    "gpt_2layers_moe_tp2_sp2_ep2": ("gpt", {"tp": 2, "sp": 2, "ep": 2}),
}
CARD_WORKERS = 8
#: (b)'s global batch (each rank holds its sp block of every sequence)
GPT_BATCH, GPT_SEQ = 4, 1024


def program1_config(ep: int = 2) -> dict:
    """The dry run's BERT: ``TINY_CONFIG`` with ``2 ep`` experts in every
    layer (``__graft_entry__.py:81-83``)."""
    return dict(bert.TINY_CONFIG, moe_experts=2 * ep, moe_every=1)


def _program1_job(axes: dict) -> TrainJob:
    """Dry-run program 1 as a job: adamw(1e-3) under the wd mask, clip
    1.0, ``moe_rules() + bert_rules()``, ``seq_axis="sp"``, a batch of
    ``2 dp x 16 sp`` (bf16 compute, the reference loss's default); ring
    attention over sp on a mesh, BERT's masked attention without one."""
    cfg = program1_config(axes["ep"])
    # the mask reads the tree's keys only: a CPU tree of the config
    mask = optim.make_wd_mask(bert.init(torch.Generator().manual_seed(0),
                                        cfg))

    def loss_fn(p, b, mesh=None):
        attn = "auto"
        if mesh is not None and mesh.axis_size("sp") > 1:
            attn = functools.partial(context.ring_attention, mesh=mesh,
                                     axis="sp")
        return bert.loss_fn(p, b, attn_impl=attn)

    return TrainJob(
        init_params=lambda gen: bert.init(gen, cfg), loss_fn=loss_fn,
        optimizer=optim.adamw(1e-3, wd_mask=mask),
        make_batch=lambda gen, step: bert.synthetic_batch(
            gen, 2 * axes.get("dp", 1), 16 * axes["sp"],
            cfg["vocab_size"]),
        rules=tp_check.model_rules("bert"), grad_clip=1.0)


def _gpt_job() -> TrainJob:
    """``examples/train_gpt.make_job`` at GPT-2 small's width (12 heads,
    T 1024), 2 layers, ``TPUJOB_SP=2`` (causal ring attention over sp on
    a mesh, the flash kernels without one) and 8 experts in every layer
    (``moe_every=1``), ``gpt_rules() + moe_rules()``."""
    from paddle_operator_tpu_torch.examples import train_gpt

    job = train_gpt.make_job({
        "TPUJOB_SP": "2", "TPUJOB_LAYERS": "2", "TPUJOB_MOE_EXPERTS": "8",
        "TPUJOB_BATCH": str(GPT_BATCH), "TPUJOB_SEQ": str(GPT_SEQ),
        "TPUJOB_STEPS": "2"})
    cfg = dict(gpt.BASE_CONFIG, max_seq=GPT_SEQ, layers=2, moe_experts=8,
               moe_every=1)
    return dataclasses.replace(job, init_params=lambda gen: gpt.init(gen,
                                                                     cfg))


def card_job(run: str, steps: int, mesh: bool = True,
             seed: int = 0) -> TrainJob:
    """A :data:`CARD_RUNS` job for ``steps`` steps, on its mesh or (for
    ``mesh=False``) as one process; parameters and batches from
    ``seed``."""
    model, axes = CARD_RUNS[run]
    job = _program1_job(axes) if model == "bert" else _gpt_job()
    return dataclasses.replace(job, total_steps=steps, seed=seed,
                               log_every=steps, checkpoint_dir="",
                               mesh_axes=axes if mesh else None,
                               seq_axis="sp" if mesh else None)


def one_process(run: str, steps: int, out_dir: str, seed: int = 0,
                nudge: bool = False) -> Dict[str, Any]:
    """One process's reference of a :data:`CARD_RUNS` run: step 0's
    gradients (saved under ``out_dir``), their global norm, and the
    losses of ``steps`` steps. ``nudge``: every parameter one ulp up
    (what rounding alone makes of the run)."""
    from paddle_operator_tpu_torch.runner import run_training

    def job(n: int) -> TrainJob:
        out = card_job(run, n, mesh=False, seed=seed)
        if nudge:
            out.init_params = dp_check._nudged(out.init_params)
        return out

    with moe_check.card_setting(True):
        path = os.path.join(out_dir, "%s%s.s%d.grads.pt"
                            % (run, "_nudged" if nudge else "", seed))
        grads, _ = moe_check.step0(job(1))
        norm = optim.global_norm(grads).item()
        torch.save(grads, path)
        del grads
        rec = moe_check.Losses(job(steps).loss_fn)
        run_training(dataclasses.replace(job(steps), loss_fn=rec))
        torch.cuda.empty_cache()
    return {"grads": path, "grad_norm": norm,
            "losses": torch.stack(rec.losses).cpu().tolist()}


def _card(sc: dict, rank: int, size: int) -> Dict[str, Any]:
    with moe_check.card_setting(True), tp_check.planted(sc.get("fault",
                                                              "")):
        job = card_job(sc["run"], sc["steps"], seed=sc.get("seed", 0))
        skip = tp_check.ZERO_GRAD_LEAVES.get(CARD_RUNS[sc["run"]][0], ())
        got = tp_check.card_run(job, sc.get("grads_ref", ""), skip)
    return dict(got, run=sc["run"], fault=sc.get("fault", ""))


def worker_main(spec_path: str) -> int:
    """Run a spec's ``card`` scenarios on this rank of the world
    ``launch`` made."""
    with open(spec_path) as f:
        spec = json.load(f)
    rank, size = dist.get_rank(), dist.get_world_size()
    for sc in spec["scenarios"]:
        out = _card(sc, rank, size)
        print(json.dumps({"scenario": sc["name"], "rank": rank, **out}),
              flush=True)
    return 0


def launch(spec: dict, world: int = 8, backend: str = "gloo",
           timeout: float = 600.0, env: Optional[Dict[str, str]] = None):
    """:func:`.dp_check.launch_workers` with this file as the script."""
    return dp_check.launch_workers(spec, world=world, backend=backend,
                                   timeout=timeout, env=env,
                                   script=os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# the loss class of the card's runs
# ---------------------------------------------------------------------------

def class_readings(seeds, backend: str, tmp: str,
                   steps: int = 2) -> Dict[str, Any]:
    """Per run and seed: the :data:`CARD_RUNS` job for ``steps`` steps as
    one process, as the same one process with every parameter one ulp
    up, and on its mesh (one world of :data:`CARD_WORKERS` over
    ``backend``): each per-step relative difference from one process,
    the step-0 clip norm's, and step 0's gradients one ulp up and on the
    mesh against one process's, leaf by leaf (each tile against its
    slice)."""
    refs, readings = {}, {}
    for run in CARD_RUNS:
        skip = tp_check.ZERO_GRAD_LEAVES.get(CARD_RUNS[run][0], ())
        for s in seeds:
            one = refs[run, s] = one_process(run, steps, tmp, s)
            up = one_process(run, steps, tmp, s, nudge=True)
            leaves = tp_check.leaf_readings(torch.load(up["grads"]),
                                            torch.load(one["grads"]))
            readings["%s/s%d" % (run, s)] = {
                "one_process": one["losses"],
                "one_ulp_up_vs_one": moe_check.rel_diffs(up["losses"],
                                                         one["losses"]),
                "one_ulp_up_norm": abs(up["grad_norm"] - one["grad_norm"])
                / one["grad_norm"],
                "one_ulp_up_step0_max_leaf": max(
                    v for k, v in leaves.items() if not k.endswith(skip))}
    lines = launch({"out": tmp, "scenarios": [
        {"kind": "card", "name": "%s/s%d" % (run, s), "run": run,
         "steps": steps, "seed": s, "grads_ref": refs[run, s]["grads"]}
        for run in CARD_RUNS for s in seeds]}, world=CARD_WORKERS,
        backend=backend, timeout=3000)
    for (run, s), one in refs.items():
        name = "%s/s%d" % (run, s)
        ranks = [ln for r in lines for ln in r if ln["scenario"] == name]
        # a rank's loss is its sequence block's part of its replica's
        world = (CARD_RUNS[run][1].get("sp", 1) * np.mean(
            [ln["losses"] for ln in ranks], axis=0)).tolist()
        readings[name].update({
            "world": world,
            "world_vs_one": moe_check.rel_diffs(world, one["losses"]),
            "world_norm": abs(ranks[0]["grad_norms"][0] - one["grad_norm"])
            / one["grad_norm"],
            "world_step0_max_leaf": max(ln["grads"]["max_rel_diff"]
                                        for ln in ranks)})
    return readings


def main(argv=None) -> int:
    import argparse
    import subprocess
    import tempfile

    parser = argparse.ArgumentParser(
        description="the loss class of the train_hybrid runs on a card")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = parser.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="hybrid_class_") as tmp:
        got = class_readings(args.seeds, args.backend, tmp)
    print(json.dumps({"card": smi, "backend": args.backend,
                      "readings": got}), flush=True)
    for name, r in got.items():
        print("train_hybrid %s (%s, %s): losses: the world %.3g from one "
              "process, one ulp up %.3g; step-0 clip norm: the world %.3g, "
              "one ulp up %.3g; step-0 gradients at the farthest leaf: the "
              "world %.3g, one ulp up %.3g" % (
                  name, args.backend, smi, max(r["world_vs_one"]),
                  max(r["one_ulp_up_vs_one"]), r["world_norm"],
                  r["one_ulp_up_norm"], r["world_step0_max_leaf"],
                  r["one_ulp_up_step0_max_leaf"]), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1].endswith(".json"):
        sys.exit(worker_main(sys.argv[1]))
    sys.exit(main())
