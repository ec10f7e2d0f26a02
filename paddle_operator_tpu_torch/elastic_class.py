"""How far an elastic ResNet-50 world parts from one process, on the card.

    python -m paddle_operator_tpu_torch.elastic_class \\
        [--seeds 0,1,2,3,4,5] [--fp32-seeds 0,1] [--backends gloo,nccl] \\
        [--out FILE]

For every seed it runs the shrink of ``chip_smoke.py``'s train_elastic
phase: four workers started through the in-pod entry with the elastic
env, np 4 -> 2 once step 4 is saved, 8 steps, a checkpoint every 2, on
ResNet-50 at full width (``resnet50``: bf16 on fp32 parameters; for
``--fp32-seeds`` also ``resnet50_fp32``, fp32 throughout), in one world
of each backend (gloo: the four workers share card 0; nccl: a card
each, so it needs four), and the same job in one process. It prints, by
backend, model and seed, each step's relative loss difference
``|loss(world) - loss(one)| / loss(one)``, its largest value over the
steps at world 4 and over those at world 2, and the first loss after
the restore against the checkpoint's loss on that step's batch in one
process; then the largest of each over the seeds. Beside them, for
every model and seed, one process started from parameters one ulp up
(``nudge``) against the same one process, step by step: what the steps
make of a difference as small as one rounding, with no second process.
The JSON goes to ``--out`` as well. The bf16 readings give the class
the phase holds the elastic ResNet runs to; the fp32 and the nudged
ones show where the parting comes from.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

import torch

from paddle_operator_tpu_torch import dp_check, elastic_check
from paddle_operator_tpu_torch.elastic.server import MembershipServer

#: the train_elastic phase's shrink: steps, checkpoint period, the step
#: whose save moves the epoch (the world then stops after step 4)
STEPS, EVERY, SHRINK_AFTER = 8, 2, 4


def world_run(backend: str, runs: List[tuple], one: Dict[tuple, list],
              tmp: str, endpoint: str) -> List[dict]:
    """The shrink of every ``(model, seed)`` of ``runs`` in one world of
    four workers of ``backend``, each held against ``one``."""
    scenarios, triggers = [], []
    for model, seed in runs:
        name = "%s_%s_s%d" % (backend, model, seed)
        ckpt = os.path.join(tmp, name)
        scenarios.append({
            "kind": "elastic", "name": name, "job": "class-" + name,
            "model": model, "seed": seed, "steps": STEPS, "every": EVERY,
            "ckpt_dir": ckpt, "np": 4, "hold_at": SHRINK_AFTER})
        triggers.append(elastic_check.Trigger("class-" + name, ckpt,
                                              SHRINK_AFTER, np=2))
    torch.cuda.empty_cache()
    lines = elastic_check.launch(
        {"out": os.path.join(tmp, backend), "scenarios": scenarios}, 4,
        endpoint, triggers, backend=backend, timeout=1200)
    out = []
    for sc, (model, seed) in zip(scenarios, runs):
        rs = lines[sc["name"]]
        losses = elastic_check.step_losses(rs)
        ref = one[(model, seed)]
        rel = [abs(losses[i] - ref[i]) / abs(ref[i]) for i in range(STEPS)]
        resume = rs[0]["resume_steps"][0]
        ck = elastic_check.checkpointed(model, STEPS, sc["ckpt_dir"], resume,
                                        seed)
        out.append({
            "backend": backend, "model": model, "seed": seed,
            "resume_step": resume, "rel": rel,
            "world4_max": max(rel[:resume]), "world2_max": max(rel[resume:]),
            "first_after_restore": abs(losses[resume] - ck["loss"])
            / abs(ck["loss"]),
            "mesh_history": [r["mesh_history"] for r in rs]})
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3,4,5")
    ap.add_argument("--fp32-seeds", default="0,1")
    ap.add_argument("--backends", default="gloo,nccl")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("elastic_class: needs a CUDA card", file=sys.stderr)
        return 2
    backends = [b for b in args.backends.split(",") if b]
    if "nccl" in backends and torch.cuda.device_count() < 4:
        print("elastic_class: nccl needs four cards, this machine has %d"
              % torch.cuda.device_count(), file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = [("resnet50", int(s)) for s in args.seeds.split(",") if s] + [
        ("resnet50_fp32", int(s)) for s in args.fp32_seeds.split(",") if s]
    one = {(m, s): dp_check.card_run(m, STEPS, seed=s)["losses"]
           for m, s in runs}
    nudged = []
    for m, s in runs:
        got = dp_check.card_run(m, STEPS, seed=s, nudge=True)["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(got, one[(m, s)])]
        nudged.append({"model": m, "seed": s, "rel": rel, "max": max(rel)})
    readings = []
    with tempfile.TemporaryDirectory(prefix="elastic_class_") as tmp, \
            MembershipServer() as server:
        for backend in backends:
            readings += world_run(backend, runs, one, tmp, server.endpoint)
    largest = {}
    for r in readings:
        key = "%s/%s" % (r["backend"], r["model"])
        cur = largest.setdefault(key, {"world4_max": 0.0, "world2_max": 0.0,
                                       "first_after_restore": 0.0})
        for k in cur:
            cur[k] = max(cur[k], r[k])
    for r in nudged:
        key = "one_ulp/%s" % r["model"]
        largest[key] = {"max": max(largest.get(key, {}).get("max", 0.0),
                                   r["max"])}
    result = {"card": smi, "steps": STEPS, "shrink_after": SHRINK_AFTER,
              "one_process_losses": {"%s/s%d" % k: v for k, v in one.items()},
              "readings": readings, "one_ulp": nudged, "largest": largest}
    for r in readings:
        print("elastic_class (%s) %s %s seed %d: world 4 %.3e, world 2 "
              "%.3e, first after the restore %.3e; by step %s" % (
                  smi, r["backend"], r["model"], r["seed"], r["world4_max"],
                  r["world2_max"], r["first_after_restore"],
                  " ".join("%.2e" % x for x in r["rel"])), flush=True)
    for r in nudged:
        print("elastic_class (%s) one process, parameters one ulp up, %s "
              "seed %d: %.3e; by step %s" % (
                  smi, r["model"], r["seed"], r["max"],
                  " ".join("%.2e" % x for x in r["rel"])), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"card": smi, "largest": largest}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
