"""What starting a process costs: the seconds of importing ``torch``; of
the first operator under ``torch.utils.flop_counter.FlopCounterMode``
and under the port's :class:`.hardware.StepFlopCounter`; of importing
``torch._dynamo`` (which the first makes a process do); of turning
deterministic algorithms on through ``torch.use_deterministic_algorithms``
and through the port's :func:`..device.deterministic_algorithms`; each in
a fresh interpreter. Prints one JSON line.

    python -m paddle_operator_tpu_torch.obs.startup_probe [--device cpu]
        [--pycache DIR]

It probes on the card unless ``--device cpu`` asks for the CPU, and
refuses to run (exit 2) when the device asked for has no CUDA behind it.
``--pycache DIR`` runs every probe again with Python's bytecode kept
under ``DIR`` (``PYTHONPYCACHEPREFIX``, writing allowed): a first pass
fills it, a second reads it (``"pycache"`` in the line).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict

import torch

#: each probe times its own work inside a fresh interpreter and prints it
PROBES: Dict[str, str] = {
    "import_torch": (
        "import time\n"
        "t = time.perf_counter(); import torch\n"
        "print(time.perf_counter() - t)"),
    "use_deterministic_algorithms": (
        "import time, torch\n"
        "t = time.perf_counter(); torch.use_deterministic_algorithms(True)\n"
        "print(time.perf_counter() - t)"),
    "deterministic_algorithms": (
        "import time, torch\n"
        "from paddle_operator_tpu_torch.device import "
        "deterministic_algorithms\n"
        "t = time.perf_counter(); deterministic_algorithms(True)\n"
        "print(time.perf_counter() - t)"),
    "import_torch_dynamo": (
        "import time, torch\n"
        "t = time.perf_counter(); import torch._dynamo\n"
        "print(time.perf_counter() - t)"),
    "flop_counter_mode": (
        "import time, torch\n"
        "from torch.utils.flop_counter import FlopCounterMode\n"
        "x = torch.randn(64, 64, device=%(device)r)\n"
        "t = time.perf_counter()\n"
        "with FlopCounterMode(display=False): x @ x\n"
        "print(time.perf_counter() - t)"),
    "step_flop_counter": (
        "import time, torch\n"
        "from paddle_operator_tpu_torch.obs.hardware import StepFlopCounter\n"
        "x = torch.randn(64, 64, device=%(device)r)\n"
        "t = time.perf_counter()\n"
        "with StepFlopCounter(): x @ x\n"
        "print(time.perf_counter() - t)"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the probes' operators run (default: the "
                    "card; 'cpu' asks for the CPU)")
    ap.add_argument("--pycache", default="",
                    help="also probe with Python's bytecode kept under "
                    "this directory")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        ap.error("--device %s: no CUDA device here (pass --device cpu to "
                 "probe the CPU)" % args.device)

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def probe_all(env: dict) -> Dict[str, float]:
        env = dict(env, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p]))
        got = {}
        for name, code in PROBES.items():
            res = subprocess.run([sys.executable, "-c", code % vars(args)],
                                 capture_output=True, text=True, check=True,
                                 timeout=600, env=env)
            got[name + "_s"] = float(res.stdout.strip().splitlines()[-1])
        return got

    out = {"device": args.device,
           "dont_write_bytecode": bool(os.environ.get(
               "PYTHONDONTWRITEBYTECODE")), **probe_all(dict(os.environ))}
    if args.pycache:
        env = dict(os.environ, PYTHONPYCACHEPREFIX=os.path.abspath(
            args.pycache))
        env.pop("PYTHONDONTWRITEBYTECODE", None)
        probe_all(env)
        out["pycache"] = probe_all(env)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
