"""What starting a FLOP counter costs a process: the seconds of the first
operator under ``torch.utils.flop_counter.FlopCounterMode`` and under the
port's :class:`.hardware.StepFlopCounter`, and of importing
``torch._dynamo`` (which the first makes a process do), each in a fresh
interpreter. Prints one JSON line.

    python -m paddle_operator_tpu_torch.obs.startup_probe [--device cpu]

It probes on the card unless ``--device cpu`` asks for the CPU, and
refuses to run (exit 2) when the device asked for has no CUDA behind it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict

import torch

#: each probe times its own work inside a fresh interpreter and prints it
PROBES: Dict[str, str] = {
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
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        ap.error("--device %s: no CUDA device here (pass --device cpu to "
                 "probe the CPU)" % args.device)
    out = {"device": args.device}
    for name, code in PROBES.items():
        res = subprocess.run([sys.executable, "-c", code % vars(args)],
                             capture_output=True, text=True, check=True,
                             timeout=600)
        out[name + "_s"] = float(res.stdout.strip().splitlines()[-1])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
