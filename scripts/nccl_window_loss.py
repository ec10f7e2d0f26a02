"""How often chip_smoke's train_dp NCCL profile window loses a kernel
record as the process that takes it ages.

Opens ``--windows`` of ``chip_smoke._nccl_profile``'s windows (the dp
ResNet-50 step at world 1 over NCCL, 5 steps, the NCCL kernels counted
between B1 launches) one after another in this one process, after
``chip_smoke``'s 30-step world-1 run, and, with ``--after-train``, after
its phase train as well. With ``--pad-every 2`` every second window
spins the card ``--pad-cycles`` GPU clock cycles (``torch.cuda._sleep``,
~10 ms) before its first step and after its last, to test a loss at the
window's edges. Prints one ``WINDOW`` JSON line a window and a
``SUMMARY`` line. Run from the repository root on a machine with one
NVIDIA GPU:

    python3 scripts/nccl_window_loss.py [--after-train] [--windows 25]
        [--pad-every 2]
"""
import argparse
import json
import os
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as c  # noqa: E402
from paddle_operator_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


def padded_profile(mesh, cycles: int, warm: int = 2, steps: int = 5) -> dict:
    """``chip_smoke._nccl_profile`` with ``cycles`` of spin on the card
    before the window's first step and after its last, the spin kernels
    left out of its counts and busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=c.DEVICE).manual_seed(0)
    batch = c.resnet.synthetic_batch(gen, c.BATCH, c.IMAGE, c.CLASSES)
    params = c.resnet.init(gen, c.DEPTH, c.CLASSES)
    expected = c._dp_collectives_per_step(params)
    step_fn, state = c.build_train_step(
        c.resnet.loss_fn, c.resnet_optimizer("fused_sgd", 30), params, batch,
        mesh=mesh, merge_stats=c.resnet.merge_stats)
    del params
    for _ in range(warm):
        step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(cycles)
        for _ in range(steps):
            step_fn(state, batch)
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("nccl:")
                   and "spin_kernel" not in e.name)
    busy, end, nccl_n = 0.0, float("-inf"), 0
    between_b1 = [0]
    for lo, hi, name in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        if any(mark in name for mark in c.NCCL_KERNEL_MARKS):
            nccl_n += 1
            between_b1[-1] += 1
        elif "fused_sgd" in name:
            between_b1.append(0)
    return {"expected_collectives_per_step": expected,
            "nccl_kernels_per_step": nccl_n / steps,
            "nccl_kernels_between_b1": between_b1,
            "host_nccl_records": sum(
                1 for e in prof.events()
                if e.device_type == DeviceType.CPU
                and e.name.startswith("nccl:")),
            "device_busy_ms_per_step": busy / 1e3 / steps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--after-train", action="store_true")
    ap.add_argument("--windows", type=int, default=25)
    ap.add_argument("--pad-every", type=int, default=0)
    ap.add_argument("--pad-cycles", type=int, default=20_000_000)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = c.phase_env()
    c.phase_build()
    if args.after_train:
        c.phase_train(env["nvidia_smi"])
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group(
        "nccl", init_method="tcp://localhost:%d" % c.dp_check.free_port(),
        world_size=1, rank=0)
    try:
        c._train_run(c.resnet_optimizer("fused_sgd", 30), 30, "",
                     mesh_axes={"dp": 1})
        lost = {"bare": 0, "padded": 0}
        for i in range(args.windows):
            kind = ("padded" if args.pad_every
                    and i % args.pad_every == args.pad_every - 1 else "bare")
            mesh = make_mesh({"dp": 1})
            p = (padded_profile(mesh, args.pad_cycles) if kind == "padded"
                 else c._nccl_profile(mesh))
            lost[kind] += p["nccl_kernels_per_step"] != p[
                "expected_collectives_per_step"]["total"]
            print("WINDOW", i, kind, json.dumps({k: p[k] for k in (
                "nccl_kernels_per_step", "nccl_kernels_between_b1",
                "host_nccl_records", "device_busy_ms_per_step")}),
                flush=True)
        print("SUMMARY", json.dumps({"windows": args.windows,
                                     "lost": lost}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
