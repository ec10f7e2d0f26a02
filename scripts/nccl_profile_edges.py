"""Where chip_smoke's train_dp NCCL profile could lose a kernel.

Profiles 5-step windows of the dp ResNet-50 step at world 1 over NCCL
(``chip_smoke._nccl_profile``'s set-up), with and without a 0.2 s host
pause before the profiler stops, under 0, 16 and 48 spinning processes
of CPU load, and prints one ``EDGE`` JSON line a window: the NCCL
kernels, their split at B1 launches, the host's ``nccl:*`` records, the
last device kernel, the slack from its end to a CPU mark taken after
the device sync (negative: the trace's device clock runs past the
host's), and the profiled ms a step. Run from the repository root on a
machine with one NVIDIA GPU:

    python3 scripts/nccl_profile_edges.py
"""
import json, multiprocessing as mp, os, sys, time
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.getcwd())
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function
import chip_smoke as c
from paddle_operator_tpu_torch.migrate_check import resnet_optimizer
from paddle_operator_tpu_torch.ops import _kernels
from paddle_operator_tpu_torch.parallel.mesh import make_mesh
from paddle_operator_tpu_torch.parallel import build_train_step
from paddle_operator_tpu_torch.models import resnet


def spin():
    while True:
        pass


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    _kernels.load("fused_sgd")
    dist.init_process_group(
        "nccl", init_method="tcp://localhost:%d" % c.dp_check.free_port(),
        world_size=1, rank=0)
    mesh = make_mesh({"dp": 1})
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = resnet.synthetic_batch(gen, c.BATCH, c.IMAGE, c.CLASSES)
    params = resnet.init(gen, c.DEPTH, c.CLASSES)
    step_fn, state = build_train_step(
        resnet.loss_fn, resnet_optimizer("fused_sgd", 30), params, batch,
        mesh=mesh, merge_stats=resnet.merge_stats)
    for _ in range(2):
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()

    def window(pad):
        nonlocal state
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
            with record_function("window_end_mark"):
                pass
            if pad:
                time.sleep(pad)
        wall = time.perf_counter() - t0
        ev = list(prof.events())
        dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in ev
                     if e.device_type == DeviceType.CUDA
                     and not e.name.startswith("nccl:"))
        nccl = [d for d in dev if any(m in d[2] for m in c.NCCL_KERNEL_MARKS)]
        b1 = [d for d in dev if "fused_sgd" in d[2]]
        cuts = [d[0] for d in b1] + [float("inf")]
        seg, lo = [], float("-inf")
        for hi in cuts:
            seg.append(sum(1 for d in nccl if lo <= d[0] < hi))
            lo = hi
        mark = [e.time_range.start for e in ev if e.name == "window_end_mark"]
        cpu_nccl = sum(1 for e in ev if e.device_type == DeviceType.CPU
                       and e.name.startswith("nccl:"))
        last = max(dev, key=lambda d: d[1]) if dev else None
        return {"pad": pad, "nccl": len(nccl), "segments": seg, "b1": len(b1),
                "all_dev": len(dev), "cpu_nccl_records": cpu_nccl,
                "last_kernel": last[2][:60] if last else None,
                "last_nccl_end_vs_last_end_us":
                    (nccl[-1][1] - last[1]) if nccl and last else None,
                "tail_slack_us":
                    (mark[0] - last[1]) if mark and last else None,
                "wall_ms_per_step": wall * 1e3 / 5}

    out = []
    for load in (0, 16, 48):
        procs = [mp.Process(target=spin, daemon=True) for _ in range(load)]
        for p in procs:
            p.start()
        try:
            for pad in (0.0, 0.2, 0.0, 0.2, 0.0, 0.2):
                r = window(pad)
                r["load"] = load
                out.append(r)
                print("EDGE", json.dumps(r), flush=True)
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
