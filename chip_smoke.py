"""On-card smoke run of the PyTorch/CUDA port (paddle_operator_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

It builds every hand-written kernel from ``paddle_operator_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes of the main
path, then serves GPT-2 small (``BASE_CONFIG``, random weights from a
seed) through ``ContinuousBatcher`` + ``ServingEngine`` on the paged
kernel and again on the plain reference path, and checks that both give
the same tokens. Each phase prints one JSON line; the last two lines are
the per-kernel summary and ``{"ok": true, "device": {...}}``. Any failed
phase exits non-zero without that last line. Without CUDA it exits 2.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from paddle_operator_tpu_torch.models import gpt
from paddle_operator_tpu_torch.ops import _kernels, attention
from paddle_operator_tpu_torch.serving import (
    ContinuousBatcher, Request, RequestQueue, ServingEngine)
from paddle_operator_tpu_torch.testing import paged_decode_case

#: HBM bytes/s by card (NVIDIA data sheets; "H100 80GB HBM3" is the SXM part)
HBM_BYTES_PER_S = {"H100 80GB HBM3": 3.35e12, "H100 SXM": 3.35e12,
                   "H200": 4.8e12}
#: fp32 FLOP/s outside the tensor cores (H100 SXM data sheet)
FP32_FLOPS = 67e12
KERNEL_TOL = 1e-5          # the JAX package's kernel-vs-reference bound
PAGED_REPLACES = "paddle_operator_tpu/ops/attention_pallas.py:525"
PAGED_SOURCE = "paddle_operator_tpu_torch/csrc/paged_decode.cu"
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit("chip_smoke: FAILED: " + msg)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    fail("no HBM rate known for card %r" % name)


def device_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn()`` in ms: each rep starts with the
    50 MB L2 flushed (the decode step finds its pages cold) and a sleep
    that lets the host enqueue the call before the device reaches it, so
    host overhead is not counted."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    times = []
    for _ in range(reps + 3):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[3:])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    env = {"phase": "env", "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    emit(env)
    return env


def phase_build() -> dict:
    names = sorted(p.stem for p in _kernels.CSRC_DIR.glob("*.cu"))
    cold = not any(_kernels.library_path(n).exists() for n in names)
    t0 = time.perf_counter()
    _kernels.build(names)
    out = {"phase": "build", "kernels": names, "cold": cold,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def _paged_measure(name: str, rate: float) -> dict:
    case = paged_decode_case(name)
    q, kp, vp, tables, lens = (
        torch.from_numpy(case[k]).cuda()
        for k in ("q", "k_pages", "v_pages", "tables", "lens"))
    b, h, d = q.shape
    bs, t = kp.shape[1], tables.shape[1]
    scale = 1.0 / d ** 0.5
    plain = attention._reference_paged_decode
    got = attention.paged_decode_attention(q, kp, vp, tables, lens)
    want = plain(q, kp, vp, tables, lens, scale)
    torch.cuda.synchronize()
    if got.shape != q.shape or not torch.isfinite(got).all():
        fail("paged decode kernel gave a bad output at %s" % name)
    err = torch.max(torch.abs(got - want)).item()
    # library yardstick: SDPA over K/V gathered beforehand (not timed)
    idx = tables.long()
    kg = kp[idx].reshape(b, t * bs, h, d).transpose(1, 2).contiguous()
    vg = vp[idx].reshape(b, t * bs, h, d).transpose(1, 2).contiguous()
    mask = (torch.arange(t * bs, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qs = q[:, :, None, :]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask)

    lib_err = torch.max(torch.abs(library()[:, :, 0] - want)).item()
    ms = device_ms(lambda: attention.paged_decode_attention(
        q, kp, vp, tables, lens))
    plain_ms = device_ms(lambda: plain(q, kp, vp, tables, lens, scale))
    library_ms = device_ms(library)
    # least work: the K and V rows of the live tokens, q in, context out
    live = int(lens.clamp(max=t * bs).sum().item())
    nbytes = 4 * (2 * live * h * d + 2 * b * h * d) + 4 * (b * t + b)
    flops = 4 * live * h * d
    bytes_ms, flops_ms = 1e3 * nbytes / rate, 1e3 * flops / FP32_FLOPS
    return {"case": name, "shape": {"B": b, "H": h, "D": d, "bs": bs,
                                    "T": t, "P": kp.shape[0],
                                    "live_tokens": live},
            "max_abs_err": err, "library_max_abs_err": lib_err,
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "bytes": nbytes}


def phase_kernels(rate: float) -> dict:
    attention.paged_decode_attention.launches = 0
    shapes = [_paged_measure(n, rate) for n in ("ragged", "full_width")]
    out = {"phase": "kernels", "kernels": [{
        "name": "paged_decode_attention", "replaces": PAGED_REPLACES,
        "source": PAGED_SOURCE, "tolerance": KERNEL_TOL,
        "comparison_launches": attention.paged_decode_attention.launches,
        "shapes": shapes}]}
    emit(out)
    for s in shapes:
        if not s["max_abs_err"] <= KERNEL_TOL:
            fail("paged decode kernel off by %g > %g at %s"
                 % (s["max_abs_err"], KERNEL_TOL, s["case"]))
    return out


def _traffic(seed: int = 0) -> list:
    """16 requests: prompts of 1-64 tokens, budgets of 16-192 tokens, and
    one request of a 64-token prompt plus 960 new tokens, which reaches
    max_seq 1024 and fills all 64 pages of its block table."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(16):
        n = int(rng.integers(1, 65))
        budget = int(rng.integers(16, 193))
        if i == 5:
            n, budget = 64, 960
        reqs.append((rng.integers(0, 50304, size=n).tolist(), budget))
    return reqs


def _serving(params, cfg, attn: str, traffic):
    """A fresh engine and batcher with ``traffic`` queued (submitted at
    the call, so TTFT counts queueing behind the batch)."""
    eng = ServingEngine(params, cfg, max_batch=8, prompt_pad=64,
                        block_size=16, num_blocks=512, attn=attn,
                        device=DEVICE)
    queue = RequestQueue(capacity=len(traffic))
    batcher = ContinuousBatcher(queue, max_batch=8, on_admit=eng.admit,
                                on_retire=eng.retire)
    reqs = [Request("r%02d" % i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(traffic)]
    for r in reqs:
        queue.submit(r)
    return eng, queue, batcher, reqs


def _serve_pass(params, cfg, attn: str, traffic) -> dict:
    eng, queue, batcher, reqs = _serving(params, cfg, attn, traffic)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(10000):
        if batcher.step(eng.step_fn) == 0 and queue.depth() == 0:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    alloc = eng.cache.allocator
    tokens = sum(len(r.generated) for r in reqs)
    out = {
        "attn": attn, "completed": batcher.counts()["completed"],
        "streams": [r.generated for r in reqs],
        "complete": all(len(r.generated) == n
                        for r, (_, n) in zip(reqs, traffic)),
        "allocator_check": alloc.check(),
        "blocks_used": alloc.stats()["blocks_used"],
        "blocks_peak": alloc.stats()["blocks_peak"],
        "decode_steps": eng.decode_steps,
        "iterations": batcher.counts()["iterations"], "tokens": tokens,
        "wall_s": wall,
        "ms_per_iteration": 1e3 * wall / batcher.counts()["iterations"],
        "decode_tokens_per_s": (tokens - len(reqs)) / wall,
        "ttft_median_s": statistics.median(r.ttft() for r in reqs),
        "tpot_median_s": statistics.median(r.tpot() for r in reqs),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    del eng
    return out


def phase_profile(params, cfg, traffic, warm: int = 10,
                  steps: int = 40) -> dict:
    """Where a decode step's time goes: ``steps`` batcher iterations of a
    full batch under torch.profiler, after ``warm`` iterations. Device
    busy time is the union of the CUDA kernels' intervals; the profiler's
    own host overhead inflates the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng, _, batcher, _ = _serving(params, cfg, "paged", traffic)
    for _ in range(warm):
        batcher.step(eng.step_fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            batcher.step(eng.step_fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        fail("profile: torch.profiler recorded no CUDA kernel")
    busy, end, by_name = 0.0, float("-inf"), {}
    for lo, hi, name in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        by_name[name] = by_name.get(name, 0.0) + (hi - lo)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"phase": "profile", "iterations": steps,
           "kernels_per_iteration": len(spans) / steps,
           "device_busy_ms_per_iteration": busy / 1e3 / steps,
           "profiled_wall_ms_per_iteration": 1e3 * wall / steps,
           "top_kernels_ms_per_iteration": [
               [name[:80], us / 1e3 / steps] for name, us in top]}
    emit(out)
    del eng
    return out


@torch.inference_mode()
def _full_forward_agreement(params, traffic, streams) -> tuple:
    """How many generated tokens are the argmax of one causal full forward
    (``gpt.apply``) over prompt + stream at the position before them: all
    of them, for a greedy stream computed without numerical drift."""
    agree = total = 0
    for (prompt, _), stream in zip(traffic, streams):
        ids = torch.tensor([list(prompt) + stream], device=DEVICE)
        logits = gpt.apply(params, ids)
        n = len(prompt)
        pred = logits[0, n - 1:n - 1 + len(stream)].argmax(-1).tolist()
        agree += sum(int(a == b) for a, b in zip(pred, stream))
        total += len(stream)
    return agree, total


def phase_serve(smi: str) -> dict:
    cfg = dict(gpt.BASE_CONFIG)
    params = gpt.init(torch.Generator(device=DEVICE).manual_seed(0), cfg)
    traffic = _traffic()
    attention.paged_decode_attention.launches = 0
    paged = _serve_pass(params, cfg, "paged", traffic)
    launches = attention.paged_decode_attention.launches
    ref = _serve_pass(params, cfg, "reference", traffic)
    ref_launches = attention.paged_decode_attention.launches - launches
    identical = paged["streams"] == ref["streams"]
    longest = max(len(p) + n for p, n in traffic)
    agree, total = _full_forward_agreement(params, traffic, paged["streams"])
    summary = {k: v for k, v in paged.items() if k != "streams"}
    out = {"phase": "serve", "config": "gpt BASE_CONFIG", "card": smi,
           "requests": len(traffic), "longest_tokens": longest,
           "paged": summary, "kernel_launches": launches,
           "expected_launches": paged["decode_steps"] * cfg["layers"],
           "reference": {k: ref[k] for k in ("wall_s", "decode_tokens_per_s",
                                             "decode_steps")},
           "reference_kernel_launches": ref_launches,
           "streams_identical": identical,
           "full_forward_agreement": [agree, total],
           "stream_lengths": [len(s) for s in paged["streams"]]}
    emit(out)
    problems = []
    for run in (paged, ref):
        if run["completed"] != len(traffic) or not run["complete"]:
            problems.append("%s: not every request completed" % run["attn"])
        if run["allocator_check"] or run["blocks_used"]:
            problems.append("%s: allocator %s, %d blocks still used"
                            % (run["attn"], run["allocator_check"],
                               run["blocks_used"]))
    if launches != out["expected_launches"] or launches == 0:
        problems.append("kernel launched %d times, expected %d"
                        % (launches, out["expected_launches"]))
    if ref_launches:
        problems.append("the reference pass launched the kernel")
    if not identical:
        diff = [i for i, (a, b) in enumerate(zip(paged["streams"],
                                                 ref["streams"])) if a != b]
        problems.append("paged and reference streams differ at requests %s"
                        % diff)
    if longest != cfg["max_seq"]:
        problems.append("no request reached max_seq")
    if agree != total:
        problems.append("%d of %d tokens differ from the full forward"
                        % (total - agree, total))
    if problems:
        fail("serve: " + "; ".join(problems))
    phase_profile(params, cfg, traffic)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("chip_smoke: TF32 off for matmul and cuDNN (fp32 throughout)",
          flush=True)
    env = phase_env()
    phase_build()
    kernels = phase_kernels(hbm_rate(env["device"]))
    serve = phase_serve(env["nvidia_smi"])
    full = kernels["kernels"][0]["shapes"][-1]
    emit({"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": PAGED_SOURCE, "replaces": PAGED_REPLACES,
        "launches": serve["kernel_launches"],
        "max_abs_err": max(s["max_abs_err"]
                           for s in kernels["kernels"][0]["shapes"]),
        "ms": full["kernel_ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": full["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
