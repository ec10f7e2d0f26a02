"""On-card smoke run of the PyTorch/CUDA port (paddle_operator_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

It builds every hand-written kernel from ``paddle_operator_tpu_torch/csrc``
through the compile cache's ladder and holds each against its plain
PyTorch version at the shapes of its path. Then it drives the fifteen
ported paths:

* compile_cache: the cold start of a pod, in fresh spawned processes
  against the port's artifact server run here: three cold pods build
  each library once and fetch it twice under compile leases, a warm
  restart loads all four from its directory, a poisoned bundle is
  rejected by its digest and rebuilt, a sound bundle of the wrong
  library is rejected at its first use and rebuilt, and a killed
  leaseholder's lease is taken within its TTL; every kernel launched
  from a fetched or rebuilt library matches its plain version; gates in
  ``phase_compile_cache``;

* serve: GPT-2 small (``BASE_CONFIG``, random weights from a seed)
  through ``ContinuousBatcher`` + ``ServingEngine`` on the paged kernel
  and again on the plain reference path; both must give the same tokens;
* train: ResNet-50 at full width (224x224, batch 128, bf16 compute on
  fp32 master params) through ``TrainJob`` + ``run_training``, 30 steps
  with ``fused_sgd`` (the multi-tensor kernel), the same 30 with ``sgd``,
  and a resume of the first run from its step-10 checkpoint; the losses
  must agree as stated in ``phase_train``; the resume reads the first
  run's step cost from the compile cache. The first run also carries the
  runner's observability: its ``/metrics`` endpoint scraped while it
  trains, a ``torch.profiler`` window of steps 11-13, the hardware block
  (the H100's registry peak, FLOPs counted on the step) and the goodput
  ledger, each gated and each gate proven by a planted fault (the MFU
  gate's, a host clock, on a device-bound job of fp32 matrix products);
* train_gpt: GPT-2 small (batch 16 x 1024 tokens, bf16 on fp32 params,
  adamw, remat, chunked LM head) through the job of
  ``examples/train_gpt.py``: step 0's gradients on the kernels against
  the einsum attention, 20 steps on the flash-attention kernels, the same
  20 on the einsum attention, a resume from the step-10 checkpoint, and
  the 20 steps again under planted backward faults that the gates must
  see; gates in ``phase_train_gpt``;
* train_gpt_moe: the same job with ``TPUJOB_MOE_EXPERTS=8`` (every second
  FFN an 8-expert switch block) on the MoE dispatch/combine kernels, on
  their plain versions and on the dense einsum formulation, a resume and
  two planted faults; gates in ``phase_train_gpt_moe``;
* train_bert: BERT-base through ``examples/train_bert.py``'s job, and
  BERT-base-MoE at the JAX bench's setup on the kernels, on their plain
  versions and dense; gates in ``phase_train_bert``;
* train_dp: data parallelism, ResNet-50 over a process group of one on
  NCCL (every collective of the path launched on the card), then two
  worker processes sharing the card over gloo, started through
  ``python -m paddle_operator_tpu_torch.launch``, training ResNet-50 and
  GPT-2 small (2 layers) against one process, with a planted fault;
  gates in ``phase_train_dp``.
* train_sp: sequence parallelism, four worker processes sharing the card
  over gloo: ring (every hop on the flash kernels) and Ulysses attention
  alone against one process's flash attention, GPT-2 small with
  ``TPUJOB_SP=4`` over 4096-token sequences and a dp2 x sp2 run against
  one process, with three planted faults; gates in ``phase_train_sp``.
* train_ctr: the CTR models at full width (26 slots x 10,000 ids, batch
  512): wide&deep and DeepFM through their examples' jobs and
  run_training, and parameter-server mode, 2 pservers (the example, no
  card visible) and 2 trainer processes on the card, dense and sparse,
  each world held bitwise against its replay, with two planted faults;
  gates in ``phase_train_ctr``. It launches no kernel of the port.
* train_elastic: elastic restart cycles against a membership server run
  here: ResNet-50 at full width shrinking from four worker processes to
  two (B1 on every rank), GPT-2 small (2 layers) restarted at two
  workers bitwise equal to an uninterrupted run (B2), and two planted
  faults; gates in ``phase_train_elastic``.
* train_moe_ep: MoE across worker processes, four workers in one world:
  GPT-2 small with 8-expert FFNs (12 layers) on dp4 (the example's path,
  experts replicated) and on ``{"dp": 2, "ep": 2}`` with
  ``gpt_rules() + moe_rules()`` (4 experts a rank, B4 on a rank's local
  experts), TPUJOB_SP=2 at 2 layers (routing over sequence blocks), each
  against one process, and three planted faults; gates in
  ``phase_train_moe_ep``.
* train_migrate: the live-migration MOVE over the port's artifact server
  run here (HTTP only): phase train's ResNet-50 job drains at step 13 on
  the operator's notice (``TPUJOB_MIGRATE_FILE``) and publishes its cut
  as a state bundle; a fresh process (``migrate_check``, with
  ``TPUJOB_MIGRATE_STATE``) pre-stages it, restores step 13 and trains to
  30, bit for bit as phase train did, B1 on every step of both sides.
  Four planted faults must each make their gate fire: a torn notice
  (nothing published), an unpublished step and a poisoned bundle (the
  server quarantines it; both fall back to step 0), and a stale cut (the
  step-10 dir under step 13's key: the bitwise loss gate fails). It
  prints the bundle's bytes, the publish, pre-stage and restore seconds
  and the blackout by part; gates in ``phase_train_migrate``.
* train_tp: tensor parallelism, the reference's tp and fsdp rule tables
  honoured by the train step: GPT-2 small at full depth on ``{"tp": 2}``
  (two workers, B2 on each rank's 6 heads), at 2 layers on ``{"dp": 2,
  "tp": 2}``, BERT-base (2 layers) on ``{"tp": 4}`` and phase train's
  ResNet-50 job on ``{"dp": 2, "fsdp": 2}`` (four workers), each against
  one process, with five planted faults; gates in ``phase_train_tp``.
* train_pp: GPipe over a ``pp`` axis (``parallel.pipeline``): GPT-2
  small's 12 blocks as four stages of three on four workers, a batch of
  8 x 1024 as 4 microbatches, B2 on every tick of every stage, against
  one process running the blocks in sequence, with three planted
  faults; gates in ``phase_train_pp``.
* train_hybrid: tp beside sp and ep, MoE under tp, one world of eight
  workers: the reference's dry-run program 1 (BERT TINY MoE on dp1 x tp2
  x sp2 x ep2) and GPT-2 small's width at 2 layers with 8 experts on tp2
  x sp2 x ep2 (B2 on each rank's 6 heads over the ring, B4 on its local
  experts), each against one process, with two planted faults; gates in
  ``phase_train_hybrid``.

Each phase prints one JSON line; ``main`` prints each phase's seconds
with the host's CPU count and load, then the whole; the last two lines
are the per-kernel summary and ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that last line. Without CUDA it exits 2. On a machine
of four or more cards, phases train_sp, train_moe_ep, train_tp and
train_pp run over NCCL, one card a worker (train_hybrid on eight).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

# Python keeps the bytecode of what this script and the worker processes
# it starts import under the checkout's build/. Where the installed
# packages carry no bytecode and the environment forbids writing any
# (PYTHONDONTWRITEBYTECODE), every process would compile torch from
# source again: seconds each, for some sixty processes.
PYCACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "pycache")
os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
sys.pycache_prefix, sys.dont_write_bytecode = PYCACHE, False

import numpy as np
import torch

from paddle_operator_tpu_torch import artifacts, bridge, compile_cache, \
    dp_check, elastic_check, hybrid_check, migrate_check, moe_check, \
    pp_check, ps, ps_check, runner, testing, tp_check
from paddle_operator_tpu_torch.artifacts.server import ArtifactServer
from paddle_operator_tpu_torch.artifacts.state import pack_state_dir, \
    state_fingerprint
from paddle_operator_tpu_torch.artifacts.store import ArtifactStore
from paddle_operator_tpu_torch.data import process_shard, step_generator
from paddle_operator_tpu_torch.device import deterministic_algorithms
from paddle_operator_tpu_torch.migrate_check import resnet_optimizer
from paddle_operator_tpu_torch.moe_check import rel_diffs
from paddle_operator_tpu_torch.elastic.server import MembershipServer
from paddle_operator_tpu_torch.examples import train_bert, train_deepfm, \
    train_gpt, train_wide_deep
from paddle_operator_tpu_torch.models import bert, deepfm, gpt, resnet, \
    wide_deep
from paddle_operator_tpu_torch.obs import StepClock, \
    conservation_violations, lookup_chip, parse_exposition
from paddle_operator_tpu_torch.ops import _kernels, attention, moe, optim
from paddle_operator_tpu_torch.parallel import build_train_step, collectives
from paddle_operator_tpu_torch.parallel.mesh import make_mesh
from paddle_operator_tpu_torch.runner import TrainJob, bind_mesh, \
    run_training
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
SGD_REPLACES = "paddle_operator_tpu/ops/optim.py:283"
SGD_SOURCE = "paddle_operator_tpu_torch/csrc/fused_sgd.cu"
FLASH_SOURCE = "paddle_operator_tpu_torch/csrc/flash_attention.cu"
#: the three flash kernels: (kernels-line name, key of
#: attention.flash_attention.launches, the TPU kernel it replaces)
FLASH_KERNELS = (
    ("flash_fwd", "fwd", "paddle_operator_tpu/ops/attention_pallas.py:47"),
    ("flash_dq", "dq", "paddle_operator_tpu/ops/attention_pallas.py:100"),
    ("flash_dkv", "dkv", "paddle_operator_tpu/ops/attention_pallas.py:152"))
#: fp32 flash kernels against their plain versions, absolute: the JAX
#: package's kernel-vs-reference bound (tests/test_pallas_attention.py)
FLASH_TOL_F32 = 2e-5
#: bf16 outputs are held element by element to one bf16 ulp of the plain
#: value plus testing.BF16_ATOL: both sides sum in fp32 and round once
FLASH_TOL_BF16 = "1 bf16 ulp of plain + %g" % testing.BF16_ATOL
#: bf16 dense tensor-core FLOP/s (H100 SXM data sheet)
BF16_FLOPS = 989e12
DEVICE = "cuda"
#: the train phase's model and batch: ResNet-50 at full width
DEPTH, CLASSES, IMAGE, BATCH = 50, 1000, 224, 128
#: the train_gpt phase: GPT-2 small, examples/train_gpt.py's batch and
#: sequence, 20 steps (the example's default is 100)
GPT_BATCH, GPT_SEQ, GPT_STEPS = 16, 1024, 20
MOE_SOURCE = "paddle_operator_tpu_torch/csrc/moe.cu"
#: the two MoE kernels: (kernels-line name, key of
#: moe.moe_apply_fused.launches, the TPU kernel it replaces)
MOE_KERNELS = (
    ("moe_dispatch", "dispatch", "paddle_operator_tpu/ops/moe.py:156"),
    ("moe_combine", "combine", "paddle_operator_tpu/ops/moe.py:187"))
#: the train_gpt_moe phase: examples/train_gpt.py with TPUJOB_MOE_EXPERTS=8
#: (GPT-2 small, every second FFN a switch-MoE block), 10 steps, one
#: checkpoint at step 5
MOE_EXPERTS, MOE_STEPS, MOE_SAVE_AT = 8, 10, 5
#: the train_bert phase: examples/train_bert.py (BERT-base, batch 64 x
#: 512), and BERT-base-MoE at the JAX bench's setup (bench.py _moe_bench:
#: 8 experts on every second layer, batch 16 x 512)
BERT_BATCH, BERT_SEQ, BERT_STEPS, BERT_FIXED_STEPS = 64, 512, 5, 6
BERT_MOE_BATCH, BERT_MOE_STEPS = 16, 4
#: the train_ctr phase: the CTR examples' batch at DEFAULT_CONFIG; 20
#: collective steps and 10 PS rounds (the examples' default is 100)
CTR_BATCH, CTR_STEPS, CTR_ROUNDS = 512, 20, 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit("chip_smoke: FAILED: " + msg)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    fail("no HBM rate known for card %r" % name)


def device_ms(fn, reps: int = 20, sleep_cycles: int = 2_000_000) -> float:
    """Median device time of ``fn()`` in ms: each rep starts with the
    50 MB L2 flushed (the decode step finds its pages cold) and a sleep
    of ``sleep_cycles`` that lets the host enqueue the call before the
    device reaches it, so host overhead is not counted as long as the
    enqueue is shorter than the sleep."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    times = []
    for _ in range(reps + 3):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[3:])


def host_call_ms(fn, reps: int = 20) -> float:
    """Median host time of one ``fn()`` call (the enqueue, the device
    idle before it) in ms."""
    times = []
    for _ in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
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
           "cuda": torch.version.cuda, "host_cpus": os.cpu_count(),
           "host_load": list(os.getloadavg())}
    print("chip_smoke: host %d CPUs, load %.2f %.2f %.2f (1, 5, 15 min)"
          % (env["host_cpus"], *env["host_load"]), flush=True)
    emit(env)
    return env


def phase_build() -> dict:
    """Every library of csrc/ down the compile cache's ladder (built into
    ``build/kernels`` on a fresh checkout, one nvcc a source, all
    together)."""
    names = sorted(p.stem for p in _kernels.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    compile_cache.load_libraries(names)
    libs = compile_cache.libraries()
    out = {"phase": "build", "kernels": names,
           "cold": all(libs[n]["rung"] == "built" for n in names),
           "rungs": {n: libs[n]["rung"] for n in names},
           "nvcc_s": {n: libs[n]["compile_s"] for n in names},
           "fingerprints": {n: libs[n]["fingerprint"] for n in names},
           "toolchain": compile_cache.toolchain_and_device(),
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def _paged_errors(got, want) -> dict:
    """Kernel against plain: fp32 outputs within KERNEL_TOL, bf16 ones
    within the bf16 rule; ``worst`` is the error over its bound."""
    if want.dtype == torch.bfloat16:
        return testing.bf16_errors(got, want)
    err = torch.max(torch.abs(got - want)).item()
    return {"max_abs_err": err, "worst": err / KERNEL_TOL,
            "outside": int(torch.count_nonzero(
                torch.abs(got - want) > KERNEL_TOL).item())}


def _paged_measure(name: str, rate: float, q_dtype=torch.float32,
                   kv_dtype=torch.float32, timed: bool = True) -> dict:
    """Kernel B3 on the paged case ``name`` with q in ``q_dtype`` and the
    pools in ``kv_dtype``: against its plain version, launched twice
    (the bits must agree), and if ``timed`` timed beside the plain version
    and SDPA over K/V gathered beforehand in the pools' type."""
    case = paged_decode_case(name)
    q, kp, vp, tables, lens = (
        torch.from_numpy(case[k]).cuda()
        for k in ("q", "k_pages", "v_pages", "tables", "lens"))
    q, kp, vp = q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype)
    b, h, d = q.shape
    bs, t = kp.shape[1], tables.shape[1]
    scale = 1.0 / d ** 0.5
    plain = attention._reference_paged_decode
    got = attention.paged_decode_attention(q, kp, vp, tables, lens)
    again = attention.paged_decode_attention(q, kp, vp, tables, lens)
    want = plain(q, kp, vp, tables, lens, scale)
    torch.cuda.synchronize()
    if got.shape != q.shape or not torch.isfinite(got).all():
        fail("paged decode kernel gave a bad output at %s" % name)
    out = {"case": name, "q_dtype": str(q_dtype), "kv_dtype": str(kv_dtype),
           "shape": {"B": b, "H": h, "D": d, "bs": bs, "T": t,
                     "P": kp.shape[0], "splits": attention.paged_split(bs, t),
                     "lens": lens.tolist()},
           "errors": _paged_errors(got, want),
           "rerun_bitwise": bool(torch.equal(got, again))}
    if not timed:
        return out
    # library yardstick: SDPA over K/V gathered beforehand (not timed), in
    # the pools' type (q cast to it)
    idx = tables.long()
    kg = kp[idx].reshape(b, t * bs, h, d).transpose(1, 2).contiguous()
    vg = vp[idx].reshape(b, t * bs, h, d).transpose(1, 2).contiguous()
    mask = (torch.arange(t * bs, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qs = q[:, :, None, :].to(kv_dtype)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask)

    lib_err = torch.max(torch.abs(
        library()[:, :, 0].float() - want.float())).item()
    ms = device_ms(lambda: attention.paged_decode_attention(
        q, kp, vp, tables, lens))
    plain_ms = device_ms(lambda: plain(q, kp, vp, tables, lens, scale))
    library_ms = device_ms(library)
    # least work: the K and V rows of the live tokens in the pools' type, q
    # in and the context out in q's type, the tables and lengths
    live = int(lens.clamp(max=t * bs).sum().item())
    q_elt, kv_elt = q.element_size(), kp.element_size()
    nbytes = (kv_elt * 2 * live * h * d + q_elt * 2 * b * h * d
              + 4 * (b * t + b))
    flops = 4 * live * h * d
    bytes_ms, flops_ms = 1e3 * nbytes / rate, 1e3 * flops / FP32_FLOPS
    out["shape"]["live_tokens"] = live
    out.update({"library_max_abs_err": lib_err, "kernel_ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(bytes_ms, flops_ms),
                "bound_by": "bytes" if bytes_ms >= flops_ms
                else "operations", "bytes": nbytes})
    return out


#: (q, pages) types of kernel B3: every pairing is checked on every case
PAGED_TYPE_PAIRS = ((torch.float32, torch.float32),
                    (torch.float32, torch.bfloat16),
                    (torch.bfloat16, torch.float32),
                    (torch.bfloat16, torch.bfloat16))
#: the pairs timed at full width: the engine's fp32, bf16 pages under its
#: fp32 q, and bf16 throughout
PAGED_TIMED = ((torch.float32, torch.float32),
               (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.bfloat16))


def _paged_checks(rate: float) -> list:
    """B3 over every paged case and type pair, timed at full width for
    PAGED_TIMED."""
    return [_paged_measure(name, rate, *pair,
                           timed=name == "full_width" and pair in PAGED_TIMED)
            for name in testing.PAGED_CASES for pair in PAGED_TYPE_PAIRS]


def _paged_failures(shapes: list) -> list:
    problems = []
    for s in shapes:
        where = "%s (q %s, pages %s)" % (s["case"], s["q_dtype"],
                                         s["kv_dtype"])
        if not s["errors"]["worst"] <= 1.0:
            problems.append("paged decode kernel off by %g, %g times its "
                            "bound, at %s" % (s["errors"]["max_abs_err"],
                                              s["errors"]["worst"], where))
        if not s["rerun_bitwise"]:
            problems.append("paged decode kernel differs between two "
                            "launches at %s" % where)
    return problems


def _resnet_sgd_leaves(seed: int = 0):
    """The fused-SGD operands of the train path: every leaf of
    ``resnet.init(depth=50)`` (267 leaves, 25,610,152 fp32 elements), a
    grad from numpy ``seed`` for each leaf autograd reaches and None for
    the BN running stats (as in training), zero momentum."""
    tree = resnet.init(torch.Generator(device=DEVICE).manual_seed(seed),
                       DEPTH, CLASSES)
    flat = bridge.flatten(tree)
    rng = np.random.default_rng(seed)
    grads = [None if name.endswith(("/mean", "/var")) else
             torch.from_numpy(rng.standard_normal(
                 tuple(p.shape), dtype=np.float32) * 0.01).to(DEVICE)
             for name, p in flat.items()]
    return tree, list(flat.values()), grads


def _sgd_measure(rate: float) -> dict:
    """Kernel against plain on the ResNet-50 tree: with and without
    ``make_wd_mask``, with and without Nesterov, 5 steps of a cosine lr,
    wd 1e-4, momentum 0.9. Both paths round every product and sum alone,
    so the stated tolerance is 0: bitwise equal at every step."""
    tree, params, grads = _resnet_sgd_leaves()
    sched = optim.cosine_schedule(0.4, 5, 1)
    variants, worst, first_bitwise = [], 0.0, True
    for masked in (False, True):
        mask = optim.make_wd_mask(tree) if masked else None
        decays = [1e-4 if on else 0.0 for on in
                  (bridge.leaves(mask) if masked else [True] * len(params))]
        for nesterov in (False, True):
            pk = [p.clone() for p in params]
            pp = [p.clone() for p in params]
            mk = [torch.zeros_like(p) for p in params]
            mp = [torch.zeros_like(p) for p in params]
            errs = []
            for step in range(1, 6):
                lr = sched(torch.tensor(step, dtype=torch.int32,
                                        device=DEVICE))
                optim.multi_tensor_sgd(pk, grads, mk, decays, lr, 0.9,
                                       nesterov)
                optim._plain_multi_tensor_sgd(pp, grads, mp, decays, lr,
                                              0.9, nesterov)
                torch.cuda.synchronize()
                if step == 1:
                    first_bitwise &= all(torch.equal(a, b)
                                         for a, b in zip(mk, mp))
                errs.append(max(torch.max(torch.abs(a - b)).item()
                                for a, b in zip(pk + mk, pp + mp)
                                if a.numel()))
            worst = max(worst, max(errs))
            variants.append({"wd_mask": masked, "nesterov": nesterov,
                             "max_abs_err_by_step": errs})
    # timing on the unmasked, non-Nesterov update of the training run
    decays = [1e-4] * len(params)
    lr = sched(torch.tensor(3, dtype=torch.int32, device=DEVICE))
    moms = [torch.zeros_like(p) for p in params]
    kernel = lambda: optim.multi_tensor_sgd(  # noqa: E731
        params, grads, moms, decays, lr, 0.9)
    plain = lambda: optim._plain_multi_tensor_sgd(  # noqa: E731
        params, grads, moms, decays, lr, 0.9, False)
    # library yardstick (never used by the port): torch's fused SGD on the
    # same tree, zero grads for the BN stats; its first-step buffer is the
    # reference's with dampening 0
    lib_params = [p.clone() for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = torch.zeros_like(p) if g is None else g.clone()
    lib = torch.optim.SGD(lib_params, lr=0.1, momentum=0.9,
                          weight_decay=1e-4, fused=True)
    lib.step()
    # a ~50 ms sleep covers each call's host enqueue (the Python descriptor
    # table, ~1,700 plain launches), so these are device times; the host
    # side is host_ms
    ms, plain_ms, library_ms = (device_ms(f, sleep_cycles=100_000_000)
                                for f in (kernel, plain, lib.step))
    host_ms = {name: host_call_ms(f) for name, f in
               (("kernel", kernel), ("plain", plain), ("library", lib.step))}
    n = sum(p.numel() for p in params)
    nbytes = sum((16 + (4 if g is not None else 0)) * p.numel()
                 for p, g in zip(params, grads))
    flops = 6 * n
    bytes_ms, flops_ms = 1e3 * nbytes / rate, 1e3 * flops / FP32_FLOPS
    return {"leaves": len(params), "elements": n, "bytes": nbytes,
            "variants": variants, "max_abs_err": worst,
            "first_step_momentum_bitwise": first_bitwise,
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "host_ms": host_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def _flash_inputs(b, h, s, d, dtype, seed=0):
    """q, k, v and an output cotangent [B, H, S, D] drawn on the card from
    a seed, fp32 normals cast to ``dtype``."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn((b, h, s, d), generator=gen, device=DEVICE).to(dtype)
            for _ in range(4)]


def _flash_compare(q, k, v, g, causal):
    """Each kernel and its plain version on the same inputs: the forward
    on q, k, v; dQ and dK/dV both on the plain forward's O and LSE (and
    its delta), so each backward kernel sees its plain version's
    operands. Returns (kernel outputs, plain outputs, backward args)."""
    scale = q.shape[-1] ** -0.5
    out, lse = attention._launch_fwd(q, k, v, scale, causal)
    w_out, w_lse = attention._plain_flash_fwd(q, k, v, scale, causal)
    delta = torch.sum(g.float() * w_out.float(), dim=-1)
    args = (q, k, v, g, w_lse, delta, scale, causal)
    dk, dv = attention._launch_dkv(*args)
    w_dk, w_dv = attention._plain_flash_dkv(*args)
    got = {"o": out, "lse": lse, "dq": attention._launch_dq(*args),
           "dk": dk, "dv": dv}
    want = {"o": w_out, "lse": w_lse,
            "dq": attention._plain_flash_dq(*args), "dk": w_dk, "dv": w_dv}
    return got, want, args


def _flash_errors(got, want) -> dict:
    """Per output, max |kernel - plain| and ``worst``, the largest error
    over its bound (at most 1 passes): FLASH_TOL_F32 for fp32 outputs, one
    bf16 ulp of the plain value plus testing.BF16_ATOL for bf16 ones."""
    out = {}
    for name, w in want.items():
        if w.dtype == torch.bfloat16:
            out[name] = testing.bf16_errors(got[name], w)
        else:
            err = torch.max(torch.abs(got[name] - w)).item()
            out[name] = {"max_abs_err": err, "worst": err / FLASH_TOL_F32}
    return out


def _flash_planted(q, k, v, g, got, want) -> dict:
    """The bf16 rule on two planted faults at the path's shape, each of
    which it must reject in every output: the causal mask reaching one key
    past the diagonal (materialised in fp32), and the kernels' outputs
    with one 64-row tile scaled by 1 + 2^-6."""
    shifted = testing.causal_attention_autograd(q, k, v, g,
                                                q.shape[-1] ** -0.5, edge=1)
    return {"causal_edge_off_by_one": {
                n: testing.bf16_errors(x, want[n]) for n, x in shifted.items()},
            "misscaled_tile": {
                n: testing.bf16_errors(testing.misscaled_tile(got[n]),
                                       want[n]) for n in shifted}}


def _flash_lse_entry(q, k, v, g, causal):
    """flash_attention_lse through autograd on the card, with a nonzero
    LSE cotangent: the forward against the plain forward, and the
    gradients against the plain backward on the operands autograd hands
    the backward kernels (the kernels' O and LSE, delta from that O less
    the LSE cotangent). Returns those errors and, recorded only, the
    gradients against the plain backward on the plain forward's O and
    LSE (the chain): in bf16 the two O part by up to an ulp, and
    ``dP - delta`` cancels on rows of few keys, so the chain's dQ and dK
    may part by many ulps while each kernel is within one."""
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    g_lse = torch.randn(q.shape[:3], generator=gen, device=DEVICE)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = attention.flash_attention_lse(*leaves, causal=causal)
    grads = torch.autograd.grad((out, lse), leaves, (g, g_lse))
    out, lse = out.detach(), lse.detach()
    scale = q.shape[-1] ** -0.5
    w_out, w_lse = attention._plain_flash_fwd(q, k, v, scale, causal)
    got = dict(zip(("o", "lse", "dq", "dk", "dv"), (out, lse, *grads)))
    errors = {}
    for name, (o, l) in (("kernels", (out, lse)), ("chain", (w_out, w_lse))):
        delta = torch.sum(g.float() * o.float(), dim=-1) - g_lse
        args = (q, k, v, g, l, delta, scale, causal)
        w_dk, w_dv = attention._plain_flash_dkv(*args)
        errors[name] = _flash_errors(got, {
            "o": w_out, "lse": w_lse, "dq": attention._plain_flash_dq(*args),
            "dk": w_dk, "dv": w_dv})
    return errors["kernels"], errors["chain"]


def flash_bound(kind: str, shape, dtype, causal: bool, rate: float):
    """The least time of one flash kernel call, in ms, and what sets it:
    the products it must do (2 for the forward, 3 for dQ, 4 for dK/dV,
    each 2*D flops per live (q, k) pair, S(S+1)/2 pairs per head when
    causal) over the peak of the inputs' type, against the bytes it must
    move (each input read once, each output written once: q, k, v, O |
    q, k, v, dO, dQ | q, k, v, dO, dK, dV, plus the fp32 LSE and delta
    rows) over HBM."""
    b, h, s, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    products, tensors, rows = {"fwd": (2, 4, 1), "dq": (3, 5, 2),
                               "dkv": (4, 6, 2)}[kind]
    flops = products * 2 * d * b * h * pairs
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = tensors * b * h * s * d * elt + rows * b * h * s * 4
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    bytes_ms, flops_ms = 1e3 * nbytes / rate, 1e3 * flops / peak
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations", flops, nbytes)


def _flash_small(dtype, dims) -> list:
    """Each flash kernel against its plain version at B=2, H=4, S=512,
    each D of ``dims``, causal and not."""
    small = []
    for d in dims:
        for causal in (False, True):
            q, k, v, g = _flash_inputs(2, 4, 512, d, dtype, seed=d)
            got, want, _ = _flash_compare(q, k, v, g, causal)
            small.append({"shape": [2, 4, 512, d], "causal": causal,
                          "errors": _flash_errors(got, want)})
    return small


def _flash_rounding_model(args, want) -> dict:
    """``testing.mma_flash_fwd`` / ``mma_flash_dq`` / ``mma_flash_dkv``,
    the plain model of the bf16 B2a, B2b and B2c kernels' rounding, with P
    and dS split into bf16 hi + lo as the kernels carry them ("split") and
    rounded once ("single"), against the plain versions under the bf16
    rule."""
    q, k, v, _, _, _, scale, causal = args
    out = {}
    for name, split in (("split", True), ("single", False)):
        o, _ = testing.mma_flash_fwd(q, k, v, scale, causal, split)
        dq = testing.mma_flash_dq(*args, split=split)
        dk, dv = testing.mma_flash_dkv(*args, split=split)
        out[name] = {n: testing.bf16_errors(x, want[n])
                     for n, x in (("o", o), ("dq", dq), ("dk", dk),
                                  ("dv", dv))}
    return out


def _flash_rerun(q, k, v, got, args) -> dict:
    """B2a, B2b and B2c launched again on the inputs of ``got``'s launch:
    per output, whether the bits are the same (no atomics, a fixed
    order)."""
    scale, causal = args[-2:]
    out, lse = attention._launch_fwd(q, k, v, scale, causal)
    dq = attention._launch_dq(*args)
    dk, dv = attention._launch_dkv(*args)
    return {name: bool(torch.equal(x, got[name]))
            for name, x in (("o", out), ("lse", lse), ("dq", dq),
                            ("dk", dk), ("dv", dv))}


def _flash_sp(cases) -> list:
    """Each flash kernel against its plain version at every shape and type
    phase train_sp gives it (``cases``, :data:`SP_FLASH_CASES`): a ring
    hop through ``flash_attention_lse`` with a nonzero LSE cotangent, as
    the merge gives it; Ulysses and one process over the whole sequence
    through B2a, B2b and B2c."""
    out = []
    for i, (what, shape, dtype, causal) in enumerate(cases):
        q, k, v, g = _flash_inputs(*shape, getattr(torch, dtype),
                                   seed=20 + i)
        case = {"case": what, "shape": list(shape), "dtype": dtype,
                "causal": causal}
        if what == "ring_hop":
            case["errors"], case["chain"] = _flash_lse_entry(q, k, v, g,
                                                             causal)
        else:
            got, want, _ = _flash_compare(q, k, v, g, causal)
            case["errors"] = _flash_errors(got, want)
            del got, want
        del q, k, v, g
        torch.cuda.empty_cache()
        out.append(case)
    return out


def _flash_measure(rate: float) -> dict:
    """Kernels B2a/B2b/B2c against their plain versions: fp32 at B=2, H=4,
    S=512, D in {64, 128}, and bf16 there at D in {64, 128, 256} (on the
    tensor cores), causal and not; the LSE entry point through autograd;
    every shape of phases train_sp, train_elastic and train_moe_ep
    (:func:`_flash_sp`);
    bf16 at the training path's shape (16 x 12 x 1024 x 64, causal), where
    B2a, B2b and B2c are also launched twice and must agree bit for bit,
    their rounding model is held to the bf16 rule (and a single rounding
    of P and dS must break it), and the kernels are timed beside
    their plain versions and PyTorch's ``scaled_dot_product_attention``
    (forward; backward = forward and backward less forward, the yardstick
    of dQ and dK/dV together)."""
    small = _flash_small(torch.float32, (64, 128))
    small_bf16 = _flash_small(torch.bfloat16, (64, 128, 256))
    q, k, v, g = _flash_inputs(2, 4, 512, 64, torch.float32, seed=3)
    errors, chain = _flash_lse_entry(q, k, v, g, True)
    lse_entry = {"shape": [2, 4, 512, 64], "causal": True,
                 "errors": errors, "chain": chain}
    sp = _flash_sp(SP_FLASH_CASES + ELASTIC_FLASH_CASES
                   + MOE_EP_FLASH_CASES + TP_FLASH_CASES + PP_FLASH_CASES
                   + HYBRID_FLASH_CASES)

    shape = (GPT_BATCH, gpt.BASE_CONFIG["heads"], GPT_SEQ,
             gpt.BASE_CONFIG["hidden"] // gpt.BASE_CONFIG["heads"])
    q, k, v, g = _flash_inputs(*shape, torch.bfloat16, seed=11)
    got, want, args = _flash_compare(q, k, v, g, True)
    path_errors = _flash_errors(got, want)
    planted = _flash_planted(q, k, v, g, got, want)
    rerun = _flash_rerun(q, k, v, got, args)
    rounding = _flash_rounding_model(args, want)
    del got, want
    scale = shape[-1] ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]

    def lib_fwd_bwd():
        out = sdpa(*leaves, is_causal=True)
        torch.autograd.grad(out, leaves, g)

    lib_err = torch.max(torch.abs(
        sdpa(q, k, v, is_causal=True).float()
        - attention._plain_flash_fwd(q, k, v, scale, True)[0].float())).item()
    calls = {
        "fwd": (lambda: attention._launch_fwd(q, k, v, scale, True),
                lambda: attention._plain_flash_fwd(q, k, v, scale, True)),
        "dq": (lambda: attention._launch_dq(*args),
               lambda: attention._plain_flash_dq(*args)),
        "dkv": (lambda: attention._launch_dkv(*args),
                lambda: attention._plain_flash_dkv(*args))}
    lib_fwd_ms = device_ms(lambda: sdpa(q, k, v, is_causal=True))
    lib_bwd_ms = device_ms(lib_fwd_bwd) - lib_fwd_ms
    rows = {}
    for kind, (kernel, plain) in calls.items():
        bound, by, flops, nbytes = flash_bound(kind, shape, torch.bfloat16,
                                               True, rate)
        ms = device_ms(kernel)
        rows[kind] = {"kernel_ms": ms, "plain_ms": device_ms(plain, reps=5),
                      "library_ms": lib_fwd_ms if kind == "fwd"
                      else lib_bwd_ms,
                      "bound_ms": bound, "bound_by": by, "flops": flops,
                      "bytes": nbytes, "tflop_per_s": flops / ms / 1e9}
    return {"small_fp32": small, "small_bf16": small_bf16,
            "lse_entry": lse_entry, "sp": sp,
            "path": {"shape": list(shape), "dtype": "bf16", "causal": True,
                     "errors": path_errors, "planted_faults": planted,
                     "rerun_bitwise": rerun, "rounding_model": rounding,
                     "library_fwd_max_abs_err": lib_err},
            "timing": rows,
            "library": "scaled_dot_product_attention(is_causal=True); the "
                       "dq and dkv rows both carry its backward (dQ, dK and "
                       "dV together)"}


def _flash_cases(flash: dict) -> list:
    """Every case held to the flash tolerances, small and at the path."""
    return (flash["small_fp32"] + flash["small_bf16"] + flash["sp"]
            + [flash["lse_entry"], flash["path"]])


def _flash_failures(flash: dict) -> list:
    problems = []
    for case in _flash_cases(flash):
        for name, e in case["errors"].items():
            if not e["worst"] <= 1.0:
                problems.append("flash %s off by %g, %g times its bound, at "
                                "%r %s causal=%s" % (
                                    name, e["max_abs_err"], e["worst"],
                                    case["shape"], case.get("dtype", ""),
                                    case["causal"]))
    for fault, errors in flash["path"]["planted_faults"].items():
        for name, e in errors.items():
            if not e["worst"] > 1.0:
                problems.append("the bf16 rule passes planted fault %s in %s"
                                % (fault, name))
    for name, same in flash["path"]["rerun_bitwise"].items():
        if not same:
            problems.append("flash %s differs between two launches on the "
                            "same inputs" % name)
    model = flash["path"]["rounding_model"]
    for name in model["split"]:
        if not model["split"][name]["worst"] <= 1.0:
            problems.append("the split-rounding model of %s breaks the bf16 "
                            "rule" % name)
        if not model["single"][name]["worst"] > 1.0:
            problems.append("the bf16 rule passes a single rounding of P "
                            "and dS in %s" % name)
    return problems


def phase_kernels(rate: float) -> dict:
    attention.paged_decode_attention.launches = 0
    shapes = _paged_checks(rate)
    optim.multi_tensor_sgd.launches = 0
    sgd = _sgd_measure(rate)
    attention.flash_attention.launches = dict.fromkeys(
        attention.flash_attention.launches, 0)
    flash = _flash_measure(rate)
    _zero(moe.moe_apply_fused.launches)
    moe_out = _moe_measure(rate)
    out = {"phase": "kernels", "moe": dict(
        moe_out, replaces={n: r for n, _, r in MOE_KERNELS},
        source=MOE_SOURCE,
        comparison_launches=dict(moe.moe_apply_fused.launches)),
        "flash": dict(
        flash, replaces={n: r for n, _, r in FLASH_KERNELS},
        source=FLASH_SOURCE, tolerance={"fp32": FLASH_TOL_F32,
                                        "bf16": FLASH_TOL_BF16},
        comparison_launches=dict(attention.flash_attention.launches)),
        "kernels": [{
        "name": "paged_decode_attention", "replaces": PAGED_REPLACES,
        "source": PAGED_SOURCE,
        "tolerance": {"fp32": KERNEL_TOL, "bf16": FLASH_TOL_BF16},
        "comparison_launches": attention.paged_decode_attention.launches,
        "shapes": shapes}, dict(
        {"name": "fused_sgd", "replaces": SGD_REPLACES,
         "source": SGD_SOURCE, "tolerance": 0.0,
         "comparison_launches": optim.multi_tensor_sgd.launches}, **sgd)]}
    emit(out)
    if not sgd["first_step_momentum_bitwise"]:
        fail("fused SGD: step-1 momentum is not bitwise equal to plain")
    if not sgd["max_abs_err"] <= 0.0:
        fail("fused SGD kernel off by %g from its plain version (stated "
             "tolerance: bitwise)" % sgd["max_abs_err"])
    problems = (_paged_failures(shapes) + _flash_failures(flash)
                + _moe_failures(moe_out))
    if problems:
        fail("kernels: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# compile_cache: kernel libraries down the ladder across fresh processes
# ---------------------------------------------------------------------------

#: the libraries of csrc/, one a source
CACHE_LIBRARIES = ("flash_attention", "fused_sgd", "moe", "paged_decode")
#: (e): the dead holder's lease TTL, the margin past it within which the
#: waiter must take the lease, and the wait no run of the phase may reach
CACHE_LEASE_TTL_S, CACHE_LEASE_MARGIN_S, CACHE_WAIT_S = 5.0, 10.0, 120.0
#: the planted faults of the phase (each proven in a builder's call):
#: a ladder that skips the lease (gate (a) reads 3 builds) and a store
#: that skips the digest check (gate (c) fails)
CACHE_PLANTED = ("no_lease", "no_digest")


def _cache_kernel_checks(names) -> dict:
    """Each kernel of the libraries ``names`` launched once through its
    wrapper at a small case the kernels phase holds, against its plain
    version on the same inputs: its launches (the wrapper's count, zeroed
    just before), its largest error and whether it is within the kernels
    phase's tolerance (B1 and B4 bitwise, fp32 B2 FLASH_TOL_F32, fp32 B3
    KERNEL_TOL). Keyed by the kernels line's names."""
    out = {}
    if "fused_sgd" in names:
        rng = np.random.default_rng(0)
        shapes = ((64, 3, 7, 7), (1000,), (513,))
        make = lambda: [torch.from_numpy(  # noqa: E731
            rng.standard_normal(s, dtype=np.float32)).to(DEVICE)
            for s in shapes]
        params, grads = make(), make()
        moms = [torch.zeros(s, device=DEVICE) for s in shapes]
        plain_p = [t.clone() for t in params]
        plain_m = [t.clone() for t in moms]
        lr, decays = torch.full((), 0.1, device=DEVICE), [1e-4, 0.0, 1e-4]
        optim.multi_tensor_sgd.launches = 0
        optim.multi_tensor_sgd(params, grads, moms, decays, lr, 0.9)
        launches = optim.multi_tensor_sgd.launches
        optim._plain_multi_tensor_sgd(plain_p, grads, plain_m, decays, lr,
                                      0.9, False)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item()
                  for a, b in zip(params + moms, plain_p + plain_m))
        out["fused_sgd"] = {"launches": launches, "max_abs_err": err,
                            "ok": err <= 0.0}
    if "flash_attention" in names:
        _zero(attention.flash_attention.launches)
        q, k, v, g = _flash_inputs(2, 4, 512, 64, torch.float32)
        got, want, _ = _flash_compare(q, k, v, g, True)
        errors = _flash_errors(got, want)
        for name, key, _ in FLASH_KERNELS:
            outs = {"fwd": ("o", "lse"), "dq": ("dq",),
                    "dkv": ("dk", "dv")}[key]
            out[name] = {
                "launches": attention.flash_attention.launches[key],
                "max_abs_err": max(errors[o]["max_abs_err"] for o in outs),
                "ok": max(errors[o]["worst"] for o in outs) <= 1.0}
    if "moe" in names:
        _zero(moe.moe_apply_fused.launches)
        case = _moe_case(3 * 1024 - 5, 1.25, seed=1)
        variants = {"dispatch": ("dispatch", BF16, BF16, False),
                    "combine": ("combine", BF16, BF16, True)}
        res = _moe_compare(case, tuple(variants.values()))
        for name, key, _ in MOE_KERNELS:
            r = res[moe_variant(*variants[key])]
            out[name] = {"launches": moe.moe_apply_fused.launches[key],
                         "max_abs_err": r["max_abs_err"],
                         "ok": r["bitwise"]}
    if "paged_decode" in names:
        attention.paged_decode_attention.launches = 0
        case = paged_decode_case("ragged")
        q, kp, vp, tables, lens = (
            torch.from_numpy(case[k]).to(DEVICE)
            for k in ("q", "k_pages", "v_pages", "tables", "lens"))
        got = attention.paged_decode_attention(q, kp, vp, tables, lens)
        launches = attention.paged_decode_attention.launches
        want = attention._reference_paged_decode(
            q, kp, vp, tables, lens, 1.0 / q.shape[-1] ** 0.5)
        errors = _paged_errors(got, want)
        out["paged_decode_attention"] = {
            "launches": launches, "max_abs_err": errors["max_abs_err"],
            "ok": errors["worst"] <= 1.0}
    return out


def _plant_cache_fault(planted: str) -> None:
    """Plant one of CACHE_PLANTED in this process."""
    if planted == "no_lease":
        def fetch_only(store, fingerprint, path, label):
            members, tier = store.fetch(fingerprint)
            return (tier if compile_cache._install(members, path)
                    else None), None
        compile_cache._fleet_rung = fetch_only
    elif planted == "no_digest":
        import struct

        from paddle_operator_tpu_torch.artifacts import bundle

        def unchecked(data, expect_fingerprint):
            head = len(bundle.MAGIC) + 4
            (hlen,) = struct.unpack(">I", data[head - 4:head])
            header = json.loads(data[head:head + hlen])
            off, members = head + hlen, {}
            for m in header["members"]:
                members[m["name"]] = data[off:off + m["size"]]
                off += m["size"]
            return members
        bundle.parse = unchecked


def _cache_child(queue, tag: str, env: dict, names, go,
                 planted: str = "") -> None:
    """One fresh process of phase compile_cache: its environment, then,
    once ``go`` is set, the libraries ``names`` down the ladder and each
    of their kernels launched once against its plain version. Puts
    ("ready", tag), then ("done", tag, result) or ("error", tag, trace)."""
    import traceback

    try:
        _apply_env(env)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _plant_cache_fault(planted)
        torch.cuda.init()
        queue.put(("ready", tag))
        if not go.wait(timeout=600):
            raise RuntimeError("never told to start")
        t0 = time.perf_counter()
        compile_cache.load_libraries(names)
        ladder_s = time.perf_counter() - t0
        kernels = _cache_kernel_checks(names)
        store = artifacts.get_store()
        queue.put(("done", tag, {
            "pid": os.getpid(), "ladder_s": ladder_s, "t_done": time.time(),
            "libraries": compile_cache.libraries(),
            "block": compile_cache.startup_block(),
            "store": store.stats() if store is not None else {},
            "kernels": kernels}))
    except BaseException:
        queue.put(("error", tag, traceback.format_exc()))


def _apply_env(env: dict) -> None:
    """Set ``env`` in this process (None unsets)."""
    for key, value in env.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value


def _lease_holder(queue, env: dict, fingerprint: str, go) -> None:
    """(e)'s leaseholder: takes ``fingerprint``'s compile lease once told
    to, says so, and waits to be killed."""
    _apply_env(env)
    queue.put(("ready", "holder"))
    go.wait(timeout=600)
    lease = artifacts.get_store().acquire_compile_lease(fingerprint)
    queue.put(("held", "holder", {"granted": lease.granted,
                                  "at": time.time()}))
    time.sleep(3600)


def _cache_env(cache_dir: str, url: str = "", **extra) -> dict:
    """A fresh process's environment: its own cache dir, the remote tier
    alone (``TPUJOB_ARTIFACT_STORE=0``) or no tier."""
    env = {"TPUJOB_COMPILE_CACHE_DIR": cache_dir,
           "TPUJOB_ARTIFACT_STORE": "0", "TPUJOB_ARTIFACT_URL": url or None,
           "TPUJOB_ARTIFACT_WAIT_S": str(CACHE_WAIT_S),
           "TPUJOB_ARTIFACT_POLL_S": "0.05", "TPUJOB_COMPILE_CACHE": None}
    env.update(extra)
    return env


def _take(queue, kind: str, count: int, timeout: float, procs) -> dict:
    """``count`` messages of ``kind`` from the children's queue. An error
    from a child, a child that died before it said anything more, or the
    timeout fails the phase."""
    import queue as queue_mod

    got, deadline = {}, time.monotonic() + timeout
    while len(got) < count:
        try:
            msg = queue.get(timeout=1.0)
        except queue_mod.Empty:
            # 0: a child that said all and left; -9: the killed holder
            dead = [p.exitcode for p in procs
                    if p.exitcode not in (None, 0, -9)]
            if dead or time.monotonic() > deadline:
                fail("compile_cache: %d of %d processes said %r (exit codes "
                     "of the dead: %r)" % (len(got), count, kind, dead))
            continue
        if msg[0] == "error":
            fail("compile_cache: process %s failed:\n%s" % (msg[1], msg[2]))
        if msg[0] != kind:
            fail("compile_cache: unexpected %r from %s" % (msg[0], msg[1]))
        got[msg[1]] = msg[2] if len(msg) > 2 else None
    return got


class _UncheckedServer(ArtifactServer):
    """An artifact server that hands out its disk's bytes without checking
    them (a tier that lets a corrupted bundle through, as a flaky disk or
    link would): the client's digest check is the one left."""

    def read_bundle(self, fp):
        path = self._path(fp)
        try:
            with open(path, "rb") as fh:
                return fh.read()
        except (OSError, TypeError):
            return None


def _kernel_problems(tag: str, res: dict) -> list:
    return ["%s: %s off its plain version by %g (or launched %d times, "
            "not once)" % (tag, name, k["max_abs_err"], k["launches"])
            for name, k in sorted(res["kernels"].items())
            if not k["ok"] or k["launches"] != 1]


def phase_compile_cache(planted: str = "") -> dict:
    """The compile cache across fresh processes (spawned, each with its
    own empty ``TPUJOB_COMPILE_CACHE_DIR`` and ``TPUJOB_ARTIFACT_URL``,
    ``TPUJOB_ARTIFACT_STORE=0``: the port's ArtifactServer run here is the
    one arbiter). Each loads its libraries through the ladder and launches
    each of their kernels once against its plain version
    (:func:`_cache_kernel_checks`).

    (a) cold fleet: three processes start together; across them each of
        the four libraries is built once and fetched twice, the server
        counts 4 lease grants and 4 releases and holds no lease, and every
        launch is within its tolerance;
    (b) warm restart: a process on (a)'s first directory, no URL: every
        library local, 0 s in nvcc;
    (c) poisoned bundle: fused_sgd's bundle with flipped bytes, served
        unchecked (:class:`_UncheckedServer`): the client's digest rejects
        it (``poisoned_remote`` 2: at the fetch before the lease and at
        the one under it; nothing reaches the loader), builds fused_sgd
        itself, and B1 matches;
    (d) valid bundle, wrong library: moe's library under fused_sgd's key
        (the digest is sound): its first use fails on the missing symbol,
        ``note_first_call_reject`` counts it, fused_sgd is rebuilt from
        its source and B1 matches;
    (e) dead leaseholder: a process takes fused_sgd's lease (TTL
        CACHE_LEASE_TTL_S) and is killed with SIGKILL; the waiter takes
        the lease within the TTL plus CACHE_LEASE_MARGIN_S, builds and
        publishes, and never waits out CACHE_WAIT_S.

    (a), (c), (d) and (e) run together, each on a server of its own, and
    (b) once (a) is done (its process started with the others). (c) and
    (d) take their bundles from this process's own libraries (phase
    build's, the same key). Planted faults
    (``planted``, CACHE_PLANTED, each proven once in a builder's call): a
    ladder that skips the lease (gate (a) reads 3 builds) and a store
    that skips the digest check (gate (c) fails); a fingerprint without
    the device or the toolchain is caught on the CPU
    (``tests/test_torch_compile_cache.py``)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    servers, procs, problems = [], [], []
    try:
        def serve(name, cls=ArtifactServer):
            srv = cls("127.0.0.1:0", store_dir=os.path.join(tmp, name))
            servers.append(srv.start())
            return srv

        def spawn(target, *args):
            p = ctx.Process(target=target, args=args, daemon=True)
            p.start()
            procs.append(p)
            return p

        queue = ctx.Queue()
        fps = {n: compile_cache.library_fingerprint(n)
               for n in CACHE_LIBRARIES}
        # this process's own libraries (phase build's) give (c) and (d)
        # their bundles, so that every case but (b) starts at once
        own = {n: lib.path for n, lib in
               compile_cache.load_libraries(CACHE_LIBRARIES).items()}
        with open(own["fused_sgd"], "rb") as fh:
            sgd_bytes = fh.read()
        with open(own["moe"], "rb") as fh:
            moe_bytes = fh.read()
        fleet = serve("fleet")
        # (c) fused_sgd's bundle with the library's first byte (its ELF
        # magic) and its last flipped, handed out unchecked
        poisoned = serve("poisoned", _UncheckedServer)
        raw = bytearray(artifacts.pack(
            fps["fused_sgd"], {compile_cache.LIBRARY_MEMBER: sgd_bytes}))
        raw[len(raw) - len(sgd_bytes)] ^= 0xFF
        raw[-1] ^= 0xFF
        os.makedirs(poisoned.store_dir)
        with open(os.path.join(poisoned.store_dir,
                               fps["fused_sgd"] + ".tpuart"), "wb") as fh:
            fh.write(bytes(raw))
        # (d) moe's library under fused_sgd's key: a sound digest
        wrong = serve("wrong")
        ArtifactStore(url=wrong.url).publish(
            fps["fused_sgd"], {compile_cache.LIBRARY_MEMBER: moe_bytes})
        # (e) a leaseholder to kill
        dead = serve("dead")
        ttl = {"TPUJOB_ARTIFACT_LEASE_TTL": str(CACHE_LEASE_TTL_S)}
        go, go_b, go_holder = ctx.Event(), ctx.Event(), ctx.Event()
        t0 = time.perf_counter()
        for i in range(3):
            spawn(_cache_child, queue, "a%d" % i,
                  _cache_env(os.path.join(tmp, "a%d" % i), fleet.url),
                  CACHE_LIBRARIES, go, planted)
        sgd = ("fused_sgd",)
        spawn(_cache_child, queue, "b",
              _cache_env(os.path.join(tmp, "a0"), ""), CACHE_LIBRARIES, go_b)
        spawn(_cache_child, queue, "c",
              _cache_env(os.path.join(tmp, "c"), poisoned.url), sgd, go,
              planted)
        spawn(_cache_child, queue, "d",
              _cache_env(os.path.join(tmp, "d"), wrong.url), sgd, go)
        spawn(_cache_child, queue, "e",
              _cache_env(os.path.join(tmp, "e"), dead.url, **ttl), sgd, go)
        holder = spawn(_lease_holder, queue,
                       _cache_env(os.path.join(tmp, "holder"), dead.url,
                                  **ttl), fps["fused_sgd"], go_holder)
        _take(queue, "ready", 8, 300, procs)
        spawn_s = time.perf_counter() - t0
        go_holder.set()
        held = _take(queue, "held", 1, 120, procs)["holder"]
        holder.kill()             # SIGKILL: no release, no goodbye
        holder.join(timeout=30)
        killed_at = time.time()
        go.set()
        t_go = time.time()
        rest = _take(queue, "done", 6, 600, procs)
        cold = {t: rest.pop(t) for t in ("a0", "a1", "a2")}
        cold_s = max(r["t_done"] for r in cold.values()) - t_go
        # (b): a restart on (a)'s first directory, once (a) is done
        go_b.set()
        rest.update(_take(queue, "done", 1, 300, procs))
        wave_s = time.perf_counter() - t0
        rungs = {n: sorted(cold[t]["libraries"][n]["rung"] for t in cold)
                 for n in CACHE_LIBRARIES}
        counts_a = fleet.state.snapshot()
        for n, r in rungs.items():
            if r != ["built", "fleet", "fleet"]:
                problems.append("(a) %s served %r across three processes, "
                                "not built once and fleet twice" % (n, r))
        if (counts_a["lease_grant"], counts_a["lease_release"]) != (4, 4) \
                or fleet.state.leases_held():
            problems.append("(a) the server granted %d leases, released %d "
                            "and holds %d (expected 4, 4, 0)" % (
                                counts_a["lease_grant"],
                                counts_a["lease_release"],
                                fleet.state.leases_held()))
        for t in sorted(cold):
            problems += _kernel_problems("(a) " + t, cold[t])
        # the fleet rung's own fetch, timed here on the warm server
        client = ArtifactStore(url=fleet.url)
        fetch_s, sizes = {}, {}
        for n in CACHE_LIBRARIES:
            t = time.perf_counter()
            members, _ = client.fetch(fps[n])
            fetch_s[n] = time.perf_counter() - t
            sizes[n] = len((members or {}).get(
                compile_cache.LIBRARY_MEMBER, b""))

        b = rest["b"]
        if {n: r["rung"] for n, r in b["libraries"].items()} != \
                dict.fromkeys(CACHE_LIBRARIES, "local") \
                or b["block"]["compile_seconds"] != 0:
            problems.append("(b) the warm restart served %r with %g s in "
                            "nvcc" % ({n: r["rung"] for n, r in
                                       b["libraries"].items()},
                                      b["block"]["compile_seconds"]))
        c = rest["c"]
        # rejected by the digest at both of the ladder's fetches (before
        # the lease and under it), never loaded
        if c["store"].get("poisoned_remote", 0) != 2 \
                or c["block"]["first_call_rejects"] \
                or c["libraries"]["fused_sgd"]["rung"] != "built":
            problems.append("(c) the poisoned bundle was not rejected by "
                            "its digest (poisoned_remote %s, first-use "
                            "rejects %s, fused_sgd %s)" % (
                                c["store"].get("poisoned_remote", 0),
                                c["block"]["first_call_rejects"],
                                c["libraries"]["fused_sgd"]["rung"]))
        d = rest["d"]
        rec_d = d["libraries"]["fused_sgd"]
        if "missing symbol" not in rec_d.get("rejected", "") \
                or rec_d["rung"] != "built" \
                or d["block"]["first_call_rejects"] != 1 \
                or d["store"].get("poisoned_remote", 0) != 1:
            problems.append("(d) the wrong library was not rejected at its "
                            "first use and rebuilt: %r, rejects %d, "
                            "poisoned_remote %s" % (
                                rec_d, d["block"]["first_call_rejects"],
                                d["store"].get("poisoned_remote", 0)))
        e = rest["e"]
        rec_e = e["libraries"]["fused_sgd"]
        took = rec_e["fleet_s"]
        if not held["granted"] or rec_e["rung"] != "built" \
                or e["store"].get("lease_broken", 0) != 1 \
                or e["store"].get("lease_timeout", 0) \
                or e["store"].get("publishes_remote", 0) != 1 \
                or not took <= CACHE_LEASE_TTL_S + CACHE_LEASE_MARGIN_S:
            problems.append("(e) the dead holder's lease was not taken "
                            "within %g s: holder %r, waiter %r, store %r"
                            % (CACHE_LEASE_TTL_S + CACHE_LEASE_MARGIN_S,
                               held, rec_e, e["store"]))
        if dead.state.leases_held() or ArtifactStore(url=dead.url).fetch(
                fps["fused_sgd"])[0] is None:
            problems.append("(e) the waiter left a lease held or published "
                            "nothing")
        for t in ("b", "c", "d", "e"):
            problems += _kernel_problems("(%s)" % t, rest[t])
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        for srv in servers:
            srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    def per_rung(res: dict, key: str, rung: str) -> dict:
        return {n: r[key] for t in sorted(res)
                for n, r in res[t]["libraries"].items() if r["rung"] == rung}

    launches = {name: sum(cold[t]["kernels"][name]["launches"]
                          for t in cold)
                for name in cold["a0"]["kernels"]}
    out = {"phase": "compile_cache", "planted": planted or None,
           "fingerprints": fps, "library_bytes": sizes,
           "toolchain": compile_cache.toolchain_and_device(),
           "cold_fleet": {
               "rungs": rungs, "server": counts_a, "seconds": cold_s,
               "nvcc_s": per_rung(cold, "compile_s", "built"),
               "fleet_rung_s": per_rung(cold, "fleet_s", "fleet"),
               "ladder_s": {t: cold[t]["ladder_s"] for t in sorted(cold)},
               "kernels": {t: cold[t]["kernels"] for t in sorted(cold)}},
           "fleet_fetch_s": fetch_s,
           "warm_restart": {"rungs": {n: r["rung"] for n, r in
                                      b["libraries"].items()},
                            "load_s": {n: r["load_s"] for n, r in
                                       b["libraries"].items()},
                            "compile_seconds": b["block"]["compile_seconds"],
                            "ladder_s": b["ladder_s"]},
           "poisoned": {"store": c["store"],
                        "fused_sgd": c["libraries"]["fused_sgd"]},
           "wrong_library": {"store": d["store"], "fused_sgd": rec_d,
                             "first_call_rejects":
                                 d["block"]["first_call_rejects"]},
           "dead_holder": {"lease_ttl_s": CACHE_LEASE_TTL_S,
                           "held": held, "killed_at": killed_at,
                           "waiter": rec_e, "store": e["store"]},
           "seconds": {"spawn_to_ready": spawn_s, "cold_fleet": cold_s,
                       "wave": wave_s},
           "launches_cold_fleet": launches,
           "kernels": {t: r["kernels"] for t, r in rest.items()}}
    emit(out)
    print("compile_cache: 8 processes ready in %.1f s; cold fleet %.1f s "
          "from the start (nvcc %s s), fleet fetch %s s, warm load %s s, "
          "(e) lease taken %.2f s into the waiter's fleet rung; the wave "
          "%.1f s" % (
              spawn_s, cold_s, {n: round(s, 2) for n, s in
                                out["cold_fleet"]["nvcc_s"].items()},
              {n: round(s, 4) for n, s in fetch_s.items()},
              {n: round(s, 4) for n, s in
               out["warm_restart"]["load_s"].items()},
              took, wave_s), flush=True)
    if problems:
        fail("compile_cache: " + "; ".join(problems))
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


def _profile_summary(prof, steps: int, unit: str) -> dict:
    """Device busy time (union of CUDA kernel intervals), kernel count and
    the top kernels by time, per ``unit`` (iteration or step)."""
    from torch.autograd import DeviceType

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
    return {"kernels_per_" + unit: len(spans) / steps,
            "device_busy_ms_per_" + unit: busy / 1e3 / steps,
            "top_kernels_ms_per_" + unit: [[name[:80], us / 1e3 / steps]
                                           for name, us in top]}


def _kernel_ms(prof, names, steps: int) -> dict:
    """Device ms per step of the CUDA kernels whose names hold each of
    ``names`` (a substring)."""
    from torch.autograd import DeviceType

    by_kernel = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in by_kernel:
                if name in e.name:
                    by_kernel[name] += (e.time_range.end
                                        - e.time_range.start) / 1e3 / steps
    return by_kernel


#: device-time names of kernel B3's two CUDA kernels (a pass split over
#: pages, then the merge of its partials), matched by substring
PAGED_PROFILE_NAMES = ("paged_decode_split", "paged_decode_merge")


def phase_profile(params, cfg, traffic, warm: int = 10,
                  steps: int = 40) -> dict:
    """Where a decode step's time goes: ``steps`` batcher iterations of a
    full batch under torch.profiler, after ``warm`` iterations. Device
    busy time is the union of the CUDA kernels' intervals; the profiler's
    own host overhead inflates the window's wall time."""
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
    out = {"phase": "profile", "iterations": steps,
           "profiled_wall_ms_per_iteration": 1e3 * wall / steps}
    out.update(_profile_summary(prof, steps, "iteration"))
    # the merge is launched early and waits for the split pass (a
    # programmatic dependent launch), so its span overlaps the split's
    out["kernel_ms_per_iteration"] = _kernel_ms(prof, PAGED_PROFILE_NAMES,
                                                steps)
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
        logits, _ = gpt.apply(params, ids, dtype=torch.float32,
                              attn_impl="einsum")
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


# ---------------------------------------------------------------------------
# train: ResNet-50 through TrainJob + run_training
# ---------------------------------------------------------------------------

#: |loss(fused_sgd) - loss(sgd)| allowed over the 30 steps, and between the
#: resumed run and the first: 0. The kernel is bitwise equal to its plain
#: version (kernels phase) and cuDNN is held to deterministic algorithms,
#: so the runs must agree bit for bit.
TRAIN_TOL = 0.0


def _event():
    return torch.cuda.Event(enable_timing=True)


class _StepRecorder:
    """Wraps a TrainJob's loss and optimizer as a user could: keeps each
    step's loss on the device (read once, at the end), an event at each
    forward's start, and events and host time around each update."""

    def __init__(self, loss=resnet.loss_fn) -> None:
        self.loss = loss
        self.losses, self.starts, self.updates, self.update_host = \
            [], [], [], []
        self.moe_aux = []
        self.end = None

    def loss_fn(self, params, batch):
        ev = _event()
        ev.record()
        self.starts.append(ev)
        loss, aux = self.loss(params, batch)
        self.losses.append(loss.detach())
        if isinstance(aux, dict) and "moe_aux" in aux:
            self.moe_aux.append(aux["moe_aux"].detach())
        return loss, aux

    def wrap(self, opt: optim.Optimizer) -> optim.Optimizer:
        def update(grads, state, params):
            a, b = _event(), _event()
            a.record()
            t0 = time.perf_counter()
            out = opt.update(grads, state, params)
            self.update_host.append(time.perf_counter() - t0)
            b.record()
            self.updates.append((a, b))
            return out
        return optim.Optimizer(opt.init, update)

    def host_losses(self) -> list:
        return torch.stack(self.losses).cpu().tolist()

    def forward_gaps_ms(self, first: int, last: int) -> list:
        """ms from each step's forward to the next, steps ``first`` to
        ``last`` (1-based; step ``last``'s gap ends at step last+1)."""
        marks = self.starts[first - 1:last + 1]
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


#: the runner observability of phase train's run (a): its profiler window
#: (0-based steps 10:13, the default) and the B1 launches its Chrome trace
#: must hold, one a step; the planted fault's window of two steps, taken
#: on run (f)
OBS_WINDOW, OBS_WINDOW_B1, OBS_FAULT_WINDOW = "10:13", 3, "10:12"
#: |wall - (goodput + every badput)| allowed in goodput_detail, seconds
#: (the reference's runner test's bound)
GOODPUT_TOL = 2e-3
#: the hardware block's MFU over a run (each step's device time, start to
#: end) against its wall-clock MFU (the same FLOPs at the device's
#: forward-to-forward rate; in run (a), steps 11-30, whose gaps hold the
#: saves, the window's trace export and the final drain): |block / wall -
#: 1| allowed. Sound, run (a) read 0.9657-1.3848 on an H100 (1.40 with
#: a first step slowed by the counter's start taken out), the
#: device-bound clock check about 1 (PERF.md §6). Its planted fault, a
#: host clock around each dispatch: in run (a) the launch queue holds the
#: host to the card's pace and it reads within 3 % of the card's clock
#: (no band can tell them apart there, and it moves MFU by under 3 %); on
#: the device-bound check it reads the enqueue alone (PERF.md §6)
MFU_BAND = 0.6
#: the device-bound clock check: two fp32 matrix products of this width a
#: forward, on a batch of as many rows, TF32 off, for this many steps and
#: no saves: ~20 device ms a product, a few dozen launches a step, so the
#: host runs steps ahead of the card between log boundaries. At 6144 a
#: step took the card 46.4 ms and a host clock read 6.18 times the
#: wall-clock MFU (PERF.md §6); 8192 keeps it past the band on a host
#: 3.5 times slower
CLOCK_WIDTH, CLOCK_STEPS = 8192, 20


@contextlib.contextmanager
def _environ(**values):
    """``os.environ`` with ``values`` set, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _MetricsScraper:
    """Scrapes a run's worker ``/metrics`` from a thread while it trains,
    as a monitoring agent would: the endpoint's URL from the runner's log
    line, then a GET every ``every`` seconds until closed. Each scrape
    keeps the strict parser's errors, ``tpujob_worker_steps_total`` and
    whether the MFU gauge is there."""

    def __init__(self, every: float = 0.1) -> None:
        self.every = every
        self.url = None
        self.scrapes = []
        self._stop = threading.Event()
        scraper = self

        class Handler(logging.Handler):
            def emit(self, record) -> None:
                if str(record.msg).startswith("worker metrics at"):
                    scraper.url = record.args[0]

        self._handler = Handler()
        self._log = logging.getLogger("tpujob.runner")
        self._level = self._log.level
        self._thread = threading.Thread(target=self._run,
                                        name="metrics-scraper", daemon=True)

    def __enter__(self) -> "_MetricsScraper":
        self._log.setLevel(logging.INFO)
        self._log.addHandler(self._handler)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self._log.removeHandler(self._handler)
        self._log.setLevel(self._level)

    def _run(self) -> None:
        while not self._stop.wait(self.every):
            if self.url is None:
                continue
            try:
                with urllib.request.urlopen(self.url + "/metrics",
                                            timeout=2) as resp:
                    text = resp.read().decode()
            except OSError:
                continue
            steps = [float(line.split()[1]) for line in text.splitlines()
                     if line.startswith("tpujob_worker_steps_total ")]
            self.scrapes.append({
                "errors": parse_exposition(text),
                "steps_total": steps[0] if steps else None,
                "mfu_gauge": any(line.startswith("tpujob_worker_mfu ")
                                 for line in text.splitlines())})


def _trace_launches(trace_dir: str, name: str) -> list:
    """Kernel events whose name holds ``name``, in each Chrome trace
    ``profile_steps`` wrote to ``trace_dir``."""
    counts = []
    for fname in sorted(os.listdir(trace_dir)):
        with open(os.path.join(trace_dir, fname)) as f:
            events = json.load(f)["traceEvents"]
        counts.append(sum(1 for e in events if e.get("cat") == "kernel"
                          and name in e.get("name", "")))
    return counts


def _mfu_ratio(blk: dict, wall_mfu: float) -> float:
    """The hardware block's MFU over the wall-clock MFU (0 without
    either)."""
    return (blk["mfu"] or 0.0) / wall_mfu if wall_mfu > 0 else 0.0


def _mfu_problems(blk: dict, wall_mfu: float) -> list:
    """The ``mfu`` gate: the block's MFU within MFU_BAND of the wall
    clock's."""
    ratio = _mfu_ratio(blk, wall_mfu)
    if abs(ratio - 1.0) <= MFU_BAND:
        return []
    return [("mfu", "the block's MFU %s is %.3f of the wall-clock MFU "
             "%.6f (band %g)" % (blk["mfu"], ratio, wall_mfu, MFU_BAND))]


#: the badput causes each run must charge: run (a) its saves and its
#: batch waits, the resumed run (c) its restore
GOODPUT_CAUSES = {"run_a": ("checkpoint", "data_stall"),
                  "resumed": ("restore",)}


def _observability_problems(out: dict, resumed: dict, flops: float,
                            peak: float, wall_mfu: float, window: list,
                            scrapes: list) -> list:
    """(gate, message) for each gate of a run's observability it fails:
    ``peak`` (the H100's registry peak), ``conservation`` (the block's own
    audit), ``flops`` (the block's FLOPs a step are ``flops``, the
    profiled step's count), ``mfu`` (:func:`_mfu_problems`),
    ``profile_window`` (the Chrome traces hold OBS_WINDOW_B1 B1
    launches), ``goodput`` (the ledger conserves within GOODPUT_TOL, and
    ``out`` and the resumed run ``resumed`` charge each of their
    GOODPUT_CAUSES), ``metrics`` (two scrapes or more, each clean under
    the strict parser, steps_total reaching the run's steps, the MFU
    gauge).

    The ledger's conservation is structural: the runner books what the
    named causes leave of the non-productive time as ``host_other``, so
    that part fails only by rounding. A runner that stopped charging a
    cause would still conserve, with its seconds in ``host_other``; the
    causes' presence is what the goodput gate can see of that."""
    p = []
    blk = out["hardware"]
    if not ("H100" in blk["device_kind"]
            and blk["peak_source"] == "registry"
            and blk["peak_flops"] == peak):
        p.append(("peak", "the hardware block's chip is %s, %s peak %g, "
                  "not the H100's registry %g" % (
                      blk["device_kind"], blk["peak_source"],
                      blk["peak_flops"], peak)))
    p += [("conservation", v) for v in conservation_violations(blk)]
    if blk["flops_per_step"] != flops:
        p.append(("flops", "the block counts %g FLOPs a step, the profiled "
                  "step %g" % (blk["flops_per_step"], flops)))
    p += _mfu_problems(blk, wall_mfu)
    if window != [OBS_WINDOW_B1]:
        p.append(("profile_window", "the window's Chrome traces hold %r B1 "
                  "launches, expected [%d]" % (window, OBS_WINDOW_B1)))
    for run, res in (("run_a", out), ("resumed", resumed)):
        d = res["goodput_detail"]
        gap = abs(d["goodput_s"] + sum(d["badput_s"].values())
                  - d["wall_s"])
        missing = [c for c in GOODPUT_CAUSES[run]
                   if not d["badput_s"].get(c, 0) > 0]
        if not gap <= GOODPUT_TOL or missing:
            p.append(("goodput", "%s's goodput_detail leaves %.6f s "
                      "unattributed (bound %g) or charges no %s: %r"
                      % (run, gap, GOODPUT_TOL, missing, d)))
    steps = [s["steps_total"] for s in scrapes
             if s["steps_total"] is not None]
    if len(scrapes) < 2 or any(s["errors"] for s in scrapes) or \
            max(steps, default=0) != out["steps"] or \
            not any(s["mfu_gauge"] for s in scrapes):
        p.append(("metrics", "%d scrapes, errors %r, steps_total up to %s, "
                  "MFU gauge %s" % (
                      len(scrapes), [s["errors"] for s in scrapes
                                     if s["errors"]][:2],
                      max(steps, default=None),
                      any(s["mfu_gauge"] for s in scrapes))))
    return p


class _HostStepClock(StepClock):
    """The planted fault of the ``mfu`` gate: the host's clock around each
    dispatch on a CUDA device, as if the runner banked the seconds the
    call took to return; a launch returns before the card has run it."""

    def __init__(self, plane, device) -> None:
        super().__init__(plane, "cpu")


def _matmul_loss(params, batch):
    """Two fp32 matrix products and a mean square."""
    return ((batch @ params["w1"]) @ params["w2"]).square().mean(), {}


def _clock_run(host_clock: bool, peak: float) -> dict:
    """CLOCK_STEPS steps of two CLOCK_WIDTH-wide fp32 layers through
    run_training, TF32 off, no saves: the hardware block, and the
    wall-clock MFU of steps 2 to the end (the device's clock from step
    2's forward to an event after run_training returned). With
    ``host_clock`` the runner times its steps with _HostStepClock."""
    w = CLOCK_WIDTH

    def init_params(gen):
        return {k: torch.randn(w, w, generator=gen, device=DEVICE)
                * w ** -0.5 for k in ("w1", "w2")}

    rec = _StepRecorder(loss=_matmul_loss)
    job = TrainJob(
        init_params=init_params, loss_fn=rec.loss_fn,
        optimizer=optim.sgd(1e-3),
        make_batch=lambda gen, step: torch.randn(w, w, generator=gen,
                                                 device=DEVICE),
        total_steps=CLOCK_STEPS, log_every=10, device=DEVICE)
    matmul = torch.backends.cuda.matmul
    saved = (matmul.allow_tf32, runner.StepClock)
    matmul.allow_tf32 = False
    if host_clock:
        runner.StepClock = _HostStepClock
    try:
        out = run_training(job)
        rec.end = _event()
        rec.end.record()
        torch.cuda.synchronize()
    finally:
        matmul.allow_tf32, runner.StepClock = saved
    blk = out["hardware"]
    span_s = rec.starts[1].elapsed_time(rec.end) / 1e3
    wall_mfu = blk["flops_per_step"] * (CLOCK_STEPS - 1) / span_s / peak
    return {"hardware": blk, "wall_clock_mfu_steps_2_on": wall_mfu,
            "block_mfu_over_wall": _mfu_ratio(blk, wall_mfu),
            "device_ms_per_step": 1e3 * span_s / (CLOCK_STEPS - 1),
            "gates_failed": sorted({g for g, _ in _mfu_problems(blk,
                                                               wall_mfu)})}


def _train_run(opt, total: int, ckpt_dir: str, make_batch=None,
               **job_kw):
    rec = _StepRecorder()
    job = dataclasses.replace(
        migrate_check.resnet_job(
            dict(depth=DEPTH, classes=CLASSES, image=IMAGE, batch=BATCH,
                 steps=total, device=DEVICE),
            optimizer=rec.wrap(opt), make_batch=make_batch),
        loss_fn=rec.loss_fn, checkpoint_every=10, checkpoint_dir=ckpt_dir,
        **job_kw)
    t0 = time.perf_counter()
    out = run_training(job)
    rec.end = _event()
    rec.end.record()    # after the last step and the final checkpoint drain
    torch.cuda.synchronize()
    return rec, out, time.perf_counter() - t0


@contextlib.contextmanager
def _flop_counters():
    """``obs.hardware.StepFlopCounter`` noting each step it counts while
    open: yields a list with one entry a counter made (a counter enters
    itself again for each decomposition it counts)."""
    from paddle_operator_tpu_torch.obs import hardware

    entered, base = [], hardware.StepFlopCounter

    class Noted(base):
        def __init__(self):
            super().__init__()
            entered.append(1)

    hardware.StepFlopCounter = Noted
    try:
        yield entered
    finally:
        hardware.StepFlopCounter = base


def _train_profile(warm: int = 2, steps: int = 5) -> dict:
    """torch.profiler over ``steps`` train steps (fused_sgd, one device
    batch), and the step's FLOPs from FlopCounterMode."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    job = migrate_check.resnet_job(dict(
        depth=DEPTH, classes=CLASSES, image=IMAGE, batch=BATCH, steps=30,
        schedule=30, device=DEVICE))
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    batch = job.make_batch(gen, 0)
    step_fn, state = build_train_step(
        job.loss_fn, job.optimizer, job.init_params(gen), batch,
        merge_stats=job.merge_stats)
    for _ in range(warm):
        step_fn(state, batch)
    with FlopCounterMode(display=False) as counter:
        step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _profile_summary(prof, steps, "step")
    out.update(profiled_wall_ms_per_step=1e3 * wall / steps,
               flops_per_step=counter.get_total_flops())
    return out


def phase_train(smi: str) -> dict:
    """ResNet-50, 224x224, batch 128, bf16 compute on fp32 master params,
    ``cosine_schedule(0.4, 30, 1)``, momentum 0.9, wd 1e-4, synthetic
    batches from a seed, through TrainJob + run_training:
    (a) 30 steps with fused_sgd, checkpoints every 10 steps;
    (b) the same 30 steps with sgd;
    (c) (a) resumed from its step-10 checkpoint through restore_latest;
    then 20 steps on one fixed batch, and a profiled window.

    The step-cost rung (``TPUJOB_COMPILE_CACHE_DIR`` names an empty
    directory for the phase: a step cost persists only there): run (a)
    counts ResNet-50's first step and saves its cost; run (c) must read
    it back (``result["compile_cache"]["step_cost"] == ["cache"]``), its
    flops_per_step bit for bit run (a)'s, and its first step must run
    outside ``StepFlopCounter``.

    Run (a) also carries the runner's observability (``metrics_port=0``,
    ``TPUJOB_PROFILE_DIR`` with the window OBS_WINDOW): its ``/metrics``
    scraped from a thread while it trains, and the gates of
    :func:`_observability_problems` on its result (and on the resumed
    run's ledger); the fixed-batch run takes the planted window
    OBS_FAULT_WINDOW, and a tampered block and ledgers whose checkpoint,
    data_stall or restore seconds went to host_other are the other
    planted faults. The ``mfu`` gate is proven on the device-bound
    :func:`_clock_run`, sound and under the planted _HostStepClock (in run
    (a) a host clock reads within a few % of the card's). Each fault must
    fail its gate."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        dirs = {k: os.path.join(tmp, k) for k in "abc"}
        prof_dirs = {k: os.path.join(tmp, "profile_" + k) for k in "af"}
        optim.multi_tensor_sgd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with _environ(TPUJOB_COMPILE_CACHE_DIR=os.path.join(tmp, "cost")):
            with _environ(TPUJOB_PROFILE_DIR=prof_dirs["a"],
                          TPUJOB_PROFILE_STEPS=OBS_WINDOW), \
                    _MetricsScraper() as scraper:
                rec_a, out_a, wall_a = _train_run(
                    resnet_optimizer("fused_sgd", 30), 30, dirs["a"],
                    metrics_port=0)
            launches_a = optim.multi_tensor_sgd.launches
            peak_mem = torch.cuda.max_memory_allocated()
            optim.multi_tensor_sgd.launches = 0
            rec_b, out_b, wall_b = _train_run(resnet_optimizer("sgd", 30),
                                              30, dirs["b"])
            launches_b = optim.multi_tensor_sgd.launches
            os.makedirs(dirs["c"])
            shutil.copytree(os.path.join(dirs["a"], "step_%012d" % 10),
                            os.path.join(dirs["c"], "step_%012d" % 10))
            optim.multi_tensor_sgd.launches = 0
            with _flop_counters() as counted_c:
                rec_c, out_c, _ = _train_run(
                    resnet_optimizer("fused_sgd", 30), 30, dirs["c"])
            launches_c = optim.multi_tensor_sgd.launches
        fixed = resnet.synthetic_batch(
            torch.Generator(device=DEVICE).manual_seed(1), BATCH, IMAGE,
            CLASSES)
        with _environ(TPUJOB_PROFILE_DIR=prof_dirs["f"],
                      TPUJOB_PROFILE_STEPS=OBS_FAULT_WINDOW):
            rec_f, _, _ = _train_run(resnet_optimizer("fused_sgd", 20), 20,
                                     "", make_batch=lambda gen, step: fixed)
        window = {k: _trace_launches(d, "fused_sgd_kernel")
                  for k, d in prof_dirs.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        cudnn.deterministic, cudnn.benchmark = saved
    la, lb, lc, lf = (r.host_losses() for r in (rec_a, rec_b, rec_c, rec_f))
    def timing(rec) -> dict:
        """Steps 11-30 (indices 10-29) of a 30-step run, from the event at
        each forward's start to the next, and for step 30 to the event
        after run_training returned: the window holds the step-20 and
        step-30 checkpoints and the final writer drain."""
        marks = rec.starts[10:30] + [rec.end]
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        span_s = marks[0].elapsed_time(marks[-1]) / 1e3
        return {"images_per_s": BATCH * len(step_ms) / span_s,
                "step_ms_median": statistics.median(step_ms),
                "step_ms": step_ms,
                "optimizer_ms_per_step": statistics.mean(
                    a.elapsed_time(b) for a, b in rec.updates[10:30]),
                "optimizer_host_ms_per_step": 1e3 * statistics.mean(
                    rec.update_host[10:30])}

    times = {"fused_sgd": timing(rec_a), "sgd": timing(rec_b)}
    profile_out = _train_profile()
    peak = lookup_chip(torch.cuda.get_device_name(0))[0]
    clock = {"sound": _clock_run(False, peak),
             "host_clock": _clock_run(True, peak)}
    step_s = times["fused_sgd"]["step_ms_median"] / 1e3
    # the runner's observability of run (a), held to its gates, and each
    # gate against its planted fault
    blk = out_a["hardware"]
    wall_mfu = (profile_out["flops_per_step"]
                * times["fused_sgd"]["images_per_s"] / BATCH / peak)
    sound = dict(out=out_a, resumed=out_c,
                 flops=profile_out["flops_per_step"], peak=peak,
                 wall_mfu=wall_mfu, window=window["a"],
                 scrapes=scraper.scrapes)
    detail = out_a["goodput_detail"]
    # run (a) under the host clock: the same span the runner's
    # step_dispatch stage times, around the same call
    host_s = out_a["host_stages"]["step_dispatch"]["ms"] / 1e3
    host_clock_ratio_a = blk["total_flops"] / host_s / peak / wall_mfu

    def uncharged(res: dict, cause: str) -> dict:
        """``res`` from a runner that stopped charging ``cause``: its
        seconds land in host_other, and the ledger still conserves."""
        d = res["goodput_detail"]
        badput = dict(d["badput_s"])
        moved = badput.pop(cause)
        badput["host_other"] = badput.get("host_other", 0.0) + moved
        return dict(res, goodput_detail=dict(d, badput_s=badput))

    planted = {
        # one step too many in the total: the lowest miscount
        "tampered_total_flops": ("conservation", dict(sound, out=dict(
            out_a, hardware=dict(blk, total_flops=blk["flops_per_step"]
                                 * (blk["steps"] + 1))))),
        "window_10_12": ("profile_window", dict(sound, window=window["f"])),
        "uncharged_checkpoint": ("goodput", dict(
            sound, out=uncharged(out_a, "checkpoint"))),
        "uncharged_data_stall": ("goodput", dict(
            sound, out=uncharged(out_a, "data_stall"))),
        "uncharged_restore": ("goodput", dict(
            sound, resumed=uncharged(out_c, "restore"))),
    }
    obs_problems = _observability_problems(**sound)
    obs_faults = {name: sorted({g for g, _ in _observability_problems(**kw)})
                  for name, (gate, kw) in planted.items()}
    # the profiled window is one fixed batch without the loader or the
    # writer, and the profiler slows the host; the idle share of run (a) is
    # read from its un-profiled median step against the profiled busy time
    busy_ms = profile_out["device_busy_ms_per_step"]
    out = {
        "phase": "train", "card": smi,
        "config": {"depth": DEPTH, "classes": CLASSES, "image": IMAGE,
                   "batch": BATCH, "compute": "bf16", "params": "fp32",
                   "cudnn_deterministic": True},
        "losses": {"fused_sgd": la, "sgd": lb, "resumed_from_10": lc,
                   "fixed_batch": lf},
        "max_abs_loss_diff_fused_vs_sgd": max(abs(x - y)
                                              for x, y in zip(la, lb)),
        "max_abs_loss_diff_resumed": max(abs(x - y)
                                         for x, y in zip(la[10:], lc)),
        "launches": {"fused_sgd": launches_a, "sgd": launches_b,
                     "resumed": launches_c},
        "resume_steps": out_c.get("resume_steps"),
        "step_cost": {"run_a": out_a["compile_cache"]["step_cost"],
                      "run_c": out_c["compile_cache"]["step_cost"],
                      "run_c_counted_steps": len(counted_c),
                      "flops_per_step": {
                          "run_a": blk["flops_per_step"],
                          "run_c": out_c["hardware"]["flops_per_step"]}},
        "compile_cache": out_c["compile_cache"],
        "timing_steps_11_30": times,
        "wall_s": {"fused_sgd": wall_a, "sgd": wall_b},
        "max_memory_allocated": peak_mem,
        "host_stages_fused_sgd": out_a["host_stages"],
        "profile": profile_out,
        "idle_share_unprofiled_fused_sgd": 1.0 - busy_ms / (1e3 * step_s),
        "flops_per_s": profile_out["flops_per_step"] / step_s,
        "bf16_peak_share": profile_out["flops_per_step"] / step_s
        / BF16_FLOPS,
        "observability_fused_sgd": {
            "hardware": blk, "goodput": out_a["goodput"],
            "goodput_detail": detail,
            "step_profile": out_a["step_profile"],
            "straggler_events": out_a["straggler_events"],
            "backend_degraded_events": out_a["backend_degraded_events"],
            "wall_clock_mfu_steps_11_30": wall_mfu,
            "block_mfu_over_wall": _mfu_ratio(blk, wall_mfu),
            "host_clock_mfu_over_wall": host_clock_ratio_a,
            "host_dispatch_s": host_s,
            "mfu_band": MFU_BAND,
            "clock_check": clock,
            "resumed_goodput_detail": out_c["goodput_detail"],
            "profile_window": {"steps": OBS_WINDOW, "b1_launches":
                               window["a"]},
            "metrics_scrapes": len(scraper.scrapes),
            "metrics_steps_total": [s["steps_total"]
                                    for s in scraper.scrapes],
            "gates_failed": sorted({g for g, _ in obs_problems}),
            "planted_faults": dict(
                {name: {"gate": gate, "gates_failed": obs_faults[name]}
                 for name, (gate, _) in planted.items()},
                host_clock={"gate": "mfu", "gates_failed":
                            clock["host_clock"]["gates_failed"]}),
            "fault_window": {"steps": OBS_FAULT_WINDOW,
                             "b1_launches": window["f"]}},
    }
    emit(out)
    print("train observability (%s): hardware block MFU %s over %d steps "
          "(%s, peak %g, %s FLOPs a step), wall-clock MFU of steps 11-30 "
          "%.6f, ratio %.4f (a host clock's %.4f); goodput %s, badput %s; "
          "resumed badput %s; %d /metrics scrapes; window B1 %r, planted "
          "window %r; clock check (%.3f device ms a step): ratio %.4f, "
          "host clock's %.4f" % (
              smi, blk["mfu"], blk["steps"], blk["device_kind"],
              blk["peak_flops"], blk["flops_per_step"], wall_mfu,
              _mfu_ratio(blk, wall_mfu), host_clock_ratio_a,
              out_a["goodput"], detail["badput_s"],
              out_c["goodput_detail"]["badput_s"], len(scraper.scrapes),
              window["a"], window["f"],
              clock["sound"]["device_ms_per_step"],
              clock["sound"]["block_mfu_over_wall"],
              clock["host_clock"]["block_mfu_over_wall"]), flush=True)
    problems = [msg for _, msg in obs_problems]
    for name, (gate, _) in planted.items():
        if gate not in obs_faults[name]:
            problems.append("the %s gate missed the planted fault %s"
                            % (gate, name))
    problems += ["clock check: %s" % msg for _, msg in _mfu_problems(
        clock["sound"]["hardware"], clock["sound"]["wall_clock_mfu_steps_2_on"])]
    if "mfu" not in clock["host_clock"]["gates_failed"]:
        problems.append("the mfu gate missed the planted fault host_clock "
                        "(ratio %.4f)"
                        % clock["host_clock"]["block_mfu_over_wall"])
    if la[0] != lb[0]:
        problems.append("first losses differ: %r vs %r" % (la[0], lb[0]))
    if not out["max_abs_loss_diff_fused_vs_sgd"] <= TRAIN_TOL:
        problems.append("fused_sgd and sgd losses differ by %g"
                        % out["max_abs_loss_diff_fused_vs_sgd"])
    if len(lc) != 20 or not out["max_abs_loss_diff_resumed"] <= TRAIN_TOL:
        problems.append("the resumed run does not reproduce steps 11-30 "
                        "(%d losses, off by %g)"
                        % (len(lc), out["max_abs_loss_diff_resumed"]))
    if out_c.get("resume_steps") != [10]:
        problems.append("the resumed run restored %r, not step 10"
                        % out_c.get("resume_steps"))
    # the step-cost rung: (a) saved ResNet-50's cost, (c) reads it back
    if out_c["compile_cache"]["step_cost"] != ["cache"] or counted_c:
        problems.append("the resumed run's step cost came from %r, with %d "
                        "counted steps (expected the cache and none)"
                        % (out_c["compile_cache"]["step_cost"],
                           len(counted_c)))
    if out_c["hardware"]["flops_per_step"] != blk["flops_per_step"]:
        problems.append("the resumed run's flops_per_step %r is not run "
                        "(a)'s %r" % (out_c["hardware"]["flops_per_step"],
                                      blk["flops_per_step"]))
    if (launches_a, launches_b, launches_c) != (30, 0, 20):
        problems.append("fused_sgd launches %d/%d/%d, expected 30/0/20"
                        % (launches_a, launches_b, launches_c))
    if len(la) != 30 or len(lb) != 30 or out_a["steps"] != 30:
        problems.append("runs did not take 30 steps")
    if not all(np.isfinite(x) for x in la + lb + lc + lf):
        problems.append("a loss is not finite")
    if not lf[-1] < lf[0]:
        problems.append("20 steps on one batch did not lower the loss "
                        "(%g -> %g)" % (lf[0], lf[-1]))
    if problems:
        fail("train: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# train_gpt: GPT-2 small through examples/train_gpt.py's job
# ---------------------------------------------------------------------------

#: |loss(flash kernels) - loss(einsum)| / loss allowed at every step of the
#: 20: the einsum path rounds its scores and P to bf16 and the kernels do
#: not. On an H100 the two runs parted by at most 3.8e-6 relative over the
#: 20 steps, dk_unscaled by 1.4e-4 and dq_tile_shifted by only 1.7e-5
GPT_EINSUM_RTOL = 2e-5
#: step 0's gradients, kernels against einsum attention: the largest
#: ||g - g_einsum|| / ||g_einsum|| over the parameter leaves. On an H100:
#: 0.021 sound, 38 with dk_unscaled, 1.4 with dq_tile_shifted
GPT_GRAD_RTOL = 0.05
#: planted backward faults, made on the kernels' own outputs, that the
#: gradient gate must reject: dK without its softmax scale, and dQ moved
#: by one 64-row tile along the sequence (a tile index off by one)
PLANTED_BACKWARD = ("dk_unscaled", "dq_tile_shifted")
#: the planted faults that the loss gate must reject too: the losses
#: barely depend on dQ, so a shifted dQ tile stays near the gate
LOSS_GATE_SEES = ("dk_unscaled",)
#: steps of each planted fault's run: on an H100 80GB HBM3 at 700 W
#: dk_unscaled parted from the einsum run by 3.4e-5 at step 1 and by
#: 9.9e-5 at step 3, against the loss gate's 2e-5
GPT_PLANTED_STEPS = 5


@contextlib.contextmanager
def _planted_backward(fault: str):
    """While open, the dQ or the dK/dV launch returns ``fault``."""
    launch_dq, launch_dkv = attention._launch_dq, attention._launch_dkv

    def dkv_unscaled(q, k, v, dout, lse, delta, scale, causal):
        dk, dv = launch_dkv(q, k, v, dout, lse, delta, scale, causal)
        return dk / scale, dv

    def dq_tile_shifted(*args):
        return torch.roll(launch_dq(*args), 64, dims=2)

    if fault == "dk_unscaled":
        attention._launch_dkv = dkv_unscaled
    elif fault == "dq_tile_shifted":
        attention._launch_dq = dq_tile_shifted
    else:
        raise ValueError("no planted fault %r" % fault)
    try:
        yield
    finally:
        attention._launch_dq, attention._launch_dkv = launch_dq, launch_dkv


def _gpt_env(steps: int = GPT_STEPS) -> dict:
    return {"TPUJOB_BATCH": str(GPT_BATCH), "TPUJOB_SEQ": str(GPT_SEQ),
            "TPUJOB_STEPS": str(steps)}


def _zero(launches: dict) -> dict:
    for key in launches:
        launches[key] = 0
    return launches


def _recorded_run(job, ckpt_dir: str, make_batch=None, every: int = 10):
    """``job`` through run_training, its loss and optimizer wrapped by a
    _StepRecorder, checkpoints every ``every`` steps into ``ckpt_dir``
    ("" for none). Returns (recorder, result, wall seconds)."""
    rec = _StepRecorder(job.loss_fn)
    job = dataclasses.replace(
        job, loss_fn=rec.loss_fn, optimizer=rec.wrap(job.optimizer),
        make_batch=make_batch or job.make_batch, log_every=10,
        checkpoint_every=every, checkpoint_dir=ckpt_dir, seed=0,
        device=DEVICE)
    t0 = time.perf_counter()
    out = run_training(job)
    rec.end = _event()
    rec.end.record()
    torch.cuda.synchronize()
    out.pop("state", None)   # free the run's params and optimizer state
    return rec, out, time.perf_counter() - t0


def _gpt_run(attn_impl: str, ckpt_dir: str, make_batch=None,
             steps: int = GPT_STEPS):
    """examples/train_gpt.py's TrainJob for ``steps`` steps, checkpoints
    every 10 steps; also the flash launches of the run."""
    launches = _zero(attention.flash_attention.launches)
    rec, out, wall = _recorded_run(
        train_gpt.make_job(_gpt_env(steps), attn_impl=attn_impl), ckpt_dir,
        make_batch)
    return rec, out, wall, dict(launches)


def _attention_flops(cfg: dict) -> int:
    """Model FLOPs of causal attention per step, by hand: per layer, the
    forward's two products of 2*D flops per live (q, k) pair, times 3 for
    the backward. FlopCounterMode sees the kernels only through the flash
    operators' FLOP reports; this count, independent of them, is what the
    phase holds them to."""
    d = cfg["hidden"] // cfg["heads"]
    pairs = GPT_SEQ * (GPT_SEQ + 1) // 2
    return 3 * cfg["layers"] * 2 * 2 * d * GPT_BATCH * cfg["heads"] * pairs


def _grad_check(env: dict, references: dict, variants: dict) -> dict:
    """Step 0's gradients of examples/train_gpt.py's loss (the job of
    ``env``: remat, chunked head) on its first batch, each variant's
    against each reference's, as the largest ||g - g_ref|| / ||g_ref||
    over the parameter leaves: ``{reference: {variant: reading}}``. Every
    value of ``references`` and ``variants`` is ``(attn_impl, context)``:
    the loss and its backward (which recomputes under remat) run inside
    ``context()``."""
    job = train_gpt.make_job(env)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = job.init_params(gen)
    batch = job.make_batch(gen, 0)
    leaves = bridge.flatten(params)
    for t in leaves.values():
        t.requires_grad_()

    def grads(attn_impl: str, context) -> dict:
        with context():
            loss, _ = train_gpt.make_job(env, attn_impl).loss_fn(params,
                                                                 batch)
            return dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))

    def reading(got: dict, ref: dict) -> dict:
        rel = {n: (torch.linalg.vector_norm(g - ref[n])
                   / torch.linalg.vector_norm(ref[n])).item()
               for n, g in got.items()}
        worst = max(rel, key=rel.get)
        return {"max_rel_diff": rel[worst], "leaf": worst}

    refs = {name: grads(*v) for name, v in references.items()}
    out = {name: {} for name in refs}
    for name, v in variants.items():
        got = grads(*v)
        for ref_name, ref in refs.items():
            out[ref_name][name] = reading(got, ref)
    return out


def _gpt_grad_check() -> dict:
    """The flash kernels' step-0 gradients against the einsum attention's,
    sound and under each planted backward fault."""
    variants = {"sound": ("auto", contextlib.nullcontext)}
    for fault in PLANTED_BACKWARD:
        variants[fault] = ("auto", functools.partial(_planted_backward,
                                                     fault))
    return _grad_check(_gpt_env(), {"einsum": ("einsum",
                                                contextlib.nullcontext)},
                       variants)["einsum"]


#: |the counter's FLOPs with the flash operators reporting - (its count
#: without them + the hand count of attention)| / the latter allowed on
#: phase train_gpt's forward and backward
FLOP_RTOL = 0.01


@contextlib.contextmanager
def _flash_flops_unreported():
    """The planted fault of the FLOP gate: FlopCounterMode made while open
    does not know the flash operators' formulas, so it counts no attention
    (as before the operators reported)."""
    from torch.utils.flop_counter import flop_registry

    ops = [getattr(torch.ops.paddle_tpu_torch, "flash_" + k)
           for k in ("fwd", "dq", "dkv")]
    saved = {op: flop_registry.pop(op) for op in ops}
    try:
        yield
    finally:
        flop_registry.update(saved)


#: device-time names of the flash kernels, matched by substring: each
#: covers both designs (``flash_fwd_kernel<float, D>`` on fp32 and
#: ``flash_fwd_mma_kernel<D>`` on bf16; likewise dq and dkv)
FLASH_PROFILE_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")
#: every CUDA kernel of B4: dispatch's slot-table build and its gather,
#: and combine
MOE_PROFILE_NAMES = ("moe_slot_table_kernel", "moe_dispatch_kernel",
                     "moe_combine_kernel")


def _step_profile(job, params, batch, names=(), warm: int = 2,
                  steps: int = 3) -> dict:
    """torch.profiler over ``steps`` train steps of ``job``'s loss and
    optimizer from ``params`` on one fixed batch, after ``warm`` steps:
    device busy time, the top kernels and each kernel in ``names``' device
    time per step."""
    from torch.profiler import ProfilerActivity, profile

    step_fn, state = build_train_step(job.loss_fn, job.optimizer,
                                      params, batch, grad_clip=job.grad_clip)
    for _ in range(warm):
        step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _profile_summary(prof, steps, "step")
    out.update(profiled_wall_ms_per_step=1e3 * wall / steps,
               kernel_ms_per_step=_kernel_ms(prof, names, steps))
    return out


def _gpt_profile(env=None, names=FLASH_PROFILE_NAMES) -> dict:
    """:func:`_step_profile` of the example's job (from ``env``, default
    ``_gpt_env()``), and the model FLOPs from FlopCounterMode over one
    forward and backward without recompute (remat off, dense head), twice:
    with the flash operators reporting their FLOPs
    (``counted_flops_per_step``) and without (the planted fault,
    ``unreported_flops_per_step``, to which the caller adds attention by
    hand)."""
    from torch.utils.flop_counter import FlopCounterMode

    job = train_gpt.make_job(env or _gpt_env())
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = job.init_params(gen)
    batch = job.make_batch(gen, 0)
    leaves = bridge.flatten(params)
    for t in leaves.values():
        t.requires_grad_()
    counts = {}
    for key, context in (("counted", contextlib.nullcontext),
                         ("unreported", _flash_flops_unreported)):
        with context(), FlopCounterMode(display=False) as counter:
            loss, _ = gpt.loss_fn(params, batch, remat=False,
                                  attn_impl="auto", ce_chunk=0)
            torch.autograd.grad(loss, list(leaves.values()))
        counts[key + "_flops_per_step"] = counter.get_total_flops()
        del loss
    del leaves
    out = _step_profile(job, params, batch, names)
    out.update(counts)
    return out


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms on (the embedding's index backward is
    atomic otherwise), without filling fresh memory, restored after."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.utils.deterministic.fill_uninitialized_memory)
    deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        deterministic_algorithms(saved[0])
        torch.utils.deterministic.fill_uninitialized_memory = saved[1]


def phase_train_gpt(smi: str) -> dict:
    """GPT-2 small (BASE_CONFIG), batch 16 x 1024, bf16 on fp32 params,
    adamw + cosine(3e-4), wd 0.1, grad clip 1.0, remat, ce_chunk 1024,
    synthetic batches drawn on the card from (seed, step), through
    examples/train_gpt.py's TrainJob and run_training. First step 0's
    gradients, kernels against einsum, sound and under each planted
    backward fault; then
    (a) 20 steps with attn_impl="auto" (the flash kernels), checkpoints
        every 10 steps;
    (b) the same 20 steps with attn_impl="einsum";
    (c) (a) resumed from its step-10 checkpoint;
    (d) (a)'s first GPT_PLANTED_STEPS steps under each planted backward
        fault, without checkpoints;
    then 20 steps on one fixed batch and a profiled window. Deterministic
    algorithms are on throughout (the embedding's index backward is
    atomic otherwise), so (c) must reproduce (a) bit for bit."""
    cfg = dict(gpt.BASE_CONFIG)
    with _deterministic(), tempfile.TemporaryDirectory(
            prefix="chip_smoke_gpt_") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in "abc"}
        grad_check = _gpt_grad_check()
        torch.cuda.reset_peak_memory_stats()
        rec_a, out_a, wall_a, launches_a = _gpt_run("auto", dirs["a"])
        peak = torch.cuda.max_memory_allocated()
        # (b) checkpoints too: the background writer slows the steps after
        # a save, so both runs carry it and their steps compare like for
        # like
        rec_b, out_b, wall_b, launches_b = _gpt_run("einsum", dirs["b"])
        os.makedirs(dirs["c"])
        shutil.copytree(os.path.join(dirs["a"], "step_%012d" % 10),
                        os.path.join(dirs["c"], "step_%012d" % 10))
        rec_c, out_c, _, launches_c = _gpt_run("auto", dirs["c"])
        planted_losses = {}
        for fault in PLANTED_BACKWARD:
            with _planted_backward(fault):
                planted_losses[fault] = _gpt_run(
                    "auto", "", steps=GPT_PLANTED_STEPS)[0].host_losses()
        fixed = gpt.synthetic_batch(
            torch.Generator(device=DEVICE).manual_seed(1), GPT_BATCH,
            GPT_SEQ, cfg["vocab_size"])
        rec_f, _, _, _ = _gpt_run("auto", "",
                                  make_batch=lambda gen, step: fixed)
        profile_out = _gpt_profile()
    la, lb, lc, lf = (r.host_losses() for r in (rec_a, rec_b, rec_c, rec_f))
    tokens = GPT_BATCH * GPT_SEQ
    # steps 11-20: from step 11's forward to the end of step 20's update
    # (the step-20 checkpoint and the writer drain are outside the window)
    def steps_11_20(rec) -> list:
        marks = rec.starts[10:20] + [rec.updates[19][1]]
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    def steps_2_9(rec) -> float:
        """Median of steps 2-9, forward to forward: after the first step's
        warm-up and before the step-10 checkpoint, so no background
        writer shares the host."""
        return statistics.median(a.elapsed_time(b) for a, b in
                                 zip(rec.starts[1:9], rec.starts[2:10]))

    def max_rel(losses) -> float:
        """The largest |loss - einsum loss| / einsum loss over the steps."""
        return max(abs(x - y) / abs(y) for x, y in zip(losses, lb))

    step_ms, einsum_ms = steps_11_20(rec_a), steps_11_20(rec_b)
    span_s = sum(step_ms) / 1e3
    median_s = statistics.median(step_ms) / 1e3
    busy_ms = profile_out["device_busy_ms_per_step"]
    flash_ms = profile_out["kernel_ms_per_step"]
    # the model FLOPs as PRs 3-16 counted them (attention by hand), and
    # the counter's own count with the flash operators reporting, which
    # must agree with it; the planted fault leaves the report out
    model_flops = profile_out["unreported_flops_per_step"] + \
        _attention_flops(cfg)
    flop_rel = abs(profile_out["counted_flops_per_step"] - model_flops) \
        / model_flops
    flop_fault_rel = abs(profile_out["unreported_flops_per_step"]
                         - model_flops) / model_flops
    blk = out_a["hardware"]
    expected = {"fwd": 2 * cfg["layers"] * GPT_STEPS,
                "dq": cfg["layers"] * GPT_STEPS,
                "dkv": cfg["layers"] * GPT_STEPS}
    out = {
        "phase": "train_gpt", "card": smi,
        "config": {"model": "gpt BASE_CONFIG", "batch": GPT_BATCH,
                   "seq": GPT_SEQ, "steps": GPT_STEPS, "compute": "bf16",
                   "params": "fp32", "optimizer": "adamw cosine(3e-4)",
                   "remat": True, "ce_chunk": 1024,
                   "deterministic_algorithms": True},
        "losses": {"flash": la, "einsum": lb, "resumed_from_10": lc,
                   "fixed_batch": lf, "planted_backward": planted_losses},
        "max_rel_loss_diff_flash_vs_einsum": max_rel(la),
        "grad_check_step_0": grad_check,
        "planted_backward": {
            f: {"max_rel_loss_diff_vs_einsum": max_rel(planted_losses[f]),
                "grad_max_rel_diff": grad_check[f]["max_rel_diff"]}
            for f in PLANTED_BACKWARD},
        "tolerance": {"loss_rtol": GPT_EINSUM_RTOL,
                      "grad_rtol": GPT_GRAD_RTOL},
        "max_abs_loss_diff_resumed": max(abs(x - y)
                                         for x, y in zip(la[10:], lc)),
        "launches": {"flash": launches_a, "einsum": launches_b,
                     "resumed": launches_c, "expected_flash": expected},
        "resume_steps": out_c.get("resume_steps"),
        "tokens_per_s_steps_11_20": tokens * len(step_ms) / span_s,
        "step_ms_median": 1e3 * median_s, "step_ms": step_ms,
        "einsum_step_ms_median": statistics.median(einsum_ms),
        "einsum_step_ms": einsum_ms,
        "step_ms_median_steps_2_9": {"flash": steps_2_9(rec_a),
                                     "einsum": steps_2_9(rec_b)},
        "optimizer_ms_per_step": statistics.mean(
            a.elapsed_time(b) for a, b in rec_a.updates[10:20]),
        "wall_s": {"flash": wall_a, "einsum": wall_b},
        "max_memory_allocated": peak, "peak_gb": peak / 1e9,
        "host_stages_flash": out_a["host_stages"],
        "profile": profile_out,
        "idle_share_unprofiled": 1.0 - busy_ms / (1e3 * median_s),
        "idle_share_steps_2_9": 1.0 - busy_ms / steps_2_9(rec_a),
        "flash_ms_per_step": sum(flash_ms.values()),
        "flash_share_of_step": sum(flash_ms.values()) / (1e3 * median_s),
        "model_flops_per_step": model_flops,
        "attention_flops_per_step": _attention_flops(cfg),
        "mfu_bf16": model_flops / median_s / BF16_FLOPS,
        "counted_flops_per_step": profile_out["counted_flops_per_step"],
        "flop_rel_diff_vs_hand": flop_rel,
        "flop_rtol": FLOP_RTOL,
        "planted_flash_flops_unreported_rel_diff": flop_fault_rel,
        "hardware_flash": blk,
        "goodput_detail_flash": out_a["goodput_detail"],
        "step_profile_flash": out_a["step_profile"],
        # the block counts the step as it ran: under remat the forward
        # runs twice, so its FLOPs a step exceed the model count
        "block_flops_over_model_flops": blk["flops_per_step"] / model_flops,
    }
    emit(out)
    print("train_gpt FLOPs (%s): counter with the flash operators %g, "
          "without %g + attention by hand %g = %g (off by %.2e, gate %g; "
          "left out: %.2e); hardware block MFU %s at %g FLOPs a step "
          "(remat's recompute: %.4f of the model count) against the "
          "phase's MFU %.6f" % (
              smi, profile_out["counted_flops_per_step"],
              profile_out["unreported_flops_per_step"],
              _attention_flops(cfg), model_flops, flop_rel, FLOP_RTOL,
              flop_fault_rel, blk["mfu"], blk["flops_per_step"],
              blk["flops_per_step"] / model_flops, out["mfu_bf16"]),
          flush=True)
    problems = []
    if not flop_rel <= FLOP_RTOL:
        problems.append("the counter's FLOPs with the flash operators part "
                        "from the hand count by %g > %g"
                        % (flop_rel, FLOP_RTOL))
    if not flop_fault_rel > FLOP_RTOL:
        problems.append("the FLOP gate passes the planted fault "
                        "flash_flops_unreported (%g)" % flop_fault_rel)
    for v in conservation_violations(blk):
        problems.append("train_gpt hardware block: " + v)
    if out["max_rel_loss_diff_flash_vs_einsum"] > GPT_EINSUM_RTOL:
        problems.append("flash and einsum losses part by %g relative > %g"
                        % (out["max_rel_loss_diff_flash_vs_einsum"],
                           GPT_EINSUM_RTOL))
    if not grad_check["sound"]["max_rel_diff"] <= GPT_GRAD_RTOL:
        problems.append("step-0 gradients of the kernels and einsum part by "
                        "%g relative > %g at %s"
                        % (grad_check["sound"]["max_rel_diff"],
                           GPT_GRAD_RTOL, grad_check["sound"]["leaf"]))
    for fault in PLANTED_BACKWARD:
        if not grad_check[fault]["max_rel_diff"] > GPT_GRAD_RTOL:
            problems.append("the gradient gate passes planted fault %s"
                            % fault)
    for fault in LOSS_GATE_SEES:
        if not max_rel(planted_losses[fault]) > GPT_EINSUM_RTOL:
            problems.append("the loss gate passes planted fault %s" % fault)
    if len(lc) != 10 or out["max_abs_loss_diff_resumed"] != 0.0:
        problems.append("the resumed run does not reproduce steps 11-20 "
                        "bitwise (%d losses, off by %g)"
                        % (len(lc), out["max_abs_loss_diff_resumed"]))
    if out_c.get("resume_steps") != [10]:
        problems.append("the resumed run restored %r, not step 10"
                        % out_c.get("resume_steps"))
    if launches_a != expected:
        problems.append("flash launches %r, expected %r"
                        % (launches_a, expected))
    if any(launches_b.values()):
        problems.append("the einsum run launched %r" % launches_b)
    if launches_c != {k: n // 2 for k, n in expected.items()}:
        problems.append("the resumed run launched %r, expected half of %r"
                        % (launches_c, expected))
    if len(la) != GPT_STEPS or len(lb) != GPT_STEPS or \
            out_a["steps"] != GPT_STEPS:
        problems.append("runs did not take %d steps" % GPT_STEPS)
    if not all(np.isfinite(x) for x in la + lb + lc + lf):
        problems.append("a loss is not finite")
    if not lf[-1] < lf[0]:
        problems.append("20 steps on one batch did not lower the loss "
                        "(%g -> %g)" % (lf[0], lf[-1]))
    if problems:
        fail("train_gpt: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# MoE kernels B4a/B4b: checks and timings (part of the kernels phase)
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
#: B4a/B4b against their plain versions: each output element is one copy
#: or one fp32 product and one conversion in both, so bitwise
MOE_TOL = 0.0
#: the forward fault planted in the kernel check and the GPT-MoE run:
#: combine launched without its gate
MOE_FORWARD_FAULT = "combine_ignores_gate"
#: the backward fault: combine's backward drops the gate's cotangent (as a
#: needs_input_grad shortcut would), so the router learns only through
#: the aux loss
MOE_BACKWARD_FAULT = "gate_grad_dropped"
PLANTED_MOE = (MOE_FORWARD_FAULT, MOE_BACKWARD_FAULT)


#: the MoE paths a run can take: the kernels (TPUJOB_MOE_FUSED=1), the
#: same fused formulation with the kernels' plain versions run on the card
#: in their place, and the dense einsum formulation (TPUJOB_MOE_FUSED=0)
MOE_PATHS = ("kernels", "plain", "dense")


@contextlib.contextmanager
def _moe_path(path: str, fault: str = ""):
    """While open, MoE layers take ``path`` (one of MOE_PATHS) and, with
    ``fault``, a planted MoE fault is in place."""
    if path not in MOE_PATHS:
        raise ValueError("no MoE path %r" % path)
    saved_env = os.environ.get("TPUJOB_MOE_FUSED")
    saved = (moe._launch_dispatch, moe._launch_combine,
             moe._Combine.backward)
    launch_combine, backward = saved[1], saved[2]

    def combine_ignores_gate(eo, choice, pos, gate, capacity, out_dtype):
        return launch_combine(eo, choice, pos, None, capacity, out_dtype)

    def gate_grad_dropped(ctx, dout):
        grads = backward(ctx, dout)
        return (grads[0], None) + tuple(grads[2:])

    os.environ["TPUJOB_MOE_FUSED"] = "0" if path == "dense" else "1"
    if path == "plain":
        moe._launch_dispatch = moe._plain_dispatch
        moe._launch_combine = moe._plain_combine
    if fault == MOE_FORWARD_FAULT:
        moe._launch_combine = combine_ignores_gate
    elif fault == MOE_BACKWARD_FAULT:
        moe._Combine.backward = staticmethod(gate_grad_dropped)
    elif fault:
        raise ValueError("no planted MoE fault %r" % fault)
    try:
        yield
    finally:
        moe._launch_dispatch, moe._launch_combine = saved[:2]
        moe._Combine.backward = staticmethod(backward)
        if saved_env is None:
            os.environ.pop("TPUJOB_MOE_FUSED", None)
        else:
            os.environ["TPUJOB_MOE_FUSED"] = saved_env


@contextlib.contextmanager
def _routes_logged(log: list, path: str, fault: str = ""):
    """``_moe_path(path, fault)``, with each ``moe._route`` call's
    routing appended to ``log`` as a ``[3, T]`` (choice, position, kept)
    tensor, in call order: the forward's MoE layers first, then remat's
    recompute of them from the last layer back."""
    route = moe._route

    def logged(*args):
        out = route(*args)
        log.append(torch.stack((out[1], out[2], (out[2] < out[3]).long())))
        return out

    moe._route = logged
    try:
        with _moe_path(path, fault):
            yield
    finally:
        moe._route = route


def _routing_parts(log: list, ref: list, layers: int) -> dict:
    """Tokens of each MoE layer's forward routed apart in ``log`` and in
    ``ref``: another (choice, position); another expert; kept in one and
    dropped in the other. Also whether each log's recompute routed every
    token as its forward did."""
    pairs = list(zip(log[:layers], ref[:layers]))
    return {
        "tokens_apart": [int((a != b).any(0).sum().item()) for a, b in pairs],
        "expert_apart": [int((a[0] != b[0]).sum().item()) for a, b in pairs],
        "drop_apart": [int((a[2] != b[2]).sum().item()) for a, b in pairs],
        "recompute_equal": all(
            len(lg) == 2 * layers and all(
                torch.equal(f, r) for f, r in zip(lg[:layers],
                                                  lg[layers:][::-1]))
            for lg in (log, ref))}


@torch.no_grad()
def _moe_case(tokens: int, factor: float, seed: int = 0,
              dim: int = 0, experts: int = 0) -> dict:
    """``tokens`` tokens of GPT-2 small's width (or ``dim``) routed by
    ``moe._route`` over MOE_EXPERTS experts (or ``experts``; a router
    from ``moe_init``, activations N(0, 1) from ``seed``, on the card),
    with an fp32 gate and expert outputs ``[E, capacity, D]``."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    d = dim or gpt.BASE_CONFIG["hidden"]
    e = experts or MOE_EXPERTS
    params = moe.moe_init(gen, d, 8, e)
    x = torch.randn((1, tokens, d), generator=gen, device=DEVICE)
    gate, choice, pos, cap, _ = moe._route(params, x, factor)
    eo = torch.randn((e, cap, d), generator=gen, device=DEVICE)
    return {"x": x[0], "eo": eo, "gate": gate, "choice": choice, "pos": pos,
            "capacity": cap, "kept": int((pos < cap).sum().item())}


def moe_variant(kernel: str, tin, tout, weighted: bool) -> str:
    """A B4 variant's name: weighted is the gate of combine, the scale of
    dispatch."""
    return "%s %s->%s%s" % (kernel, str(tin)[6:], str(tout)[6:],
                            {(True, "dispatch"): " scaled",
                             (True, "combine"): " gated"}.get(
                                 (weighted, kernel), ""))


def _moe_args(kernel: str, tin, tout, weighted: bool, case: dict) -> tuple:
    """The arguments of one B4 variant on ``case``, its input in ``tin``."""
    e, c = case.get("experts", MOE_EXPERTS), case["capacity"]
    w = case["gate"] if weighted else None
    if kernel == "dispatch":
        return (case["x"].to(tin), case["choice"], case["pos"], e, c, tout, w)
    return (case["eo"].to(tin), case["choice"], case["pos"], w, c, tout)


def _moe_fns(kernel: str):
    """(the kernel's wrapper, its plain version), as ``moe`` holds them
    now (``_moe_path`` swaps them)."""
    if kernel == "dispatch":
        return moe._launch_dispatch, moe._plain_dispatch
    return moe._launch_combine, moe._plain_combine


def _moe_compare(case: dict, variants) -> dict:
    """Each (kernel, in type, out type, weighted) variant launched, and
    its plain version on the same inputs: bitwise equality, max error and
    the kernel's path by the wrapper's per-path counts."""
    out = {}
    paths = moe.moe_apply_fused.path_launches
    for kernel, tin, tout, weighted in variants:
        args = _moe_args(kernel, tin, tout, weighted, case)
        launch, plain = _moe_fns(kernel)
        before = dict(paths)
        got = launch(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        name = moe_variant(kernel, tin, tout, weighted)
        out[name] = {"bitwise": bool(torch.equal(got, want)),
                     "max_abs_err": (got.float() - want.float()).abs()
                     .max().item(),
                     "paths": [k for k in paths if paths[k] != before[k]]}
        if kernel == "combine":
            out[name]["dropped_rows_zero"] = not bool(
                got[case["pos"] >= case["capacity"]].any())
    return out


def moe_bound(kernel: str, tin, tout, weighted: bool, case: dict,
              rate: float):
    """The least time of one B4 call on ``case``, in ms, what sets it and
    its bytes: B4a reads the kept rows in its input type, the int64
    routing and, scaled, the fp32 scale, and writes all of ``[E, C, D]``
    in its output type; B4b reads the kept expert rows, the routing and,
    gated, the gate, and writes ``[T, D]``; weighted, one product per kept
    element."""
    t, d = case["x"].shape
    size = {F32: 4, BF16: 2}
    rows_out = MOE_EXPERTS * case["capacity"] if kernel == "dispatch" else t
    nbytes = (case["kept"] * d * size[tin] + rows_out * d * size[tout]
              + 16 * t + (4 * t if weighted else 0))
    flops = case["kept"] * d if weighted else 0
    bytes_ms, flops_ms = 1e3 * nbytes / rate, 1e3 * flops / FP32_FLOPS
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations", nbytes)


#: every (kernel, in type, out type, weighted) variant the kernels take:
#: the bf16 compute path's (forward: dispatch, gated combine; backward:
#: the dispatch of combine's cotangent scaled by the gate, the ungated
#: combine for dx and, in fp32, for the gate's rows), the fp32 compute
#: path's, and the rest of each kernel's pairs
MOE_VARIANTS = (
    ("dispatch", BF16, BF16, False), ("dispatch", BF16, BF16, True),
    ("dispatch", F32, BF16, False), ("dispatch", F32, BF16, True),
    ("dispatch", F32, F32, False), ("dispatch", F32, F32, True),
    ("combine", BF16, BF16, True), ("combine", BF16, BF16, False),
    ("combine", BF16, F32, False), ("combine", BF16, F32, True),
    ("combine", F32, F32, True), ("combine", F32, F32, False))
#: the variants one bf16 train step launches, and how often per MoE layer:
#: (variant, launches per forward, launches per backward). Remat runs the
#: forward twice
MOE_STEP_VARIANTS = (
    (("dispatch", BF16, BF16, False), 1, 0),
    (("dispatch", BF16, BF16, True), 0, 1),
    (("combine", BF16, BF16, True), 1, 0),
    (("combine", BF16, BF16, False), 0, 1),
    (("combine", BF16, F32, False), 0, 1))
#: the kernels line's row of each kernel: its forward variant
MOE_MAIN = {"dispatch": moe_variant("dispatch", BF16, BF16, False),
            "combine": moe_variant("combine", BF16, BF16, True)}


def _moe_library(kernel: str, tin, tout, weighted: bool, case: dict):
    """A PyTorch yardstick of one B4 variant on ``case``, with the same
    output type: dispatch ``zero_`` + ``index_copy_`` into ``[E*C + 1,
    D]`` (dropped tokens into the spare row), after ``torch.mul`` by the
    scale into the output type where scaled (else a copy ``to`` it where
    the types differ); combine ``index_select`` of the kept rows, then
    ``torch.mul`` by the gate (ungated: by 1, and 0 for a dropped token)
    with ``out=`` in the output type."""
    e, c = MOE_EXPERTS, case["capacity"]
    choice, pos, gate = case["choice"], case["pos"], case["gate"]
    keep = pos < c
    if kernel == "dispatch":
        x = case["x"].to(tin)
        t, d = x.shape
        slots = torch.where(keep, choice * c + pos, e * c)
        buf = torch.zeros((e * c + 1, d), dtype=tout, device=DEVICE)
        tmp = torch.empty((t, d), dtype=tout, device=DEVICE)
        if weighted:
            return lambda: buf.zero_().index_copy_(
                0, slots, torch.mul(x, gate[:, None], out=tmp))
        if tin != tout:
            return lambda: buf.zero_().index_copy_(0, slots, x.to(tout))
        return lambda: buf.zero_().index_copy_(0, slots, x)
    eo = case["eo"].to(tin).view(e * c, -1)
    rows = torch.where(keep, choice * c + pos, 0)
    w = torch.where(keep, gate if weighted else 1.0, 0.0)[:, None]
    out = torch.empty((rows.shape[0], eo.shape[1]), dtype=tout, device=DEVICE)
    return lambda: torch.mul(torch.index_select(eo, 0, rows), w, out=out)


def _moe_copy(kernel: str, tin, tout, case: dict):
    """What the memory system gives a plain copy of one B4 variant's
    rows: PyTorch's ``copy_`` of the ``[T, D]`` input (every token kept
    on the path) into an output row block of ``tout``, and, for
    dispatch, ``zero_`` of the ``[E, C, D]`` output's other rows."""
    x = (case["x"] if kernel == "dispatch" else case["eo"]).to(tin)
    t, d = case["x"].shape
    rows = MOE_EXPERTS * case["capacity"] if kernel == "dispatch" else t
    out = torch.empty((rows, d), dtype=tout, device=DEVICE)
    src = x.reshape(-1, d)[:t]
    if rows == t:
        return lambda: out.copy_(src)
    return lambda: (out[:t].copy_(src), out[t:].zero_())


def _moe_measure(rate: float) -> dict:
    """Kernels B4a/B4b against their plain versions, bitwise, over every
    variant: at the GPT-2 small MoE path's shape (T = 16 x 1024, D = 768,
    E = 8, capacity 2560) and at the BERT-base-MoE path's (T = 16 x 512,
    capacity 1280), both on the 16-byte path; at a rank's tokens and
    experts on the MoE-ep path (MOE_EP_B4_CASES: a dp4 rank's 4096
    tokens over 8 experts, a dp2 x ep2 rank's 8192 tokens over its 4,
    the capacity of the global 16384) and on the hybrid path
    (HYBRID_B4_CASES); then at a ragged T; at
    capacity factor 0.5 (dropped rows must be exact zeros); at D = 203
    (the scalar path); and with the forward fault planted (the check must
    reject it). Each variant a bf16 train step launches is timed at the
    GPT path's shape beside its bound, its plain version and a PyTorch
    yardstick (``_moe_library``) and a plain copy of its rows
    (``_moe_copy``); the forward variants also beside the dense einsum
    formulation."""
    path = _moe_case(GPT_BATCH * GPT_SEQ, 1.25)
    bert_path = _moe_case(BERT_MOE_BATCH * BERT_SEQ, 1.25, seed=2)
    checks = {"path": _moe_compare(path, MOE_VARIANTS),
              "bert_path": dict(_moe_compare(bert_path, MOE_VARIANTS),
                                tokens=BERT_MOE_BATCH * BERT_SEQ,
                                capacity=bert_path["capacity"])}
    del bert_path
    for name, tokens, factor, dim in (
            ("ragged", 3 * 1024 - 5, 1.25, 0),
            ("drops", GPT_BATCH * GPT_SEQ, 0.5, 0),
            ("scalar_path", 3 * 1024 - 5, 1.25, 203)):
        case = _moe_case(tokens, factor, seed=1, dim=dim)
        checks[name] = _moe_compare(case, (
            ("dispatch", BF16, BF16, False), ("dispatch", BF16, BF16, True),
            ("combine", BF16, BF16, True), ("combine", BF16, F32, False)))
        checks[name].update(tokens=tokens, dim=case["x"].shape[1],
                            dropped=tokens - case["kept"])
    for name, first, count, expert0, experts, *glob in \
            MOE_EP_B4_CASES + HYBRID_B4_CASES:
        case = _moe_rank_case(first, count, expert0, experts, *glob)
        checks[name] = dict(_moe_compare(case, MOE_VARIANTS), tokens=count,
                            experts=experts, first_expert=expert0,
                            capacity=case["capacity"], kept=case["kept"])
        del case
    with _moe_path("kernels", MOE_FORWARD_FAULT):
        planted = _moe_compare(path, (("combine", BF16, BF16, True),))

    e, c = MOE_EXPERTS, path["capacity"]
    x, eo = path["x"].to(BF16), path["eo"].to(BF16)
    choice, pos, gate = path["choice"], path["pos"], path["gate"]
    t, d = x.shape
    keep = pos < c
    onehot = (torch.nn.functional.one_hot(choice, e).float()[:, :, None]
              * torch.nn.functional.one_hot(pos.clamp(0, c - 1), c)
              .float()[:, None, :] * keep[:, None, None])
    dense_dispatch = onehot.to(BF16)
    dense_combine = (onehot * gate[:, None, None]).to(BF16)
    del onehot
    dense = {MOE_MAIN["dispatch"]: (
        lambda: torch.einsum("tec,td->ecd", dense_dispatch, x)),
             MOE_MAIN["combine"]: (
        lambda: torch.einsum("tec,ecd->td", dense_combine, eo))}
    cfg = dict(gpt.BASE_CONFIG, moe_experts=MOE_EXPERTS, moe_every=2)
    per_step = moe_variant_launches(cfg, remat=True)
    timing = {}
    for variant, _, _ in MOE_STEP_VARIANTS:
        name = moe_variant(*variant)
        bound, by, nbytes = moe_bound(*variant, path, rate)
        args = _moe_args(*variant, path)
        launch, plain = _moe_fns(variant[0])
        library = _moe_library(*variant, path)
        got = launch(*args)
        lib_err = (library()[:got.shape[0] * got.shape[1]].view_as(got)
                   .float() - got.float()).abs().max().item()
        ms = device_ms(lambda: launch(*args))
        row = {"kernel_ms": ms, "plain_ms": device_ms(lambda: plain(*args)),
               "library_ms": device_ms(library),
               "library_max_abs_err": lib_err,
               "copy_ms": device_ms(_moe_copy(variant[0], variant[1],
                                              variant[2], path)),
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "gb_per_s": nbytes / ms / 1e6, "share_of_bound": bound / ms,
               "launches_per_step": per_step[name]}
        if name in dense:
            row["dense_einsum_ms"] = device_ms(dense[name], reps=5)
        timing[name] = row
    return {"shape": {"T": t, "D": d, "E": e, "C": c, "kept": path["kept"]},
            "checks": checks, "planted": {MOE_FORWARD_FAULT: planted},
            "timing": timing, "tolerance": MOE_TOL,
            "b4_kernel_ms_per_gpt_moe_step": sum(
                r["kernel_ms"] * r["launches_per_step"]
                for r in timing.values()),
            "library": {
                "dispatch": "zero_() + index_copy_ into [E*C+1, D] (after "
                            "torch.mul by the scale, out= the output type, "
                            "where scaled)",
                "combine": "index_select of [E*C, D] rows, then torch.mul "
                           "by the gate (1 ungated; 0 for dropped tokens), "
                           "out= the output type"}}


def _moe_failures(m: dict) -> list:
    problems = []
    for case, results in m["checks"].items():
        want_path = "scalar" if case == "scalar_path" else "vector"
        for name, r in results.items():
            if not isinstance(r, dict):
                continue
            if not r["bitwise"]:
                problems.append("%s at %s off by %g (stated tolerance: "
                                "bitwise)" % (name, case, r["max_abs_err"]))
            if not r.get("dropped_rows_zero", True):
                problems.append("%s at %s: a dropped row is not zero"
                                % (name, case))
            if r["paths"] != ["%s_%s" % (name.split()[0], want_path)]:
                problems.append("%s at %s took the path(s) %r, not the %s "
                                "path" % (name, case, r["paths"], want_path))
    if not m["checks"]["drops"]["dropped"]:
        problems.append("capacity factor 0.5 dropped no token")
    if any(r["bitwise"] for r in m["planted"][MOE_FORWARD_FAULT].values()):
        problems.append("the kernel check passes planted fault %s"
                        % MOE_FORWARD_FAULT)
    return problems


# ---------------------------------------------------------------------------
# train_gpt_moe: GPT-2 small with 8-expert switch FFNs (examples/train_gpt)
# ---------------------------------------------------------------------------

#: |loss(kernels) - loss(dense)| / loss allowed at every step of the 10.
#: The dense formulation rounds gate x dispatch to bf16 and the kernels
#: keep the gate in fp32; near-tied tokens then route apart in the deep
#: layers, and as the routers collapse onto few experts the capacity drops
#: part further. On an H100 the two parted by 3.7e-3 by step 10, and the
#: planted faults by only 5.1e-3 and 3.9e-3: this gate holds the two
#: formulations together, the plain run below catches faults
GPT_MOE_LOSS_RTOL = 1e-2
#: step 0's gradients, kernels against the dense formulation: the largest
#: ||g - g_dense|| / ||g_dense|| over the parameter leaves. On an H100:
#: 0.127 sound (an expert wi of layer 10: each expert's gradient sums its
#: tokens' nearly random contributions, and 207 of the 16,384 tokens,
#: 1.3 %, take another expert there, as routing_step_0 counts), 1.24 and
#: 0.97 under the planted faults
GPT_MOE_GRAD_RTOL = 0.3
#: steps of each planted-fault run (on the 10-step schedule)
MOE_PLANTED_STEPS = 5


def _moe_env(steps: int = MOE_STEPS) -> dict:
    return dict(_gpt_env(steps), TPUJOB_MOE_EXPERTS=str(MOE_EXPERTS))


def moe_layers(cfg: dict) -> int:
    """The MoE layers of a GPT or BERT config (``li % moe_every == 0``)."""
    return sum(1 for li in range(cfg["layers"])
               if cfg["moe_experts"] and li % cfg["moe_every"] == 0)


def moe_variant_launches(cfg: dict, remat: bool) -> dict:
    """B4 launches of one bf16 train step by variant, from the code
    (MOE_STEP_VARIANTS): per MoE layer the forward dispatches and combines
    with the gate once (twice under remat, which recomputes it); the
    backward dispatches combine's cotangent scaled by the gate once and
    combines ungated twice (dispatch's cotangent; the gate's rows in
    fp32)."""
    layers = moe_layers(cfg)
    forwards = 2 if remat else 1
    return {moe_variant(*v): layers * (forwards * f + b)
            for v, f, b in MOE_STEP_VARIANTS}


def moe_launches_per_step(cfg: dict, remat: bool) -> dict:
    """B4a/B4b launches of one train step: the sums of
    :func:`moe_variant_launches` by kernel."""
    by_variant = moe_variant_launches(cfg, remat)
    return {k: sum(n for name, n in by_variant.items() if name.startswith(k))
            for k in ("dispatch", "combine")}


def _gpt_moe_run(path: str, ckpt_dir: str, make_batch=None,
                 every: int = MOE_SAVE_AT, fault: str = "",
                 total: int = MOE_STEPS):
    """examples/train_gpt.py's job with TPUJOB_MOE_EXPERTS (a MOE_STEPS
    schedule), ``total`` steps of it, on MoE ``path``; also the B4
    launches of the run, by kernel and by the kernels' path."""
    launches = _zero(moe.moe_apply_fused.launches)
    paths = _zero(moe.moe_apply_fused.path_launches)
    job = dataclasses.replace(train_gpt.make_job(_moe_env()),
                              total_steps=total)
    with _moe_path(path, fault):
        rec, out, wall = _recorded_run(job, ckpt_dir, make_batch, every)
    return rec, out, wall, dict(launches), dict(paths)


def _off_vector_path(launches: dict, paths: dict) -> bool:
    """Whether a B4 launch of a run took another than the 16-byte path."""
    return paths != {"%s_%s" % (k, p): n if p == "vector" else 0
                     for k, n in launches.items()
                     for p in ("vector", "scalar")}


def phase_train_gpt_moe(smi: str) -> dict:
    """GPT-2 small with a switch-MoE FFN of 8 experts on every second
    layer (examples/train_gpt.py with TPUJOB_MOE_EXPERTS=8: batch 16 x
    1024, bf16 on fp32 params, adamw + cosine(3e-4) over 10 steps, wd 0.1,
    grad clip 1.0, remat, ce_chunk 1024), deterministic algorithms on.
    First step 0's gradients on the kernels against the dense formulation
    and against the plain versions run on the card, sound and under each
    planted fault, with the tokens of each MoE layer that the sound run
    routes apart from each reference (and remat's recompute against its
    forward); then
    (a) 10 steps on the kernels, checkpoints at steps 5 and 10;
    (p) the same 10 steps with the plain versions on the card;
    (b) the same 10 steps dense;
    (c) (a) resumed from its step-5 checkpoint (saving nothing);
    (d) 5 steps of (a) under each planted fault;
    then 10 steps on one fixed batch and a profiled window. The kernels
    are bitwise equal to their plain versions and the algorithms are
    deterministic, so (a), (p) and (c) must agree bit for bit.

    The step-cost rung across the MoE paths (``TPUJOB_COMPILE_CACHE_DIR``
    names an empty directory for (a) to (c)): (p) and (b) run (a)'s job
    with other launchers and with TPUJOB_MOE_FUSED=0, which the step's
    key holds, so each counts its own first step; (c) resumes (a)'s step
    and reads its cost, flops_per_step bit for bit (a)'s."""
    cfg = dict(gpt.BASE_CONFIG, moe_experts=MOE_EXPERTS, moe_every=2)
    per_step = moe_launches_per_step(cfg, remat=True)
    with _deterministic(), tempfile.TemporaryDirectory(
            prefix="chip_smoke_moe_") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in "ac"}
        routes = {p: [] for p in MOE_PATHS}
        variants = {"sound": ("auto", functools.partial(
            _routes_logged, routes["kernels"], "kernels"))}
        for fault in PLANTED_MOE:
            variants[fault] = ("auto", functools.partial(
                _moe_path, "kernels", fault))
        grad_check = _grad_check(
            _moe_env(), {p: ("auto", functools.partial(_routes_logged,
                                                       routes[p], p))
                         for p in ("dense", "plain")}, variants)
        routing = {ref: _routing_parts(routes["kernels"], routes[ref],
                                       moe_layers(cfg))
                   for ref in ("dense", "plain")}
        del routes
        torch.cuda.reset_peak_memory_stats()
        with _environ(TPUJOB_COMPILE_CACHE_DIR=os.path.join(tmp, "cost")):
            rec_a, out_a, wall_a, launches_a, paths_a = _gpt_moe_run(
                "kernels", dirs["a"])
            peak_a = torch.cuda.max_memory_allocated()
            rec_p, out_p, _, launches_p, _ = _gpt_moe_run("plain", "")
            torch.cuda.reset_peak_memory_stats()
            rec_b, out_b, wall_b, launches_b, _ = _gpt_moe_run("dense", "")
            peak_b = torch.cuda.max_memory_allocated()
            saved = "step_%012d" % MOE_SAVE_AT
            os.makedirs(dirs["c"])
            shutil.copytree(os.path.join(dirs["a"], saved),
                            os.path.join(dirs["c"], saved),
                            copy_function=os.link)
            rec_c, out_c, _, launches_c, paths_c = _gpt_moe_run(
                "kernels", dirs["c"], every=10 * MOE_STEPS)
        planted_losses = {
            fault: _gpt_moe_run("kernels", "", fault=fault,
                                total=MOE_PLANTED_STEPS)[0].host_losses()
            for fault in PLANTED_MOE}
        fixed = gpt.synthetic_batch(
            torch.Generator(device=DEVICE).manual_seed(1), GPT_BATCH,
            GPT_SEQ, cfg["vocab_size"])
        rec_f = _gpt_moe_run("kernels", "",
                             make_batch=lambda gen, step: fixed,
                             every=10 * MOE_STEPS)[0]
        with _moe_path("kernels"):
            profile_out = _gpt_profile(
                _moe_env(), FLASH_PROFILE_NAMES + MOE_PROFILE_NAMES)
    la, lp, lb, lc, lf = (r.host_losses()
                          for r in (rec_a, rec_p, rec_b, rec_c, rec_f))
    aux = torch.stack(rec_a.moe_aux).cpu().tolist()

    def max_rel(losses, ref) -> float:
        """The largest |loss - ref| / ref over the steps both have."""
        return max(abs(x - y) / abs(y) for x, y in zip(losses, ref))

    # steps 2-4, forward to forward: after the first step's warm-up and
    # before the step-5 save; steps 6-9 carry the writer
    fused_ms, dense_ms = (rec_a.forward_gaps_ms(2, 4),
                          rec_b.forward_gaps_ms(2, 4))
    median_s = statistics.median(fused_ms) / 1e3
    busy_ms = profile_out["device_busy_ms_per_step"]
    kernel_ms = profile_out["kernel_ms_per_step"]
    model_flops = profile_out["unreported_flops_per_step"] + \
        _attention_flops(cfg)
    expected = {k: n * MOE_STEPS for k, n in per_step.items()}
    runs = {"kernels": out_a, "plain": out_p, "dense": out_b,
            "resumed": out_c}
    step_cost = {k: r["compile_cache"]["step_cost"] for k, r in runs.items()}
    flops = {k: r["hardware"]["flops_per_step"] for k, r in runs.items()}
    out = {
        "phase": "train_gpt_moe", "card": smi,
        "config": {"model": "gpt BASE_CONFIG + moe_experts=8, moe_every=2",
                   "batch": GPT_BATCH, "seq": GPT_SEQ, "steps": MOE_STEPS,
                   "compute": "bf16", "params": "fp32",
                   "optimizer": "adamw cosine(3e-4)", "remat": True,
                   "ce_chunk": 1024, "capacity_factor": 1.25,
                   "deterministic_algorithms": True},
        "losses": {"kernels": la, "plain": lp, "dense": lb,
                   "resumed_from_5": lc, "fixed_batch": lf,
                   "planted": planted_losses},
        "moe_aux_per_step": aux,
        "max_abs_loss_diff_kernels_vs_plain": max(
            abs(x - y) for x, y in zip(la, lp)),
        "max_rel_loss_diff_kernels_vs_dense": max_rel(la, lb),
        "grad_check_step_0": grad_check,
        "routing_step_0": dict(routing, tokens=GPT_BATCH * GPT_SEQ),
        "planted": {f: {"max_rel_loss_diff_vs_plain": max_rel(
                            planted_losses[f], lp),
                        "max_rel_loss_diff_vs_dense": max_rel(
                            planted_losses[f], lb)}
                    for f in PLANTED_MOE},
        "tolerance": {"kernels_vs_plain": "bitwise",
                      "loss_rtol_vs_dense": GPT_MOE_LOSS_RTOL,
                      "grad_rtol_vs_dense": GPT_MOE_GRAD_RTOL},
        "max_abs_loss_diff_resumed": max(
            abs(x - y) for x, y in zip(la[MOE_SAVE_AT:], lc)),
        "launches": {"kernels": launches_a, "plain": launches_p,
                     "dense": launches_b, "resumed": launches_c,
                     "expected_kernels": expected, "per_step": per_step,
                     "by_variant_per_step": moe_variant_launches(
                         cfg, remat=True)},
        "path_launches": {"kernels": paths_a, "resumed": paths_c},
        "resume_steps": out_c.get("resume_steps"),
        "step_cost": step_cost, "flops_per_step": flops,
        "step_ms_steps_2_4": {"kernels": fused_ms, "dense": dense_ms},
        "step_ms_median": 1e3 * median_s,
        "dense_step_ms_median": statistics.median(dense_ms),
        "step_ms_steps_6_9": {"kernels": rec_a.forward_gaps_ms(6, 9),
                              "dense": rec_b.forward_gaps_ms(6, 9)},
        "tokens_per_s": GPT_BATCH * GPT_SEQ / median_s,
        "optimizer_ms_per_step": statistics.mean(
            a.elapsed_time(b) for a, b in rec_a.updates[1:4]),
        "wall_s": {"kernels": wall_a, "dense": wall_b},
        "peak_gb": {"kernels": peak_a / 1e9, "dense": peak_b / 1e9},
        "host_stages_kernels": out_a["host_stages"],
        "profile": profile_out,
        "idle_share_steps_2_4": 1.0 - busy_ms / (1e3 * median_s),
        "moe_kernel_ms_per_step": {k: kernel_ms[k]
                                   for k in MOE_PROFILE_NAMES},
        "b4_ms_per_step": sum(kernel_ms[k] for k in MOE_PROFILE_NAMES),
        "model_flops_per_step": model_flops,
        "mfu_bf16": model_flops / median_s / BF16_FLOPS,
    }
    emit(out)
    problems = []
    if out["max_abs_loss_diff_kernels_vs_plain"] != 0.0:
        problems.append("the kernel run and the plain run part by %g "
                        "(stated tolerance: bitwise)"
                        % out["max_abs_loss_diff_kernels_vs_plain"])
    for fault in PLANTED_MOE:
        if planted_losses[fault] == lp[:MOE_PLANTED_STEPS]:
            problems.append("the loss gate passes planted fault %s" % fault)
    if not out["max_rel_loss_diff_kernels_vs_dense"] <= GPT_MOE_LOSS_RTOL:
        problems.append("kernel and dense losses part by %g relative > %g"
                        % (out["max_rel_loss_diff_kernels_vs_dense"],
                           GPT_MOE_LOSS_RTOL))
    sound = grad_check["plain"]["sound"]
    if sound["max_rel_diff"] != 0.0:
        problems.append("step-0 gradients of the kernels and of the plain "
                        "versions part by %g relative at %s (stated "
                        "tolerance: bitwise)" % (sound["max_rel_diff"],
                                                 sound["leaf"]))
    sound = grad_check["dense"]["sound"]
    if not sound["max_rel_diff"] <= GPT_MOE_GRAD_RTOL:
        problems.append("step-0 gradients of the kernels and the dense "
                        "formulation part by %g relative > %g at %s"
                        % (sound["max_rel_diff"], GPT_MOE_GRAD_RTOL,
                           sound["leaf"]))
    for fault in PLANTED_MOE:
        for ref in ("dense", "plain"):
            if not grad_check[ref][fault]["max_rel_diff"] > GPT_MOE_GRAD_RTOL:
                problems.append("the gradient gate against %s passes "
                                "planted fault %s" % (ref, fault))
    if any(routing["plain"]["tokens_apart"]):
        problems.append("the kernels and the plain versions route %r "
                        "tokens apart at step 0"
                        % routing["plain"]["tokens_apart"])
    if routing["dense"]["tokens_apart"][0]:
        problems.append("the first MoE layer routes %d tokens apart under "
                        "dense and kernels, from the same input"
                        % routing["dense"]["tokens_apart"][0])
    if not all(r["recompute_equal"] for r in routing.values()):
        problems.append("remat's recompute routed a token otherwise than "
                        "its forward")
    if (len(lc) != MOE_STEPS - MOE_SAVE_AT
            or out["max_abs_loss_diff_resumed"] != 0.0):
        problems.append("the resumed run does not reproduce steps %d-%d "
                        "bitwise (%d losses, off by %g)"
                        % (MOE_SAVE_AT + 1, MOE_STEPS, len(lc),
                           out["max_abs_loss_diff_resumed"]))
    if out_c.get("resume_steps") != [MOE_SAVE_AT]:
        problems.append("the resumed run restored %r, not step %d"
                        % (out_c.get("resume_steps"), MOE_SAVE_AT))
    if step_cost != {"kernels": ["counted"], "plain": ["counted"],
                     "dense": ["counted"], "resumed": ["cache"]} \
            or flops["resumed"] != flops["kernels"]:
        problems.append("the step costs came from %r with flops_per_step "
                        "%r (expected the plain and dense runs counted, "
                        "the resumed run (a)'s from the cache)"
                        % (step_cost, flops))
    if launches_a != expected:
        problems.append("MoE launches %r, expected %r"
                        % (launches_a, expected))
    if any(launches_b.values()) or any(launches_p.values()):
        problems.append("the dense or plain run launched %r, %r"
                        % (launches_b, launches_p))
    if launches_c != {k: n * (MOE_STEPS - MOE_SAVE_AT)
                      for k, n in per_step.items()}:
        problems.append("the resumed run launched %r, expected %r per step"
                        % (launches_c, per_step))
    for run, launches, paths in (("kernel", launches_a, paths_a),
                                 ("resumed", launches_c, paths_c)):
        if _off_vector_path(launches, paths):
            problems.append("a B4 launch of the %s run left the 16-byte "
                            "path: %r" % (run, paths))
    if len(la) != MOE_STEPS or len(lb) != MOE_STEPS or \
            out_a["steps"] != MOE_STEPS:
        problems.append("runs did not take %d steps" % MOE_STEPS)
    if not all(np.isfinite(x) for x in la + lp + lb + lc + lf):
        problems.append("a loss is not finite")
    if not all(np.isfinite(x) and x > 0 for x in aux):
        problems.append("the MoE aux loss is not finite and positive: %r"
                        % aux)
    if not lf[-1] < lf[0]:
        problems.append("%d steps on one batch did not lower the loss "
                        "(%g -> %g)" % (MOE_STEPS, lf[0], lf[-1]))
    if problems:
        fail("train_gpt_moe: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# train_bert: BERT-base (examples/train_bert) and BERT-base-MoE
# ---------------------------------------------------------------------------

#: |loss(kernels) - loss(dense)| / loss allowed at every step of the
#: BERT-base-MoE runs: the GPT-MoE runs' gate, for the same reason; a
#: faulty kernel is caught by the run on the plain versions, which must
#: agree with the kernel run bit for bit
BERT_MOE_LOSS_RTOL = GPT_MOE_LOSS_RTOL


def _bert_moe_job() -> TrainJob:
    """BERT-base with 8 experts on every second layer at the JAX bench's
    setup (bench.py ``_moe_bench``): batch 16 x 512, ``adamw(1e-4,
    wd_mask=make_wd_mask(params))``, grad clip 1.0, ``bert.loss_fn``'s
    defaults (no remat, bf16)."""
    cfg = dict(bert.BASE_CONFIG, moe_experts=MOE_EXPERTS, moe_every=2)
    mask = optim.make_wd_mask(bert.init(
        torch.Generator(device=DEVICE).manual_seed(0), cfg))
    return TrainJob(
        init_params=lambda gen: bert.init(gen, cfg), loss_fn=bert.loss_fn,
        optimizer=optim.adamw(1e-4, wd_mask=mask),
        make_batch=lambda gen, step: bert.synthetic_batch(
            gen, BERT_MOE_BATCH, BERT_SEQ, cfg["vocab_size"]),
        grad_clip=1.0, total_steps=BERT_MOE_STEPS)


def phase_train_bert(smi: str) -> dict:
    """BERT-base through examples/train_bert.py's job (batch 64 x 512, bf16
    on fp32 params, adamw + cosine(1e-4), wd 0.01, grad clip 1.0, remat;
    the einsum attention: no kernel): BERT_STEPS steps and
    BERT_FIXED_STEPS on one fixed batch, and a profiled window. Then
    BERT-base-MoE at the JAX bench's setup for BERT_MOE_STEPS steps on
    the kernels, on their plain versions run on the card (losses bitwise
    equal to the kernels') and on the dense formulation, and a profiled
    window on the kernels. Deterministic algorithms on."""
    env = {"TPUJOB_BATCH": str(BERT_BATCH), "TPUJOB_SEQ": str(BERT_SEQ),
           "TPUJOB_STEPS": str(BERT_STEPS)}
    cfg = dict(bert.BASE_CONFIG, moe_experts=MOE_EXPERTS, moe_every=2)
    per_step = moe_launches_per_step(cfg, remat=False)
    with _deterministic():
        torch.cuda.reset_peak_memory_stats()
        rec_d, _, wall_d = _recorded_run(train_bert.make_job(env), "")
        peak_d = torch.cuda.max_memory_allocated()
        fixed = bert.synthetic_batch(
            torch.Generator(device=DEVICE).manual_seed(1), BERT_BATCH,
            BERT_SEQ, bert.BASE_CONFIG["vocab_size"])
        rec_f, _, _ = _recorded_run(
            train_bert.make_job(dict(env, TPUJOB_STEPS=str(BERT_FIXED_STEPS))),
            "", make_batch=lambda gen, step: fixed)
        job = train_bert.make_job(env)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        profile_out = _step_profile(job, job.init_params(gen), fixed,
                                    warm=1, steps=2)
        moe_job = _bert_moe_job()
        moe_runs = {}
        for path in MOE_PATHS:
            launches = _zero(moe.moe_apply_fused.launches)
            paths = _zero(moe.moe_apply_fused.path_launches)
            torch.cuda.reset_peak_memory_stats()
            with _moe_path(path):
                rec, _, wall = _recorded_run(moe_job, "")
            moe_runs[path] = {
                "rec": rec, "wall_s": wall, "launches": dict(launches),
                "paths": dict(paths),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        with _moe_path("kernels"):
            moe_profile = _step_profile(moe_job, moe_job.init_params(gen),
                                        moe_job.make_batch(gen, 0),
                                        MOE_PROFILE_NAMES, warm=2, steps=3)
    ld, lf = rec_d.host_losses(), rec_f.host_losses()
    base_ms = rec_d.forward_gaps_ms(2, BERT_STEPS - 1)
    lm = {k: r["rec"].host_losses() for k, r in moe_runs.items()}
    moe_ms = {k: r["rec"].forward_gaps_ms(2, BERT_MOE_STEPS - 1)
              for k, r in moe_runs.items()}
    max_rel = max(abs(x - y) / abs(y) for x, y in zip(lm["kernels"],
                                                      lm["dense"]))
    plain_diff = max(abs(x - y) for x, y in zip(lm["kernels"], lm["plain"]))
    expected = {k: n * BERT_MOE_STEPS for k, n in per_step.items()}
    median_ms = statistics.median(base_ms)
    out = {
        "phase": "train_bert", "card": smi,
        "bert_base": {
            "config": {"model": "bert BASE_CONFIG", "batch": BERT_BATCH,
                       "seq": BERT_SEQ, "steps": BERT_STEPS,
                       "compute": "bf16", "params": "fp32",
                       "optimizer": "adamw cosine(1e-4)", "remat": True,
                       "attention": "einsum (masked)"},
            "losses": ld, "fixed_batch_losses": lf,
            "step_ms": base_ms, "step_ms_median": median_ms,
            "tokens_per_s": BERT_BATCH * BERT_SEQ / median_ms * 1e3,
            "wall_s": wall_d, "peak_gb": peak_d / 1e9,
            "profile": profile_out,
            "idle_share": 1.0 - profile_out["device_busy_ms_per_step"]
            / median_ms},
        "bert_base_moe": {
            "config": {"model": "bert BASE_CONFIG + moe_experts=8, "
                                "moe_every=2", "batch": BERT_MOE_BATCH,
                       "seq": BERT_SEQ, "steps": BERT_MOE_STEPS,
                       "optimizer": "adamw(1e-4, wd_mask)", "remat": False},
            "losses": lm, "max_rel_loss_diff_kernels_vs_dense": max_rel,
            "max_abs_loss_diff_kernels_vs_plain": plain_diff,
            "tolerance": {"kernels_vs_plain": "bitwise",
                          "loss_rtol_vs_dense": BERT_MOE_LOSS_RTOL},
            "moe_aux_per_step": torch.stack(
                moe_runs["kernels"]["rec"].moe_aux).cpu().tolist(),
            "step_ms": moe_ms,
            "step_ms_median": {k: statistics.median(v)
                               for k, v in moe_ms.items()},
            "launches": {k: r["launches"] for k, r in moe_runs.items()},
            "path_launches": moe_runs["kernels"]["paths"],
            "profile": moe_profile,
            "b4_ms_per_step": sum(moe_profile["kernel_ms_per_step"].values()),
            "idle_share_kernels": 1.0 - moe_profile[
                "device_busy_ms_per_step"] / statistics.median(
                    moe_ms["kernels"]),
            "expected_kernels": expected, "per_step": per_step,
            "peak_gb": {k: r["peak_gb"] for k, r in moe_runs.items()},
            "wall_s": {k: r["wall_s"] for k, r in moe_runs.items()}},
    }
    emit(out)
    problems = []
    if not all(np.isfinite(x) for x in ld + lf + sum(lm.values(), [])):
        problems.append("a loss is not finite")
    if len(ld) != BERT_STEPS or any(len(v) != BERT_MOE_STEPS
                                    for v in lm.values()):
        problems.append("runs did not take their steps")
    if not lf[-1] < lf[0]:
        problems.append("%d steps on one batch did not lower the loss "
                        "(%g -> %g)" % (BERT_FIXED_STEPS, lf[0], lf[-1]))
    if plain_diff != 0.0:
        problems.append("the BERT-MoE kernel run and the plain run part by "
                        "%g (stated tolerance: bitwise)" % plain_diff)
    if not max_rel <= BERT_MOE_LOSS_RTOL:
        problems.append("BERT-MoE kernel and dense losses part by %g "
                        "relative > %g" % (max_rel, BERT_MOE_LOSS_RTOL))
    if moe_runs["kernels"]["launches"] != expected:
        problems.append("BERT-MoE launches %r, expected %r"
                        % (moe_runs["kernels"]["launches"], expected))
    if _off_vector_path(moe_runs["kernels"]["launches"],
                        moe_runs["kernels"]["paths"]):
        problems.append("a B4 launch of the BERT-MoE kernel run left the "
                        "16-byte path: %r" % moe_runs["kernels"]["paths"])
    for path in ("plain", "dense"):
        if any(moe_runs[path]["launches"].values()):
            problems.append("the %s BERT-MoE run launched %r"
                            % (path, moe_runs[path]["launches"]))
    if problems:
        fail("train_bert: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# train_dp: data parallelism, over NCCL at world 1 and two gloo workers
# ---------------------------------------------------------------------------

#: kernels NCCL launches for a collective, matched by substring: at world
#: 1 an AVG all-reduce is NCCL's one-rank kernel (``oneRankReduce``; a SUM,
#: a MAX or a broadcast launches nothing there), above it ``ncclDevKernel``
NCCL_KERNEL_MARKS = ("oneRankReduce", "ncclDevKernel", "ncclKernel")
#: the two-worker runs: ResNet-50 steps, GPT-2 small's layers and steps
DP_RESNET_STEPS, DP_GPT_LAYERS, DP_GPT_STEPS = 5, dp_check.GPT_LAYERS, 3
#: |loss(two workers) - loss(one process)| / loss allowed at each step.
#: The two runs differ in rounding only: each worker convolves and
#: multiplies its own block in bf16, and BatchNorm averages two halves'
#: means. On an H100 80GB HBM3 at 700 W, ResNet-50 parted by 1.2e-3 at
#: step 1 and 1.4e-3 at most over 5 steps, GPT-2 by 6.2e-7 over 3 (GPT's
#: bound is train_gpt's loss class); rank 1 keeping its local gradients
#: parted ResNet-50 by 1.0e-2
DP_RESNET_RTOL = 5e-3
DP_GPT_RTOL = 2e-5


def _dp_collectives_per_step(params) -> dict:
    """The collectives of one dp step, from the code: one mean a gradient
    bucket (``collectives.bucket_plan`` over the leaves that get a
    gradient: every parameter but BatchNorm's running stats), two a
    BatchNorm layer (its statistics forward, their cotangent backward)
    and one for the loss and metrics."""
    flat = bridge.flatten(params)
    grads = [t for k, t in flat.items()
             if not k.endswith(("/mean", "/var"))]
    bn = sum(1 for k in flat if k.endswith("/mean"))
    buckets = len(collectives.bucket_plan(grads))
    return {"grad_buckets": buckets, "bn_layers": bn, "metrics": 1,
            "total": buckets + 2 * bn + 1}


def _nccl_profile(mesh, warm: int = 2, steps: int = 5) -> dict:
    """torch.profiler over ``steps`` dp train steps (fused_sgd, one fixed
    batch) on ``mesh``: NCCL kernels a step, their device ms, and the
    device busy ms a step (union of kernel intervals). To place a kernel
    the count misses: the NCCL kernels between B1 launches (a step ends
    with B1 and then the metrics mean, so a sound window reads
    ``[total - 1, total, ..., total, 1]``) and the host's ``nccl:*``
    records of the collectives it issued."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    batch = resnet.synthetic_batch(gen, BATCH, IMAGE, CLASSES)
    params = resnet.init(gen, DEPTH, CLASSES)
    expected = _dp_collectives_per_step(params)
    step_fn, state = build_train_step(
        resnet.loss_fn, resnet_optimizer("fused_sgd", 30), params, batch,
        mesh=mesh, merge_stats=resnet.merge_stats)
    del params
    for _ in range(warm):
        step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step_fn(state, batch)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("nccl:"))
    busy, end, nccl_n, nccl_us = 0.0, float("-inf"), 0, 0.0
    between_b1 = [0]
    for lo, hi, name in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        if any(mark in name for mark in NCCL_KERNEL_MARKS):
            nccl_n += 1
            nccl_us += hi - lo
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
            "nccl_kernel_names": sorted({n[:90] for _, _, n in spans
                                         if any(m in n for m in
                                                NCCL_KERNEL_MARKS)}),
            "nccl_ms_per_step": nccl_us / 1e3 / steps,
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "allreduce_share_of_busy": nccl_us / busy if busy else None}


def _nccl_window_child() -> dict:
    """:func:`_nccl_profile` at world 1 over NCCL, in the process it runs
    in, with the settings ``main`` and phase train_dp give the card."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group(
        "nccl", init_method="tcp://localhost:%d" % dp_check.free_port(),
        world_size=1, rank=0)
    try:
        return _nccl_profile(make_mesh({"dp": 1}))
    finally:
        dist.destroy_process_group()


def _nccl_window() -> dict:
    """:func:`_nccl_profile` in a fresh process (spawned, stopped before
    this returns). A process that has run long or profiled often loses a
    kernel record of a window's first step now and then (560 host
    records, 559 kernels); a fresh one lost none in its first 16 windows
    (PERF.md §6; ``scripts/nccl_window_loss.py``)."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_nccl_window_child)


def _dp_workers(out: str) -> dict:
    """Two workers through ``python -m paddle_operator_tpu_torch.launch``
    on this one card, over gloo: ResNet-50 sound and with rank 1 keeping
    its local gradients, GPT-2 small at DP_GPT_LAYERS layers, and an NCCL
    group over the two (refused). Returns each scenario's lines by
    rank."""
    scenarios = [
        {"kind": "run", "name": "resnet50", "model": "resnet50",
         "steps": DP_RESNET_STEPS},
        {"kind": "run", "name": "resnet50_skip_grad_allreduce",
         "model": "resnet50", "steps": DP_RESNET_STEPS,
         "fault": "skip_grad_allreduce"},
        {"kind": "run", "name": "gpt", "model": "gpt2_2layers",
         "steps": DP_GPT_STEPS},
        {"kind": "nccl_pair", "name": "nccl_pair"}]
    torch.cuda.empty_cache()
    lines = dp_check.launch_workers({"out": out, "scenarios": scenarios},
                                    world=2, backend="gloo", timeout=600)
    by_name: dict = {}
    for rank_lines in lines:
        for line in rank_lines:
            by_name.setdefault(line["scenario"], []).append(line)
    return {k: sorted(v, key=lambda r: r["rank"]) for k, v in by_name.items()}


def _rel_diffs(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _dp_summary(rs: list, single: dict, shards: int = 1) -> dict:
    """The workers' run ``rs`` (one line a rank) against one process's.
    A worker's loss_fn sees its block's loss; the global batch's is their
    mean (equal blocks), times ``shards`` under a sequence split (a
    rank's loss is its sequence block's part of its replica's)."""
    losses = [statistics.fmean(step) * shards
              for step in zip(*(r["losses"] for r in rs))]
    return {
        "mesh_history": [r["mesh_history"] for r in rs],
        "losses": losses,
        "rank_losses": [r["losses"] for r in rs],
        "one_process_losses": single["losses"],
        "max_rel_loss_diff_vs_one_process": _rel_diffs(
            losses, single["losses"]),
        "replicas_equal_after_each_step": len(rs) > 1 and all(
            r["fingerprints"] == rs[0]["fingerprints"]
            and r["final_digest"] == rs[0]["final_digest"] for r in rs),
        "steps_fingerprinted": [len(r["fingerprints"]) for r in rs],
        "launches": [r["launches"] for r in rs],
        "step_ms": [r["step_ms"] for r in rs],
        "one_process_step_ms": single["step_ms"],
        "wall_s": [r["wall_s"] for r in rs]}


def _dp_problems(runs: dict) -> list:
    """The gates of the two workers' runs (:func:`_dp_summary` by name):
    {"dp": 2} meshes, equal replicas, losses within their bounds, B1 once
    a step and flash 2 / 1 / 1 a layer a step on every rank, finite
    losses; and the planted fault must break replica identity."""
    per_gpt_step = {"fwd": 2 * DP_GPT_LAYERS, "dq": DP_GPT_LAYERS,
                    "dkv": DP_GPT_LAYERS}
    problems = []
    for name, tol, steps, launches in (
            ("resnet50", DP_RESNET_RTOL, DP_RESNET_STEPS,
             {"fused_sgd": DP_RESNET_STEPS}),
            ("gpt", DP_GPT_RTOL, DP_GPT_STEPS,
             {"flash_" + k: v * DP_GPT_STEPS
              for k, v in per_gpt_step.items()})):
        run = runs[name]
        if run["mesh_history"] != [[{"dp": 2}]] * 2:
            problems.append("%s workers had meshes %r"
                            % (name, run["mesh_history"]))
        if not run["replicas_equal_after_each_step"] \
                or run["steps_fingerprinted"] != [steps] * 2:
            problems.append("%s replicas differ after a step" % name)
        if not run["max_rel_loss_diff_vs_one_process"] <= tol:
            problems.append("%s losses part from one process's by %g"
                            % (name, run["max_rel_loss_diff_vs_one_process"]))
        for r in run["launches"]:
            if any(r[k] != v for k, v in launches.items()):
                problems.append("%s launches %r, expected %r"
                                % (name, r, launches))
        if len(run["losses"]) != steps \
                or not all(np.isfinite(x) for x in run["losses"]):
            problems.append("%s: a loss is missing or not finite" % name)
    if runs["resnet50_skip_grad_allreduce"][
            "replicas_equal_after_each_step"]:
        problems.append("the replica gate missed rank 1 keeping its local "
                        "gradients")
    return problems


def phase_train_dp(smi: str, train_losses: list) -> dict:
    """Data-parallel training through the port's DP path (a dp mesh, the
    gradient and metric means, sync BatchNorm, per-rank batch blocks):

    (a) a process group of one over NCCL and ``mesh_axes={"dp": 1}``:
        ResNet-50 as phase_train's ``fused_sgd`` run (224x224, batch 128,
        30 steps), whose losses must equal that run's bit for bit (the
        world-1 means scale by 1.0, and NCCL's one-rank kernel is a copy
        times 1); a profile, taken in a fresh process
        (:func:`_nccl_window`), counts the NCCL kernels a step against
        :func:`_dp_collectives_per_step`; B1 launches 30 times;
    (b) two workers on this card (gloo; NCCL refuses two ranks on one
        device: its words are printed), started as the operator starts
        them, ResNet-50 at global batch 128 for DP_RESNET_STEPS steps:
        after every step both ranks' parameters (BatchNorm's running
        stats included) must be equal bit for bit (by a fingerprint of
        their bits, and by sha256 of the whole final state), the
        losses (the mean of the ranks' block losses) within
        DP_RESNET_RTOL of one process's run of the same steps, B1
        launched once a step on each rank; the planted fault (rank 1
        keeps its local gradients) must break the replica gate;
    (c) GPT-2 small cut to DP_GPT_LAYERS layers (full width, 16 x 1024)
        the same way for DP_GPT_STEPS steps: replicas equal, losses
        within DP_GPT_RTOL of one process, the flash launches of a rank
        a step (fwd twice a layer under remat, dq and dkv once).

    The window's process, the two workers and this process's references
    run at the same time. The two workers share one card: their step
    times are a correctness run's, not a multi-GPU rate."""
    import torch.distributed as dist

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        dist.init_process_group(
            "nccl", init_method="tcp://localhost:%d" % dp_check.free_port(),
            world_size=1, rank=0)
        try:
            optim.multi_tensor_sgd.launches = 0
            rec_a, out_a, wall_a = _train_run(
                resnet_optimizer("fused_sgd", 30), 30, "",
                mesh_axes={"dp": 1})
            launches_a = optim.multi_tensor_sgd.launches
        finally:
            dist.destroy_process_group()
        # the profiled window's fresh process and the two workers run at
        # once, while this process runs the one-process references
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            window = pool.submit(_nccl_window)
            running = pool.submit(_dp_workers, os.path.join(tmp, "workers"))
            one = {"resnet50": dp_check.card_run("resnet50",
                                                 DP_RESNET_STEPS),
                   "gpt": dp_check.card_run("gpt2_2layers", DP_GPT_STEPS)}
            nccl, workers = window.result(), running.result()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        cudnn.deterministic, cudnn.benchmark = saved
    la = rec_a.host_losses()
    marks = rec_a.starts[10:30] + [rec_a.end]
    step_ms_a = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    runs = {name: _dp_summary(workers[name], one[ref]) for name, ref in (
        ("resnet50", "resnet50"),
        ("resnet50_skip_grad_allreduce", "resnet50"), ("gpt", "gpt"))}
    resnet_dp, fault, gpt_dp = (runs["resnet50"],
                                runs["resnet50_skip_grad_allreduce"],
                                runs["gpt"])
    out = {
        "phase": "train_dp", "card": smi,
        "note": "(b) and (c) run two worker processes on this one card "
                "over gloo: a correctness check, not a multi-GPU rate",
        "nccl_world_1": {
            "losses": la, "fused_sgd_run_losses": train_losses,
            "max_abs_loss_diff_vs_fused_sgd_run": max(
                abs(x - y) for x, y in zip(la, train_losses)),
            "mesh_history": out_a["mesh_history"],
            "fused_sgd_launches": launches_a,
            "step_ms_median_steps_11_30": statistics.median(step_ms_a),
            "wall_s": wall_a, "profile": nccl},
        "two_workers_resnet50": resnet_dp,
        "planted_skip_grad_allreduce": fault,
        "two_workers_gpt2_2layers": gpt_dp,
        "nccl_two_ranks_one_card": workers.get("nccl_pair"),
        "tolerance": {"resnet_rel": DP_RESNET_RTOL, "gpt_rel": DP_GPT_RTOL},
    }
    emit(out)
    print("train_dp: median step ms (%s): NCCL world 1 %.2f (steps "
          "11-30); one process / two gloo workers sharing this card "
          "(steps 2 on), ResNet-50 %.2f / %s, GPT-2 2 layers %.2f / %s"
          % (smi, statistics.median(step_ms_a),
             statistics.median(one["resnet50"]["step_ms"][1:]),
             [statistics.median(s[1:]) for s in resnet_dp["step_ms"]],
             statistics.median(one["gpt"]["step_ms"][1:]),
             [statistics.median(s[1:]) for s in gpt_dp["step_ms"]]),
          flush=True)
    problems = []
    if la != train_losses:
        problems.append("NCCL world-1 losses differ from the fused_sgd run "
                        "by up to %g" % out["nccl_world_1"][
                            "max_abs_loss_diff_vs_fused_sgd_run"])
    if out_a["mesh_history"] != [{"dp": 1}]:
        problems.append("world-1 run had mesh %r" % out_a["mesh_history"])
    if launches_a != 30:
        problems.append("B1 launched %d times at world 1, not 30"
                        % launches_a)
    if nccl["nccl_kernels_per_step"] != nccl[
            "expected_collectives_per_step"]["total"]:
        problems.append("%.2f NCCL kernels a step, expected %d (between "
                        "B1 launches %r; %d host records)"
                        % (nccl["nccl_kernels_per_step"],
                           nccl["expected_collectives_per_step"]["total"],
                           nccl["nccl_kernels_between_b1"],
                           nccl["host_nccl_records"]))
    problems += _dp_problems(runs)
    if [r.get("ok") for r in workers.get("nccl_pair", [])] != [False,
                                                                False]:
        problems.append("NCCL did not refuse two ranks on one card: %r"
                        % workers.get("nccl_pair"))
    if problems:
        fail("train_dp: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# train_sp: sequence parallelism, four gloo workers sharing the card
# ---------------------------------------------------------------------------

#: the workers of the phase (one world for (a), (b) and (c))
SP_WORKERS = 4
#: (a) ring and Ulysses attention alone: [B, H, S, D], causal, over
#: {"sp": 4} (S/n = 1024: every ring hop runs the kernels)
SP_ATTN_SHAPE = (4, 12, 4096, 64)
#: every (case, [B, H, S, D], dtype, causal) at which this phase runs the
#: flash kernels, held against their plain versions in the kernels phase:
#: a ring hop's block, hop 0 causal and the rotated hops not, at sp 4 in
#: (a)'s two types (and (b)'s bf16), and at (c)'s dp2 x sp2 in bf16;
#: Ulysses' H/n heads over the whole sequence in (a)'s two types; one
#: process over the whole sequence, the reference of (a), (b) and (c)
SP_FLASH_CASES = tuple(
    [("ring_hop", (4, 12, 1024, 64), dtype, causal)
     for dtype in ("bfloat16", "float32") for causal in (True, False)]
    + [("ring_hop", (2, 12, 2048, 64), "bfloat16", causal)
       for causal in (True, False)]
    + [("ulysses", (4, 3, 4096, 64), dtype, True)
       for dtype in ("bfloat16", "float32")]
    + [("one_process", SP_ATTN_SHAPE, dtype, True)
       for dtype in ("bfloat16", "float32")])
#: (b) GPT-2 small at full width and depth with TPUJOB_SP=4, and (c)
#: dp2 x sp2 at 2 layers: steps of each run
SP_STEPS, SP_DPSP_STEPS = 2, 2
#: |loss(sp workers) - loss(one process)| / loss allowed at each step:
#: train_gpt's einsum-against-flash class. The runs differ in rounding
#: only: each ring hop's attention output is rounded to bf16 before the
#: fp32 merge (the one process rounds once), the matmuls run on a
#: quarter of the rows, and the loss and gradients are summed over the
#: blocks. On an H100 80GB HBM3 at 700 W the sp4 run parted by 3.1e-6
#: over gloo and 1.6e-6 over NCCL
SP_LOSS_RTOL = 2e-5


def _sp_flash_per_step(layers: int, sp: int) -> dict:
    """Flash launches of a rank a step on the sp path, from the code:
    each layer's ring runs one forward a hop (n hops), twice under remat
    (the forward and its recompute), and one dq and one dkv a hop in the
    backward."""
    return {"flash_fwd": 2 * layers * sp, "flash_dq": layers * sp,
            "flash_dkv": layers * sp}


def _sp_scenarios(grad_ref: str) -> tuple:
    """The phase's scenarios, in two four-worker worlds: the first (a)
    each attention function in bf16 and fp32, compared in the workers,
    and (b)'s sp4 run (profiled); the second (b)'s step 0 GPT-2 small
    sp4 gradients against one process's (saved at ``grad_ref``), sound
    and under each planted fault, and (c) the dp2 x sp2 run."""
    attn = [{"kind": "attn", "name": "attn_%s_%s" % (fn, dtype),
             "fn": fn, "impl": "auto", "dtype": dtype,
             "shape": list(SP_ATTN_SHAPE), "causal": True, "seed": 0,
             "mesh": {"sp": SP_WORKERS}, "device": DEVICE, "compare": True}
            for fn in ("ring", "ulysses") for dtype in ("bfloat16",
                                                       "float32")]
    grads = [{"kind": "grads", "name": "grads_" + (fault or "sound"),
              "model": "gpt2_sp4", "ref": grad_ref, "fault": fault}
             for fault in ("",) + dp_check.SP_FAULTS]
    return (attn + [{"kind": "run", "name": "gpt2_sp4", "model": "gpt2_sp4",
                     "steps": SP_STEPS, "profile": True}],
            grads + [{"kind": "run", "name": "gpt2_2layers_dp2_sp2",
                      "model": "gpt2_2layers_dp2_sp2",
                      "steps": SP_DPSP_STEPS}])


def _sp_attn_problems(lines: list) -> list:
    """Every rank's attention check within its class, with n forward
    launches a ring call and n dq and n dkv in its backward (Ulysses:
    one each)."""
    problems = []
    for r in lines:
        n = SP_WORKERS if r["fn"] == "ring" else 1
        want = {"forward": {"fwd": n, "dq": 0, "dkv": 0},
                "call": {"fwd": n, "dq": n, "dkv": n}}
        if not r["ok"]:
            problems.append("%s %s rank %d outside its class: %r"
                            % (r["fn"], r["dtype"], r["rank"], r["errors"]))
        if r["launches"] != want:
            problems.append("%s %s rank %d launched %r, expected %r"
                            % (r["fn"], r["dtype"], r["rank"],
                               r["launches"], want))
    return problems


def _sp_run_problems(name: str, run: dict, steps: int, mesh: dict,
                     per_step: dict) -> list:
    """The gates of a sound sp run (:func:`_dp_summary`): its mesh on every
    rank, equal replicas after every step, losses within SP_LOSS_RTOL of
    one process's, the flash launches of a rank, finite losses."""
    problems = []
    if run["mesh_history"] != [[mesh]] * SP_WORKERS:
        problems.append("%s workers had meshes %r" % (name,
                                                      run["mesh_history"]))
    if not run["replicas_equal_after_each_step"] \
            or run["steps_fingerprinted"] != [steps] * SP_WORKERS:
        problems.append("%s replicas differ after a step" % name)
    if not run["max_rel_loss_diff_vs_one_process"] <= SP_LOSS_RTOL:
        problems.append("%s losses part from one process's by %g"
                        % (name, run["max_rel_loss_diff_vs_one_process"]))
    want = {k: v * steps for k, v in per_step.items()}
    for r in run["launches"]:
        if any(r[k] != v for k, v in want.items()):
            problems.append("%s launches %r, expected %r" % (name, r, want))
    if len(run["losses"]) != steps \
            or not all(np.isfinite(x) for x in run["losses"]):
        problems.append("%s: a loss is missing or not finite" % name)
    return problems


def phase_train_sp(smi: str) -> dict:
    """Sequence parallelism through the port's sp path (an sp mesh axis,
    ring attention on the flash kernels' LSE entry, the sequence block in
    the loss, the gradient sum over sp), four workers started through
    ``python -m paddle_operator_tpu_torch.launch`` in each of two worlds
    run at once (:func:`_sp_scenarios`): over NCCL, one card a worker,
    where the machine has four cards, else on this one card over gloo
    (NCCL refuses two ranks on one device; phase train_dp prints its
    words). The kernels phase holds B2 against its
    plain versions at every shape this phase gives it (``SP_FLASH_CASES``):

    (a) ring attention (every hop on the kernels) and Ulysses attention
        alone on {"sp": 4} at SP_ATTN_SHAPE, causal, in bf16 and fp32:
        each rank's block of the output and of the gradients of q, k and
        v against one process's flash attention over the whole sequence
        (fp32: 2e-5 forward, 2e-4 gradients, the reference's classes;
        bf16: ``dp_check.BF16_HOP`` and ``bf16_grad_rtol``, derived in
        PERF.md), and n flash forward launches a ring call, n dq and n
        dkv in its backward;
    (b) GPT-2 small (12 layers, 768 wide) through
        ``examples/train_gpt.make_job`` with TPUJOB_SEQ=4096,
        TPUJOB_BATCH=4, TPUJOB_SP=4 for SP_STEPS steps against one
        process training the same global batches over the whole sequence
        on the flash kernels: replicas equal bit for bit after every
        step, losses within SP_LOSS_RTOL, the flash launches of a rank a
        step (:func:`_sp_flash_per_step`), and step 0's gradients, summed
        over sp as the train step sums them, within GPT_GRAD_RTOL of one
        process's (every leaf; train_gpt's gradient class); three planted
        faults (the causal test on rotated hops reversed, rope at local
        positions, the sp gradient sum left out) must each break the
        gradient gate (at random init on random tokens the loss barely
        sees attention: the first two moved it by 5.8e-6 and 7.6e-6 on
        an H100);
    (c) the same at 2 layers over {"dp": 2, "sp": 2} (TPUJOB_SP=2) for
        SP_DPSP_STEPS steps, against one process.

    Step ms, the ring's transfers and the flash ms of a rank are printed,
    not gated: on gloo four workers share one card."""
    t0 = time.perf_counter()
    backend = "nccl" if torch.cuda.device_count() >= SP_WORKERS else "gloo"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    try:
        one = {"gpt2_sp4": dp_check.card_run("gpt2_seq4096", SP_STEPS),
               "gpt2_2layers_dp2_sp2": dp_check.card_run(
                   "gpt2_2layers_seq4096", SP_DPSP_STEPS)}
        grad_ref = os.path.join(tmp, "grads.pt")
        torch.save(dp_check.step0_grads("gpt2_seq4096"), grad_ref)
        torch.cuda.empty_cache()

        def world_lines(at: int, scenarios: list) -> list:
            return dp_check.launch_workers(
                {"out": os.path.join(tmp, "workers%d" % at),
                 "scenarios": scenarios},
                world=SP_WORKERS, backend=backend, timeout=900)

        # the two worlds run at once (their workers share the host and
        # the card): one world's start overlaps the other's steps
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            lines = [rank_lines for got in list(pool.map(
                world_lines, (0, 1), _sp_scenarios(grad_ref)))
                for rank_lines in got]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by_name: dict = {}
    for rank_lines in lines:
        for line in rank_lines:
            by_name.setdefault(line["scenario"], []).append(line)
    by_name = {k: sorted(v, key=lambda r: r["rank"])
               for k, v in by_name.items()}
    attn = [r for k, v in by_name.items() if k.startswith("attn_")
            for r in v]
    runs = {"gpt2_sp4": _dp_summary(by_name["gpt2_sp4"], one["gpt2_sp4"],
                                    SP_WORKERS),
            "gpt2_2layers_dp2_sp2": _dp_summary(
                by_name["gpt2_2layers_dp2_sp2"],
                one["gpt2_2layers_dp2_sp2"], 2)}
    sound = by_name["gpt2_sp4"]
    hops = [r["transfers"] for r in sound]
    out = {
        "phase": "train_sp", "card": smi, "backend": backend,
        "note": "four worker processes share this one card over gloo: a "
                "correctness check, not a multi-GPU rate"
                if backend == "gloo" else "four workers, one card each",
        "attention": [{k: r[k] for k in ("fn", "dtype", "rank", "ok",
                                         "errors", "launches", "seconds")}
                      for r in attn],
        "gpt2_sp4": runs["gpt2_sp4"],
        "step0_grads": by_name["grads_sound"],
        "planted": {f: by_name["grads_" + f] for f in dp_check.SP_FAULTS},
        "gpt2_2layers_dp2_sp2": runs["gpt2_2layers_dp2_sp2"],
        "ring_transfers_per_rank": hops,
        "ring_hop_ms_per_rank": [
            1e3 * h["seconds"] / max(1, h["ring_shift"]) for h in hops],
        "flash_ms_per_step_per_rank": [r["flash_ms_per_step"]
                                       for r in sound],
        "tolerance": {"loss_rel": SP_LOSS_RTOL, "grad_rel": GPT_GRAD_RTOL,
                      "attn_bf16_hop": dp_check.BF16_HOP,
                      "attn_bf16_grad_rel": dp_check.bf16_grad_rtol(
                          SP_WORKERS)},
        "seconds": time.perf_counter() - t0,
    }
    emit(out)
    print("train_sp (%s, %s): median step ms one process / four workers "
          "(steps 2 on): GPT-2 sp4 %.2f / %s; ring hop transfer ms (host) "
          "%s; flash ms a step %s; phase %.1f s" % (
                      smi, backend,
                      statistics.median(one["gpt2_sp4"]["step_ms"][1:]),
                      [statistics.median(r["step_ms"][1:]) for r in sound],
                      ["%.2f" % x for x in out["ring_hop_ms_per_rank"]],
                      ["%.2f" % x for x in out["flash_ms_per_step_per_rank"]],
                      out["seconds"]), flush=True)
    problems = _sp_attn_problems(attn)
    if len(attn) != 4 * SP_WORKERS:
        problems.append("%d attention lines, expected %d"
                        % (len(attn), 4 * SP_WORKERS))
    problems += _sp_run_problems("gpt2_sp4", runs["gpt2_sp4"], SP_STEPS,
                                 {"dp": 1, "sp": SP_WORKERS},
                                 _sp_flash_per_step(12, SP_WORKERS))
    problems += _sp_run_problems("gpt2_2layers_dp2_sp2",
                                 runs["gpt2_2layers_dp2_sp2"], SP_DPSP_STEPS,
                                 {"dp": 2, "sp": 2}, _sp_flash_per_step(2, 2))
    for g in by_name["grads_sound"]:
        if not g["max_rel_diff"] <= GPT_GRAD_RTOL:
            problems.append("rank %d's step-0 gradients part from one "
                            "process's by %g at %s" % (
                                g["rank"], g["max_rel_diff"], g["leaf"]))
    for fault, grads in out["planted"].items():
        if all(g["max_rel_diff"] <= GPT_GRAD_RTOL for g in grads):
            problems.append("the gradient gate missed the planted fault %s"
                            % fault)
    if problems:
        fail("train_sp: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# train_ctr: the CTR models, collective and parameter-server mode
# ---------------------------------------------------------------------------

#: step-0 loss and gradients on the card against the port on the CPU, in
#: fp32 with TF32 off, each leaf relative to its largest magnitude
CTR_GRAD_RTOL = 1e-5
#: a straggling trainer's delay before each sparse push (the stale_rows
#: fault's trigger, and its sound control)
CTR_STRAGGLE_S = 0.3
CTR_FAULT_ROUNDS = 4
CTR_MODELS = (("wide_deep", train_wide_deep, wide_deep),
              ("deepfm", train_deepfm, deepfm))


def _ctr_env() -> dict:
    return {"TPUJOB_BATCH": str(CTR_BATCH), "TPUJOB_STEPS": str(CTR_STEPS)}


def _ctr_grad_check(model) -> dict:
    """Step 0's fp32 loss and gradients of ``model`` at DEFAULT_CONFIG on
    the card and on the CPU, from the same parameters and batch."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = model.init(gen)
    batch = model.synthetic_batch(gen, CTR_BATCH)
    out = {}
    for where, dev in (("card", DEVICE), ("cpu", "cpu")):
        p = bridge.tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, gvec, _ = ps.loss_and_grads(
            lambda q, x: model.loss_fn(q, x, dtype=torch.float32), p, b)
        out[where] = (float(loss), gvec)
    names, shapes = zip(*[(k, t.numel()) for k, t in
                          bridge.flatten(params).items()])
    worst, leaf, off = 0.0, "", 0
    for name, n in zip(names, shapes):
        want = out["cpu"][1][off:off + n]
        got = out["card"][1][off:off + n]
        off += n
        rel = float(np.max(np.abs(got - want))) / max(
            float(np.max(np.abs(want))), 1e-30)
        if rel >= worst:
            worst, leaf = rel, name
    return {"loss_card": out["card"][0], "loss_cpu": out["cpu"][0],
            "loss_rel_diff": abs(out["card"][0] - out["cpu"][0])
            / abs(out["cpu"][0]),
            "max_rel_diff": worst, "leaf": leaf, "tolerance": CTR_GRAD_RTOL}


def _ctr_collective(name: str, example, model, tmp: str) -> dict:
    """``example.make_job()`` through run_training: CTR_STEPS steps with
    checkpoints every 10, a resume from step 10, CTR_STEPS on one fixed
    batch and a profiled window (deterministic algorithms on: the
    embedding's index backward is atomic otherwise)."""
    dirs = {k: os.path.join(tmp, name + "_" + k) for k in "ac"}
    grad = _ctr_grad_check(model)
    with _deterministic():
        rec_a, out_a, wall_a = _recorded_run(example.make_job(_ctr_env()),
                                             dirs["a"])
        os.makedirs(dirs["c"])
        shutil.copytree(os.path.join(dirs["a"], "step_%012d" % 10),
                        os.path.join(dirs["c"], "step_%012d" % 10))
        rec_c, out_c, _ = _recorded_run(example.make_job(_ctr_env()),
                                        dirs["c"])
        fixed = model.synthetic_batch(
            torch.Generator(device=DEVICE).manual_seed(1), CTR_BATCH)
        rec_f, _, _ = _recorded_run(example.make_job(_ctr_env()), "",
                                    make_batch=lambda gen, step: fixed)
        job = example.make_job(_ctr_env())
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        profile = _step_profile(job, job.init_params(gen), fixed, warm=2,
                                steps=5)
    la, lc, lf = (r.host_losses() for r in (rec_a, rec_c, rec_f))
    step_ms = rec_a.forward_gaps_ms(2, 9)
    median_ms = statistics.median(step_ms)
    return {"config": {"model": name + " DEFAULT_CONFIG",
                       "batch": CTR_BATCH, "steps": CTR_STEPS,
                       "compute": "bf16", "params": "fp32",
                       "optimizer": "adamw(1e-3)",
                       "deterministic_algorithms": True},
            "grad_check_step_0": grad, "losses": la,
            "resumed_from_10": lc, "fixed_batch_losses": lf,
            "resume_steps": out_c.get("resume_steps"),
            "max_abs_loss_diff_resumed": max(abs(x - y) for x, y in
                                             zip(la[10:], lc)),
            "step_ms": step_ms, "step_ms_median": median_ms,
            "wall_s": wall_a, "profile": profile,
            "idle_share": 1.0 - profile["device_busy_ms_per_step"]
            / median_ms}


def _ctr_collective_problems(name: str, r: dict) -> list:
    problems = []
    g = r["grad_check_step_0"]
    if not (g["max_rel_diff"] <= CTR_GRAD_RTOL
            and g["loss_rel_diff"] <= CTR_GRAD_RTOL):
        problems.append("%s: step 0 on the card parts from the CPU by %g "
                        "(loss %g) at %s > %g" % (
                            name, g["max_rel_diff"], g["loss_rel_diff"],
                            g["leaf"], CTR_GRAD_RTOL))
    la, lc, lf = r["losses"], r["resumed_from_10"], r["fixed_batch_losses"]
    if not all(np.isfinite(x) for x in la + lc + lf):
        problems.append("%s: a loss is not finite" % name)
    if len(la) != CTR_STEPS or len(lc) != CTR_STEPS - 10:
        problems.append("%s: runs did not take their steps" % name)
    if r["resume_steps"] != [10] or r["max_abs_loss_diff_resumed"] != 0.0:
        problems.append("%s: the resume from %r parts from the run by %g "
                        "(stated: bitwise)" % (
                            name, r["resume_steps"],
                            r["max_abs_loss_diff_resumed"]))
    if not lf[-1] < lf[0]:
        problems.append("%s: %d steps on one batch did not lower the loss "
                        "(%g -> %g)" % (name, CTR_STEPS, lf[0], lf[-1]))
    return problems


#: the PS worlds: (b) dense wide&deep, and its twin on one fixed batch for
#: the loss gate; (c) sparse wide&deep and DeepFM; (d) the planted faults
#: and the straggler control
#: (the faults and the control at CTR_FAULT_ROUNDS rounds: a fault shows
#: from its second round on)
def _ctr_scenarios() -> list:
    env = {"TPUJOB_BATCH": str(CTR_BATCH), "TPUJOB_STEPS": str(CTR_ROUNDS),
           "TPUJOB_LR": "0.1"}
    sparse = dict(env, TPUJOB_SPARSE="1")
    short = {"TPUJOB_STEPS": str(CTR_FAULT_ROUNDS)}
    return [
        dict(name="dense_wide_deep", model="wide_deep", env=env),
        dict(name="dense_wide_deep_fixed", model="wide_deep", env=env,
             fixed_batch=True, loss_gate=True),
        dict(name="sparse_wide_deep", model="wide_deep", env=sparse,
             loss_gate=True),
        dict(name="sparse_deepfm", model="deepfm", env=sparse,
             loss_gate=True),
        dict(name="leaf_order", model="wide_deep", env=dict(env, **short),
             fault="leaf_order"),
        dict(name="stale_rows", model="wide_deep",
             env=dict(sparse, **short), fault="stale_rows",
             straggle_s=CTR_STRAGGLE_S),
        dict(name="straggler", model="wide_deep", env=dict(sparse, **short),
             straggle_s=CTR_STRAGGLE_S)]


def _ps_grad_ms(sc: dict, deterministic: bool, reps: int = 20) -> float:
    """Median host ms of one trainer's loss and gradient (to the host
    vector) for a scenario's job at round 0, deterministic algorithms on
    or off: what the BSP replay's bitwise agreement costs a round."""
    job = ps_check.scenario_job(sc, DEVICE)
    vec, treedef, shapes = ps.init_vector(job, DEVICE)
    batch = job.make_batch(ps.batch_generator(0, 0, DEVICE), 0)
    params = ps.unflatten_params(vec, treedef, shapes, DEVICE)
    ctx = _deterministic() if deterministic else contextlib.nullcontext()
    with ctx:
        if job.embed_dim:
            uids, inv = ps.unique_ids(job.ids_fn(batch))
            rows = torch.zeros((len(uids), job.embed_dim), device=DEVICE)
            inv_t = torch.from_numpy(inv).to(DEVICE)
            fn = lambda: ps.loss_and_grads(  # noqa: E731
                job.loss_fn, params, inv_t, batch, grad_args=(rows,))
        else:
            fn = lambda: ps.loss_and_grads(  # noqa: E731
                job.loss_fn, params, batch)
        return host_call_ms(fn, reps)


def _ctr_world(smi: str, tmp: str) -> dict:
    """The PS worlds of _ctr_scenarios through ps_check: 2 pservers (the
    example, no card visible) and 2 trainer processes on the card, and,
    while they run, each world's replay in this process on the card."""
    scenarios = _ctr_scenarios()
    spec = {"out": os.path.join(tmp, "ps_world"), "device": DEVICE,
            "deterministic": True, "scenarios": scenarios}

    def world():
        t0 = time.perf_counter()
        return ps_check.launch_world(spec, timeout=600), \
            time.perf_counter() - t0

    # the replays run here while the world's processes run (the host
    # work of both is mostly the sparse tables' Python)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(world)
        t0 = time.perf_counter()
        with _deterministic():
            replays = {sc["name"]: ps_check.replay(
                ps_check.scenario_job(sc, DEVICE), 2, DEVICE)
                for sc in scenarios}
        replay_s = time.perf_counter() - t0
        runs, world_s = running.result()
    out = {}
    for sc in scenarios:
        job = ps_check.scenario_job(sc, DEVICE)
        rep = replays[sc["name"]]
        t = runs[sc["name"]]["trainers"]
        losses = np.mean([x["losses"] for x in t], axis=0)
        row = {
            "model": sc["model"], "sparse": job.embed_dim > 0,
            "fault": sc.get("fault", ""),
            "fixed_batch": bool(sc.get("fixed_batch")),
            "loss_gate": bool(sc.get("loss_gate")),
            "straggle_s": sc.get("straggle_s", 0.0),
            "pserver_rcs": runs[sc["name"]]["pserver_rcs"],
            "trainers_equal": bool(np.array_equal(t[0]["vector"],
                                                  t[1]["vector"])),
            "replay_equal": bool(np.array_equal(t[0]["vector"],
                                                rep["vector"])),
            "replay_losses_equal": all(
                np.array_equal(x["losses"], rep["losses"][w])
                for w, x in enumerate(t)),
            "replay_max_abs_diff": float(np.max(np.abs(
                t[0]["vector"] - rep["vector"]))),
            "losses": losses.tolist(),
            "loss_first": float(losses[0]),
            "loss_last_half_mean": float(losses[len(losses) // 2:]
                                         .mean()),
            "n_dense": int(len(t[0]["vector"])),
            "round_ms": [float(1e3 * x) for x in t[0]["round_s"]],
            "round_ms_median": float(1e3 * np.median(
                np.concatenate([x["round_s"] for x in t]))),
            "bytes_sent": [int(x["bytes_sent"]) for x in t],
            "bytes_recv": [int(x["bytes_recv"]) for x in t]}
        # less the /init post of the dense vector
        row["bytes_sent_per_round"] = [
            (b - 4 * row["n_dense"]) / len(losses)
            for b in row["bytes_sent"]]
        if job.embed_dim:
            row["uniques_per_round"] = [x["uniques"].tolist()
                                        for x in t]
            row["bytes_sent_expected"] = [
                ps_check.expected_bytes_sent(
                    row["n_dense"], x["uniques"], 2, job.embed_dim)
                for x in t]
        out[sc["name"]] = row
    by = {sc["name"]: sc for sc in scenarios}
    cost = {name: {"deterministic_ms": _ps_grad_ms(by[name], True),
                   "default_ms": _ps_grad_ms(by[name], False)}
            for name in ("dense_wide_deep", "sparse_wide_deep")}
    return {"card": smi, "scenarios": out, "world_s": world_s,
            "replay_s": replay_s, "grad_ms_a_trainer": cost}


def _ctr_world_problems(w: dict) -> list:
    problems = []
    for name, r in w["scenarios"].items():
        if r["pserver_rcs"] != [0, 0]:
            problems.append("%s: the pservers did not exit by the done "
                            "protocol (%r)" % (name, r["pserver_rcs"]))
        if r["fault"]:
            if r["replay_equal"]:
                problems.append("the replay gate missed the planted fault "
                                "%s" % r["fault"])
            continue
        if not r["trainers_equal"]:
            problems.append("%s: the trainers' final vectors differ" % name)
        if not r["replay_equal"]:
            problems.append("%s: the replay parts from the trainers' final "
                            "vector by %g (stated: bitwise)"
                            % (name, r["replay_max_abs_diff"]))
        if not all(np.isfinite(r["losses"])):
            problems.append("%s: a loss is not finite" % name)
        # on fresh random-label batches the dense world's loss is batch
        # noise (PERF.md): its fixed-batch twin carries the gate, as the
        # sparse worlds of CTR_ROUNDS rounds do
        if r["loss_gate"] and not r["loss_last_half_mean"] < r["loss_first"]:
            problems.append("%s: the mean loss of the last rounds %g is not "
                            "below the first round's %g" % (
                                name, r["loss_last_half_mean"],
                                r["loss_first"]))
        if r["sparse"] and r["bytes_sent"] != r["bytes_sent_expected"]:
            problems.append("%s: bytes sent %r, counted from the rounds' "
                            "unique ids %r" % (name, r["bytes_sent"],
                                               r["bytes_sent_expected"]))
    return problems


def phase_train_ctr(smi: str) -> dict:
    """The CTR models at DEFAULT_CONFIG (26 slots x 10,000 ids, embed 16,
    MLP 400-400-400), batch 512:
    (a) collective: examples/train_wide_deep.py's and train_deepfm.py's
        jobs through run_training on the card, bf16 on fp32 params:
        step 0 in fp32 against the CPU, CTR_STEPS steps, a resume from
        step 10 (bitwise), CTR_STEPS on one batch (the loss falls), a
        profile;
    (b)-(d) parameter-server mode: worlds of 2 pservers (the example,
        TRAINING_ROLE=PSERVER, no card visible) and 2 trainers on the
        card (ps_check), CTR_ROUNDS BSP rounds at lr 0.1, dense and
        sparse, each held bitwise against its replay in this process,
        with two planted faults the replay gate must catch."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ctr_") as tmp:
        collective = {name: _ctr_collective(name, example, model, tmp)
                      for name, example, model in CTR_MODELS}
        world = _ctr_world(smi, tmp)
    out = {"phase": "train_ctr", "card": smi, "collective": collective,
           "ps": world, "seconds": time.perf_counter() - t0}
    emit(out)
    s = world["scenarios"]
    print("train_ctr (%s): step ms wide_deep %.3f, deepfm %.3f (idle %.2f, "
          "%.2f); PS round ms dense %.1f, sparse wide_deep %.1f, deepfm "
          "%.1f; bytes sent a round dense %.0f, sparse %.0f; phase %.1f s"
          % (smi, collective["wide_deep"]["step_ms_median"],
             collective["deepfm"]["step_ms_median"],
             collective["wide_deep"]["idle_share"],
             collective["deepfm"]["idle_share"],
             s["dense_wide_deep"]["round_ms_median"],
             s["sparse_wide_deep"]["round_ms_median"],
             s["sparse_deepfm"]["round_ms_median"],
             s["dense_wide_deep"]["bytes_sent_per_round"][0],
             s["sparse_wide_deep"]["bytes_sent_per_round"][0],
             out["seconds"]), flush=True)
    problems = []
    for name, r in collective.items():
        problems += _ctr_collective_problems(name, r)
    problems += _ctr_world_problems(world)
    if problems:
        fail("train_ctr: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# train_elastic: elastic restart cycles, workers sharing the card
# ---------------------------------------------------------------------------

#: (a) ResNet-50 at full width shrinking from 4 workers to 2: steps, the
#: checkpoint period of every elastic run, the step whose manifest moves
#: the epoch (rank 0 holds the next step until it has moved, so the
#: world stops at the boundary after it)
ELASTIC_RESNET_STEPS, ELASTIC_EVERY, ELASTIC_SHRINK_AFTER = 8, 2, 4
#: |loss(elastic world) - loss(one process)| / loss allowed at each step
#: of (a)'s runs, from ``python -m paddle_operator_tpu_torch.elastic_class``
#: on an H100 80GB HBM3 at 700 W: the shrink over six seeds in bf16 parted
#: by up to 6.5e-3 over gloo and 9.2e-3 over NCCL (four cards), in fp32 by
#: up to 7.4e-3; one process started one ulp up parted from itself by up
#: to 8.1e-3 (bf16) and 5.0e-3 (fp32) in 8 steps. The steps amplify any
#: rounding difference to this size, so it is not a fault's; the sharp
#: checks are the replicas, the blocks, the world-4 steps bitwise against
#: the same world uninterrupted and the first loss after the restore
ELASTIC_RESNET_RTOL = 1.5e-2
#: (b) GPT-2 small at DP_GPT_LAYERS layers restarted at 2 workers: steps,
#: and the step after whose save the epoch moves; the planted faults'
#: runs move it after step 2 of ELASTIC_FAULT_RESNET_STEPS (ResNet) or of
#: ELASTIC_GPT_STEPS (GPT)
ELASTIC_GPT_STEPS, ELASTIC_RESTART_AFTER = 6, 2
ELASTIC_FAULT_RESNET_STEPS = 4
#: the flash kernels' shape on (b) (a rank's 8 of the 16 sequences), held
#: against their plain versions by the kernels phase
ELASTIC_FLASH_CASES = (
    ("dp_rank", (GPT_BATCH // 2, gpt.BASE_CONFIG["heads"], GPT_SEQ,
                 gpt.BASE_CONFIG["hidden"] // gpt.BASE_CONFIG["heads"]),
     "bfloat16", True),)
#: each elastic run: (world, its job, steps, np after the move or None,
#: the step after whose save the epoch moves or None, the planted fault).
#: resnet_straight is (a)'s first world uninterrupted, the bitwise
#: reference of (a)'s steps at world 4; gpt_straight is (b)'s
ELASTIC_RUNS = {
    "resnet_shrink": (4, "resnet50", ELASTIC_RESNET_STEPS, 2,
                      ELASTIC_SHRINK_AFTER, ""),
    "resnet_straight": (4, "resnet50", ELASTIC_SHRINK_AFTER + 1, None, None,
                        ""),
    "resnet_stale_shard": (4, "resnet50", ELASTIC_FAULT_RESNET_STEPS, 2, 2,
                           "stale_shard"),
    "gpt_restart": (2, "gpt2_2layers", ELASTIC_GPT_STEPS, None,
                    ELASTIC_RESTART_AFTER, ""),
    "gpt_straight": (2, "gpt2_2layers", ELASTIC_GPT_STEPS, None, None, ""),
    "gpt_fresh_restart": (2, "gpt2_2layers", ELASTIC_GPT_STEPS, None, 2,
                          "fresh_restart"),
}
#: the gate each planted fault must break
ELASTIC_FAULT_GATES = {"resnet_stale_shard": "batch_block",
                       "gpt_fresh_restart": "restore"}


def _elastic_worlds(tmp: str, endpoint: str) -> dict:
    """Run ELASTIC_RUNS in two worlds of workers started through
    ``python -m paddle_operator_tpu_torch.launch`` with the elastic env:
    four for the ResNet runs, two for the GPT runs, both at once (their
    workers share the host and the card); NCCL where the machine has a
    card a worker, else gloo on this card. Returns the lines by run."""

    def world_lines(world: int) -> dict:
        scenarios, triggers = [], []
        for name, (w, model, steps, np1, after, fault) in \
                ELASTIC_RUNS.items():
            if w != world:
                continue
            ckpt = os.path.join(tmp, name)
            scenarios.append({
                "kind": "elastic", "name": name, "job": "chip-" + name,
                "model": model, "steps": steps, "every": ELASTIC_EVERY,
                "ckpt_dir": ckpt, "np": world, "fault": fault,
                "hold_at": after if after is not None else -1})
            if after is not None:
                triggers.append(elastic_check.Trigger(
                    "chip-" + name, ckpt, after, np=np1))
        return elastic_check.launch(
            {"out": os.path.join(tmp, "w%d" % world),
             "scenarios": scenarios}, world, endpoint, triggers,
            backend="nccl" if torch.cuda.device_count() >= world
            else "gloo", timeout=600)

    torch.cuda.empty_cache()
    lines = {}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for got in list(pool.map(world_lines, (4, 2))):
            lines.update(got)
    return lines


def _block_prints(model: str, steps: int, worlds) -> dict:
    """``bits_print`` of each rank's dp block of each step's global batch,
    by ``(step, rank, world)``, drawn as the job's workers draw it."""
    job = dp_check.card_job(model, steps)
    out = {}
    for step in range(steps):
        batch = job.make_batch(step_generator(job.seed, step, DEVICE), step)
        for world in worlds:
            for rank in range(world):
                out[(step, rank, world)] = elastic_check.bits_print(
                    process_shard(batch, rank, world)).tolist()
    return out


def _cycle_of(line: dict) -> list:
    """``(epoch, world, step)`` of each loss call of a rank's line."""
    out = []
    for cyc in line["cycle_stages"]:
        out += [(cyc["epoch"], cyc["world"], s)
                for s in range(cyc["start_step"], cyc["end_step"])]
    return out


def _elastic_problems(name: str, lines: list, want: dict, blocks: dict,
                      checkpoints: dict, per_step: dict,
                      rtol: float) -> list:
    """The gates of one elastic run (its ranks' lines), as ``(gate,
    message)``: cycles, steps, meshes, resume steps and leaves; replicas
    equal at every step and at the end; each rank trained on its dp block
    of the step's global batch; the global batch's loss at each step of
    ``want`` (step -> (loss, relative bound)) within its bound; the first
    step after the restore starts from the checkpoint's parameters, its
    loss within ``rtol`` of the checkpoint's on that step's batch in one
    process; launches a rank = ``per_step`` times the steps it
    dispatched."""
    world0, _, steps, np1, after, _ = ELASTIC_RUNS[name]
    world1 = np1 or world0
    problems = []

    def bad(gate, msg):
        problems.append((gate, "%s: %s" % (name, msg)))

    stay = [r for r in lines if r["rank"] < world1]
    gone = [r for r in lines if r["rank"] >= world1]
    if [r["rank"] for r in lines] != list(range(world0)):
        bad("ranks", "lines of ranks %r" % [r["rank"] for r in lines])
    cycles = 1 if after is None else 2
    meshes = [{"dp": world0}] + ([{"dp": world1}] if after is not None
                                 else [])
    resume = [r["resume_steps"] for r in stay]
    for r in stay:
        if (r["cycles"], r["steps"], r["mesh_history"]) != (cycles, steps,
                                                            meshes):
            bad("cycles", "rank %d: cycles %r, steps %r, meshes %r" % (
                r["rank"], r["cycles"], r["steps"], r["mesh_history"]))
    if after is not None and (len(set(map(tuple, resume))) != 1
                              or len(resume[0]) != 1
                              or resume[0][0] < ELASTIC_EVERY):
        bad("restore", "resume steps %r" % resume)
    for r in gone:
        if (r["left_at_epoch"], r["mesh_history"]) != (2, [{"dp": world0}]):
            bad("cycles", "rank %d left at %r with meshes %r" % (
                r["rank"], r["left_at_epoch"], r["mesh_history"]))
    prints: dict = {}
    for r in lines:
        for (epoch, world, step), p, b in zip(_cycle_of(r), r["prints"],
                                              r["batch_prints"]):
            prints.setdefault((epoch, step), set()).add(tuple(p))
            if b != blocks[(step, r["rank"], world)]:
                bad("batch_block", "rank %d trained on another block at "
                    "step %d (world %d)" % (r["rank"], step, world))
    if any(len(v) != 1 for v in prints.values()) \
            or len({r.get("final_digest") for r in stay}) != 1:
        bad("replicas", "replicas differ")
    losses = elastic_check.step_losses(lines)
    if sorted(losses) != list(range(steps)):
        bad("losses", "steps with losses %r" % sorted(losses))
    else:
        for step, (loss, bound) in want.items():
            if not abs(losses[step] - loss) <= bound * abs(loss):
                bad("losses", "step %d's loss %r, its reference's %r (bound "
                    "%g)" % (step, losses[step], loss, bound))
    if after is not None and resume and resume[0]:
        s = resume[0][0]
        ck = checkpoints.get(s)
        first = [r["prints"][_cycle_of(r).index((2, world1, s))]
                 for r in stay if (2, world1, s) in _cycle_of(r)]
        if ck is None or ck["epoch"] != 1 or first != [ck["print"]] * len(
                stay):
            bad("restore", "the first step after the restore does not "
                "start from step %d's checkpoint" % s)
        elif not abs(losses.get(s, np.inf) - ck["loss"]) <= rtol * abs(
                ck["loss"]):
            bad("restore", "the first loss after the restore %r, the "
                "checkpoint's %r" % (losses.get(s), ck["loss"]))
    for r in lines:
        want = {k: v * len(r["losses"]) for k, v in per_step.items()}
        if any(r["launches"][k] != v for k, v in want.items()):
            bad("launches", "rank %d launched %r, expected %r"
                % (r["rank"], r["launches"], want))
    return problems


def phase_train_elastic(smi: str) -> dict:
    """Elastic training cycles through the port's elastic path (the
    membership agent polling a port-copied ``MembershipServer`` run
    here, a process group formed anew at each epoch, the interrupt
    checkpoint, the restore onto the new mesh), workers started through
    ``python -m paddle_operator_tpu_torch.launch`` with the operator's
    elastic env; this process writes ``np`` and bumps the epoch as the
    operator does (``np`` first):

    (a) ResNet-50 v1.5 at 224x224, global batch 128, ``fused_sgd`` (B1)
        at lr 0.01, sync BatchNorm, ELASTIC_RESNET_STEPS steps, a
        checkpoint every ELASTIC_EVERY: four workers at np 4; once step
        ELASTIC_SHRINK_AFTER's manifest is on disk, np 2 and epoch 2;
        ranks 2 and 3 save with the others and leave; ranks 0 and 1
        resume on {"dp": 2} and finish. The losses of every step of the
        shrink and of the same world uninterrupted (``resnet_straight``)
        within ELASTIC_RESNET_RTOL of one process's run of the same
        steps, and the shrink's steps at world 4 bitwise those of
        ``resnet_straight``;
    (b) GPT-2 small at DP_GPT_LAYERS layers (full width, 16 x 1024,
        adamw, the flash kernels B2), two workers, ELASTIC_GPT_STEPS
        steps, the epoch moved after step ELASTIC_RESTART_AFTER's save:
        per-rank losses and the final state bitwise equal to an
        uninterrupted two-worker run (deterministic algorithms), losses
        within DP_GPT_RTOL of one process;
    (c) two planted faults, each of which its gate
        (ELASTIC_FAULT_GATES) must reject: ``stale_shard`` on a shorter
        (a), ``fresh_restart`` on (b).

    Every run: cycles, steps, meshes and resume steps as planned; the
    leaving ranks exit 0 with ``left_at_epoch`` 2; replicas equal at
    every step and at the end; each rank trains on its dp block of each
    step's global batch; the first step after the restore starts from
    the checkpoint's parameters and its loss is the checkpoint's on that
    batch in one process (within DP_RESNET_RTOL for ResNet: one
    two-worker step from the same bits, 1.8e-3 at most over twelve
    ``elastic_class`` readings; DP_GPT_RTOL for GPT); B1 once and B2 2 / 1 / 1 a layer for every step a rank
    dispatched. Printed: steps and step ms a rank and cycle, the time to
    recover by part, the launches. The workers share one card over gloo
    unless the machine has a card each: a correctness run, not a
    rate."""
    t0 = time.perf_counter()
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        one = {"resnet50": dp_check.card_run("resnet50",
                                             ELASTIC_RESNET_STEPS)}
        with _deterministic():
            one["gpt2_2layers"] = dp_check.card_run("gpt2_2layers",
                                                    ELASTIC_GPT_STEPS)
        blocks = {"resnet50": _block_prints("resnet50", ELASTIC_RESNET_STEPS,
                                            (4, 2)),
                  "gpt2_2layers": _block_prints("gpt2_2layers",
                                                ELASTIC_GPT_STEPS, (2,))}
        torch.cuda.empty_cache()
        t_worlds = time.perf_counter()
        with MembershipServer() as server:
            lines = _elastic_worlds(tmp, server.endpoint)
        worlds_s = time.perf_counter() - t_worlds
        checkpoints = {}
        with _deterministic():
            for name, (_, model, steps, _, after, _) in ELASTIC_RUNS.items():
                stay = [r for r in lines[name] if r["resume_steps"]]
                checkpoints[name] = {
                    s: elastic_check.checkpointed(
                        model, steps, os.path.join(tmp, name), s,
                        device=DEVICE)
                    for s in {r["resume_steps"][0] for r in stay}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        cudnn.deterministic, cudnn.benchmark = saved
    per_gpt_step = {"flash_fwd": 2 * DP_GPT_LAYERS, "flash_dq": DP_GPT_LAYERS,
                    "flash_dkv": DP_GPT_LAYERS}
    step_losses = {name: elastic_check.step_losses(rs)
                   for name, rs in lines.items()}
    straight = step_losses["resnet_straight"]
    gates = {}
    for name, (_, model, steps, _, after, _) in ELASTIC_RUNS.items():
        # every step within its class of one process: ResNet's
        # four-worker class (the world-2 steps carry the world-4
        # trajectory), GPT's
        rtol = ELASTIC_RESNET_RTOL if model == "resnet50" else DP_GPT_RTOL
        gates[name] = _elastic_problems(
            name, lines[name],
            {i: (one[model]["losses"][i], rtol) for i in range(steps)},
            blocks[model], checkpoints[name],
            {"fused_sgd": 1} if model == "resnet50" else per_gpt_step,
            DP_RESNET_RTOL if model == "resnet50" else DP_GPT_RTOL)
        if model == "resnet50" and after is not None:
            # the steps before the shrink are the same world's
            # uninterrupted run, bit for bit
            cut = lines[name][0]["cycle_stages"][0]["end_step"]
            if [step_losses[name][i] for i in range(cut)] != [
                    straight.get(i) for i in range(cut)]:
                gates[name].append(("straight", "%s: the steps before the "
                                    "shrink are not resnet_straight's" % name))
    restart, straight = lines["gpt_restart"], lines["gpt_straight"]
    bitwise = [r["losses"] for r in restart] == [r["losses"]
                                                 for r in straight] \
        and [r["final_digest"] for r in restart] == [
            r["final_digest"] for r in straight]

    def cycles_of(r):
        """A rank's steps and median step ms (forward start to update
        end) by cycle."""
        ms, call = [], 0
        for cyc in r["cycle_stages"]:
            n = cyc["end_step"] - cyc["start_step"]
            ms.append({"epoch": cyc["epoch"], "world": cyc["world"],
                       "steps": [cyc["start_step"], cyc["end_step"]],
                       "step_ms_median": 1e3 * statistics.median(
                           r["step_s"][call:call + n]) if n else None})
            call += n
        return ms

    out = {
        "phase": "train_elastic", "card": smi,
        "backend": {w: "nccl" if torch.cuda.device_count() >= w else "gloo"
                    for w in (4, 2)},
        "note": "the workers share this one card over gloo: a correctness "
                "check, not a multi-GPU rate"
                if torch.cuda.device_count() < 4 else "a card a worker",
        "runs": {name: [{k: r[k] for k in (
            "rank", "cycles", "steps", "mesh_history", "resume_steps",
            "left_at_epoch", "launches", "recovery", "wall_s",
            "cycle_stages", "step_s")} | {"cycles_ms": cycles_of(r)}
            for r in rs] for name, rs in lines.items()},
        "step_losses": step_losses,
        "one_process_losses": {k: v["losses"] for k, v in one.items()},
        "max_rel_loss_diff_vs_one_process": {
            name: max(abs(v - one[ELASTIC_RUNS[name][1]]["losses"][i])
                      / abs(one[ELASTIC_RUNS[name][1]]["losses"][i])
                      for i, v in sl.items())
            for name, sl in step_losses.items()},
        "checkpoints": checkpoints,
        "gpt_restart_bitwise_vs_straight": bitwise,
        "gates": {name: [g for g, _ in p] for name, p in gates.items()},
        "tolerance": {"resnet_rel": ELASTIC_RESNET_RTOL,
                      "resnet_first_after_restore_rel": DP_RESNET_RTOL,
                      "gpt_rel": DP_GPT_RTOL},
        "worlds_s": worlds_s, "seconds": time.perf_counter() - t0,
    }
    emit(out)
    for name in ("resnet_shrink", "gpt_restart"):
        for r in out["runs"][name]:
            print("train_elastic %s rank %d (%s): %s; recovery %s; launches "
                  "%s" % (name, r["rank"], smi, ", ".join(
                      "epoch %d world %d steps %d-%d %.1f ms" % (
                          c["epoch"], c["world"], c["steps"][0],
                          c["steps"][1], c["step_ms_median"] or 0.0)
                      for c in r["cycles_ms"]),
                      json.dumps(r["recovery"]), r["launches"]), flush=True)
    print("train_elastic (%s): largest loss difference from one process "
          "%s; worlds %.1f s, phase %.1f s" % (
              smi, json.dumps(out["max_rel_loss_diff_vs_one_process"]),
              worlds_s, out["seconds"]), flush=True)
    problems = []
    for name, p in gates.items():
        if name in ELASTIC_FAULT_GATES:
            if ELASTIC_FAULT_GATES[name] not in {g for g, _ in p}:
                problems.append("the %s gate missed the planted fault in %s"
                                % (ELASTIC_FAULT_GATES[name], name))
        else:
            problems += [msg for _, msg in p]
    if not bitwise:
        problems.append("the restarted GPT run is not bitwise the "
                        "uninterrupted one")
    if problems:
        fail("train_elastic: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# train_moe_ep: MoE across worker processes (dp, dp x sp, dp x ep)
# ---------------------------------------------------------------------------

#: the workers of the phase (one world for every run)
MOE_EP_WORKERS = 4
#: steps of the 12-layer runs (the first of train_gpt_moe's run (a)'s 10),
#: of (c)'s sp run, and of the 2-layer dp2 x ep2 runs (sound and faults)
MOE_EP_STEPS, MOE_EP_SP_STEPS, MOE_EP_SHORT_STEPS = 3, 3, 2
#: |loss(workers) - loss(one process)| / loss allowed at each step, and
#: between (a) and (b): the class of ``moe_check``'s readings (PERF.md
#: §6, PR 13). Adamw's first steps move each parameter by about lr times
#: the sign of its gradient, so a rounding difference in a small
#: gradient becomes a step of lr, and 6 MoE layers route on it: one
#: process with its parameters one ulp up parts from itself by up to
#: 7.3e-3 in 5 steps on an H100 80GB HBM3 at 700 W, as far as the
#: four-worker worlds (up to 6.9e-3 over seeds 0-3)
MOE_EP_LOSS_RTOL = 1.5e-2
#: the same at step 0, before any update: the forward's rounding alone
#: (at most 9.8e-6 over the same readings)
MOE_EP_LOSS0_RTOL = 1e-4
#: step 0's gradients against one process's: the largest ||g - g_one|| /
#: ||g_one|| over the replicated leaves, and over a rank's expert blocks.
#: train_gpt_moe's class (GPT_MOE_GRAD_RTOL): a deep layer's expert sums
#: its tokens' nearly random contributions, and a token routed elsewhere
#: moves it. On an H100 80GB HBM3 at 700 W the sound 12-layer runs read
#: up to 0.118 (an expert wi of layer 10), the 2-layer ones 0.0083 (0.093
#: under sp, the router), and the planted faults 0.455 and 0.542
MOE_EP_GRAD_RTOL = GPT_MOE_GRAD_RTOL
#: the first MoE layer's routing of a rank's block at step 0 against one
#: process's (``moe_check.routing_apart``): at most this many tokens sent
#: to another expert or dropped in one run only, and no position shifted
#: by more (each near-tie routed elsewhere shifts its expert's later
#: positions by one)
MOE_EP_ROUTE_APART = 64
#: the phase's sound runs (the kernels line counts their launches)
MOE_EP_SOUND = ("dp4", "dp2_ep2", "sp2_2layers", "dp2_ep2_2layers")
#: each planted fault (``moe_check.FAULTS``) and the gate that must reject
#: it
MOE_EP_FAULT_GATES = {"route_per_rank": "routing",
                      "ep_x_cotangent": "grads",
                      "norm_without_ep": "replicas"}
#: B4 at a rank's shapes on this path, held against its plain versions in
#: the kernels phase: (case, the rank's first token and token count of the
#: global 16 x 1024, its first expert and expert count)
MOE_EP_B4_CASES = (
    ("dp4_rank", GPT_BATCH * GPT_SEQ // 4, GPT_BATCH * GPT_SEQ // 4, 0,
     MOE_EXPERTS),
    ("dp2_ep2_rank", 0, GPT_BATCH * GPT_SEQ // 2, MOE_EXPERTS // 2,
     MOE_EXPERTS // 2))
#: B2 at the shapes this path gives it that no other phase's check holds:
#: a dp4 rank's 4 sequences, and a ring hop of (c)'s dp2 x sp2 at 2 layers
MOE_EP_FLASH_CASES = (
    ("dp_rank", (GPT_BATCH // 4, gpt.BASE_CONFIG["heads"], GPT_SEQ,
                 gpt.BASE_CONFIG["hidden"] // gpt.BASE_CONFIG["heads"]),
     "bfloat16", True),) + tuple(
    ("ring_hop", (GPT_BATCH // 2, gpt.BASE_CONFIG["heads"], GPT_SEQ // 2,
                  gpt.BASE_CONFIG["hidden"] // gpt.BASE_CONFIG["heads"]),
     "bfloat16", causal) for causal in (True, False))


@torch.no_grad()
def _moe_rank_case(first: int, count: int, expert0: int,
                   experts: int, tokens: int = 0, dim: int = 0,
                   n_experts: int = 0) -> dict:
    """B4's operands on one rank of an expert-parallel path: the global
    batch's case (:func:`_moe_case`: ``tokens``, default the GPT path's,
    of width ``dim`` over ``n_experts``) cut to the rank's tokens, its
    expert ids shifted to its first expert, and expert outputs for its
    experts only."""
    case = _moe_case(tokens or GPT_BATCH * GPT_SEQ, 1.25, dim=dim,
                     experts=n_experts)
    rows = slice(first, first + count)
    return {"x": case["x"][rows].contiguous(),
            "eo": case["eo"][expert0:expert0 + experts].contiguous(),
            "gate": case["gate"][rows].contiguous(),
            "choice": (case["choice"][rows] - expert0).contiguous(),
            "pos": case["pos"][rows].contiguous(),
            "capacity": case["capacity"], "experts": experts,
            "kept": int(((case["choice"][rows] >= expert0)
                         & (case["choice"][rows] < expert0 + experts)
                         & (case["pos"][rows] < case["capacity"])).sum())}


def _moe_ep_scenarios(refs: dict) -> tuple:
    """The phase's runs in two four-worker worlds: the 12-layer runs of
    ``moe_check.CARD_RUNS`` in the first, the 2-layer runs sound and the
    planted faults on the 2-layer dp2 x ep2 run in the second; every run
    with its one process's step-0 routing and gradients (``refs``)."""
    out: tuple = ([], [])
    for run, steps, fault in (
            ("dp4", MOE_EP_STEPS, ""), ("dp2_ep2", MOE_EP_STEPS, ""),
            ("sp2_2layers", MOE_EP_SP_STEPS, ""),
            ("dp2_ep2_2layers", MOE_EP_SHORT_STEPS, "")) + tuple(
            ("dp2_ep2_2layers", MOE_EP_SHORT_STEPS, f)
            for f in moe_check.FAULTS):
        ref = refs[moe_check.ONE_PROCESS[run]]
        out[moe_check.ONE_PROCESS[run] != "12layers"].append({
            "kind": "card", "name": run + ("_" + fault if fault else ""),
            "run": run, "steps": steps, "fault": fault,
            "routes_ref": ref["routes"], "grads_ref": ref["grads"]})
    return out


def global_losses(lines: list) -> list:
    """A run's global loss at each step from its ranks' parts (the train
    step's metric): their mean, times the sequence blocks of a replica."""
    sp = 2 if lines[0]["run"].startswith("sp2") else 1
    return (np.mean([r["losses"] for r in lines], axis=0) * sp).tolist()


def _moe_ep_problems(name: str, lines: list, one: list, per_step: dict,
                     experts: bool) -> list:
    """``(gate, message)`` of every gate a run of the phase fails: losses
    within MOE_EP_LOSS_RTOL of one process's (``one``) at every step and
    within MOE_EP_LOSS0_RTOL at step 0;
    replicas (the replicated leaves equal on every rank after every step
    and at the end; each expert shard equal on its dp replicas); the
    clip's norm equal on every rank; step 0's gradients within
    MOE_EP_GRAD_RTOL; the first MoE layer's routing within
    MOE_EP_ROUTE_APART (tokens to another expert or dropped in one run
    only, and the largest position shift);
    ``per_step`` launches of a rank a step; finite losses."""
    problems = []
    steps = len(lines[0]["losses"])
    rel = rel_diffs(global_losses(lines), one)
    if not max(rel) <= MOE_EP_LOSS_RTOL:
        problems.append(("loss", "%s losses part from one process's by %g"
                         % (name, max(rel))))
    if not rel[0] <= MOE_EP_LOSS0_RTOL:
        problems.append(("loss", "%s step 0's loss parts from one "
                         "process's by %g" % (name, rel[0])))
    dense = [[p[0] for p in r["fingerprints"]] for r in lines]
    same = all(d == dense[0] for d in dense) and len(
        {r["dense_digest"] for r in lines}) == 1
    if experts:
        half = MOE_EP_WORKERS // 2
        same = same and all(
            [p[1] for p in lines[r]["fingerprints"]]
            == [p[1] for p in lines[r + half]["fingerprints"]]
            and lines[r]["expert_digest"] == lines[r + half]["expert_digest"]
            for r in range(half))
    if not same:
        problems.append(("replicas", "%s replicas differ" % name))
    if len({tuple(r["grad_norms"]) for r in lines}) != 1:
        problems.append(("replicas", "%s ranks clip by different norms: %r"
                         % (name, [r["grad_norms"] for r in lines])))
    for r in lines:
        for part in ("grads_dense", "grads_expert"):
            if part in r and not r[part]["max_rel_diff"] <= MOE_EP_GRAD_RTOL:
                problems.append(("grads", "%s rank %d's step-0 gradients "
                                 "part from one process's by %g at %s"
                                 % (name, r["rank"], r[part]["max_rel_diff"],
                                    r[part]["leaf"])))
        if not max(r["routing_apart"].values()) <= MOE_EP_ROUTE_APART:
            problems.append(("routing", "%s rank %d routes apart from one "
                             "process: %r" % (name, r["rank"],
                                              r["routing_apart"])))
        want = {k: v * steps for k, v in per_step.items()}
        if any(r["launches"][k] != v for k, v in want.items()):
            problems.append(("launches", "%s rank %d launched %r, expected "
                             "%r" % (name, r["rank"], r["launches"], want)))
        if r["path_launches"]["dispatch_scalar"] \
                or r["path_launches"]["combine_scalar"]:
            problems.append(("launches", "%s rank %d: a B4 launch left the "
                             "16-byte path" % (name, r["rank"])))
        if not all(np.isfinite(x) for x in r["losses"]):
            problems.append(("loss", "%s: a loss is not finite" % name))
    return problems


def phase_train_moe_ep(smi: str, one_12layers: list = None) -> dict:
    """MoE across worker processes through the port's path (global
    routing over the token group, an ``ep`` mesh axis with the expert
    leaves split by ``moe_rules``, the ep sums of the MoE layers, the
    expert gradients averaged over their replicas and the clip's norm
    summed over ep): GPT-2 small with 8-expert switch FFNs on every second
    layer at full width (``examples/train_gpt.make_job`` with
    TPUJOB_MOE_EXPERTS=8 and TPUJOB_MOE_FUSED=1: 16 x 1024, adamw,
    remat, grad clip 1.0, the first steps of train_gpt_moe's 10-step
    schedule, deterministic algorithms), four workers started through
    ``python -m paddle_operator_tpu_torch.launch`` in each of two worlds
    run at once, (a) and (b) in one, (c) and (d) in the other (NCCL, a
    card each, on a machine of four cards; else gloo on this card):

    (a) dp4 at 12 layers (the example's own path at four workers, experts
        replicated), MOE_EP_STEPS steps, against one process
        (``one_12layers``: train_gpt_moe's run (a), or run here);
    (b) ``{"dp": 2, "ep": 2}`` with ``gpt_rules() + moe_rules()`` set on
        the example's job, as the reference's tests set them: each rank
        holds 4 of each layer's 8 experts and runs B4 on them; against
        one process and against (a);
    (c) TPUJOB_SP=2 at 2 layers (dp2 x sp2 on the four workers: routing
        over sequence blocks and batch rows), MOE_EP_SP_STEPS steps,
        against one process;
    (d) the 2-layer dp2 x ep2 run sound and under each planted fault
        (``moe_check.FAULTS``), each of which its gate
        (MOE_EP_FAULT_GATES) must reject.

    Gates of every sound run (:func:`_moe_ep_problems`): losses, replica
    identity (replicated leaves bitwise on every rank, expert shards
    bitwise on their dp replicas), equal clip norms, step-0 gradients,
    the first MoE layer's routing against one process's, B4 and B2
    launches of a rank a step (``moe_launches_per_step``), the 16-byte
    path; and on (a), the runner's straggler check over the world: each
    rank reports its step profile, a gang view of the four ranks and no
    straggler event. Printed: step ms a rank, the MoE collectives' share of it
    (host seconds), B4 launches a rank a step, peak GB a rank and the
    phase's seconds. On gloo the workers share one card: a correctness
    run, not a rate."""
    t0 = time.perf_counter()
    backend = "nccl" if torch.cuda.device_count() >= MOE_EP_WORKERS \
        else "gloo"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_ep_")
    try:
        refs = {"12layers": moe_check.one_process(
                    "12layers", 0 if one_12layers else MOE_EP_STEPS, tmp),
                "2layers": moe_check.one_process("2layers", MOE_EP_SP_STEPS,
                                                 tmp)}
        one = {"12layers": one_12layers or refs["12layers"]["losses"],
               "2layers": refs["2layers"]["losses"]}
        torch.cuda.empty_cache()
        t_world = time.perf_counter()

        def world_lines(at: int, scenarios: list) -> list:
            return moe_check.launch(
                {"out": os.path.join(tmp, "workers%d" % at),
                 "scenarios": scenarios},
                world=MOE_EP_WORKERS, backend=backend, timeout=1100)

        # the two worlds run at once (their workers share the host and
        # the card): one world's start overlaps the other's steps
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            lines = [rank_lines for got in list(pool.map(
                world_lines, (0, 1), _moe_ep_scenarios(refs)))
                for rank_lines in got]
        world_s = time.perf_counter() - t_world
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs: dict = {}
    for rank_lines in lines:
        for line in rank_lines:
            runs.setdefault(line["scenario"], []).append(line)
    runs = {k: sorted(v, key=lambda r: r["rank"]) for k, v in runs.items()}
    gates, summary = {}, {}
    for name, rs in runs.items():
        run = rs[0]["run"]
        layers = 12 if moe_check.ONE_PROCESS[run] == "12layers" else 2
        cfg = dict(gpt.BASE_CONFIG, layers=layers, moe_experts=MOE_EXPERTS,
                   moe_every=2)
        sp = 2 if run.startswith("sp2") else 1
        per_step = dict(moe_launches_per_step(cfg, remat=True),
                        **_sp_flash_per_step(layers, sp))
        experts = "ep2" in run
        gates[name] = _moe_ep_problems(
            name, rs, one[moe_check.ONE_PROCESS[run]][:len(rs[0]["losses"])],
            per_step, experts)
        step_s = [sum(r["step_ms"][1:]) / 1e3 for r in rs]
        if name == "dp4":
            for r in rs:
                if not ("dispatch" in r["step_profile"]
                        and len(r["gang_p50"]) == MOE_EP_WORKERS
                        and r["straggler_events"] == 0):
                    gates[name].append((
                        "straggler", "rank %d: step profile %s, gang %r, "
                        "%d straggler events; expected a dispatch phase, "
                        "%d ranks and none" % (
                            r["rank"], sorted(r["step_profile"]),
                            r["gang_p50"], r["straggler_events"],
                            MOE_EP_WORKERS)))
        summary[name] = {
            "losses": global_losses(rs),
            "max_rel_loss_diff_vs_one_process": max(rel_diffs(
                global_losses(rs), one[moe_check.ONE_PROCESS[run]])),
            "grad_norms_rank0": rs[0]["grad_norms"],
            "grads_dense": [r["grads_dense"] for r in rs],
            "grads_expert": [r.get("grads_expert") for r in rs],
            "routing_apart": [r["routing_apart"] for r in rs],
            "step_ms_median": [statistics.median(r["step_ms"][1:])
                               for r in rs],
            "moe_collective_share": [
                r["moe_traffic"]["seconds"] / max(s, 1e-9)
                for r, s in zip(rs, step_s)],
            "moe_traffic": [r["moe_traffic"] for r in rs],
            "launches": [r["launches"] for r in rs],
            "b4_launches_per_step": [
                {k: r["launches"][k] / len(r["losses"])
                 for k in ("dispatch", "combine")} for r in rs],
            "expected_per_step": per_step,
            "peak_gb": [r["peak_gb"] for r in rs],
            "mesh_history": [r["mesh_history"] for r in rs],
            "wall_s": [r["wall_s"] for r in rs],
            "gang_p50": [r["gang_p50"] for r in rs],
            "straggler_events": [r["straggler_events"] for r in rs],
            "dispatch_p50_s": [r["step_profile"].get("dispatch", {})
                               .get("p50") for r in rs],
            "collective_p50_s": [r["step_profile"].get("collective", {})
                                 .get("p50") for r in rs],
            "gates_failed": sorted({g for g, _ in gates[name]})}
    a, b = global_losses(runs["dp4"]), global_losses(runs["dp2_ep2"])
    a_vs_b = max(rel_diffs(b, a))
    out = {"phase": "train_moe_ep", "card": smi, "backend": backend,
           "note": "four worker processes share this one card over gloo: "
                   "a correctness check, not a multi-GPU rate"
                   if backend == "gloo" else "four workers, one card each",
           "one_process_losses": one, "runs": summary,
           "max_rel_loss_diff_dp2_ep2_vs_dp4": a_vs_b,
           "dp2_ep2_bitwise_vs_dp4": a == b,
           "tolerance": {"loss_rel": MOE_EP_LOSS_RTOL,
                         "step0_loss_rel": MOE_EP_LOSS0_RTOL,
                         "grad_rel": MOE_EP_GRAD_RTOL,
                         "routing_apart": MOE_EP_ROUTE_APART},
           "world_s": world_s, "seconds": time.perf_counter() - t0}
    emit(out)
    for name in ("dp4", "dp2_ep2", "sp2_2layers"):
        r = summary[name]
        print("train_moe_ep %s (%s, %s): step ms a rank %s; MoE collectives "
              "%s of it; B4 a rank a step %s; peak GB %s; off one process "
              "by %.3g" % (
                  name, smi, backend,
                  ["%.1f" % x for x in r["step_ms_median"]],
                  ["%.3f" % x for x in r["moe_collective_share"]],
                  r["b4_launches_per_step"][0],
                  ["%.2f" % x for x in r["peak_gb"]],
                  r["max_rel_loss_diff_vs_one_process"]), flush=True)
    print("train_moe_ep (%s): dp2 x ep2 against dp4 %.3g; phase %.1f s"
          % (smi, a_vs_b, out["seconds"]), flush=True)
    dp4 = summary["dp4"]
    print("train_moe_ep dp4 straggler check (%s): gang views %s; dispatch "
          "p50 s %s, collective p50 s %s; straggler events %s" % (
              smi, dp4["gang_p50"], dp4["dispatch_p50_s"],
              dp4["collective_p50_s"], dp4["straggler_events"]),
          flush=True)
    problems = []
    for name, p in gates.items():
        fault = runs[name][0]["fault"]
        if fault:
            if MOE_EP_FAULT_GATES[fault] not in {g for g, _ in p}:
                problems.append("the %s gate missed the planted fault %s"
                                % (MOE_EP_FAULT_GATES[fault], fault))
        else:
            problems += [msg for _, msg in p]
    if not a_vs_b <= MOE_EP_LOSS_RTOL:
        problems.append("dp2 x ep2 and dp4 part by %g" % a_vs_b)
    if problems:
        fail("train_moe_ep: " + "; ".join(problems))
    return out

# ---------------------------------------------------------------------------
# train_migrate: the live-migration MOVE of ResNet-50 over the artifact tier
# ---------------------------------------------------------------------------

#: the step the operator's MOVE notice lands on: not a multiple of the
#: checkpoint interval (10), so the drain's cut is a fresh save
MIGRATE_AT = 13
#: the steps of phase train's run, which the MOVE must reproduce
MIGRATE_STEPS = 30
#: the job key the notice names and the destination's
#: TPUJOB_MIGRATE_STATE carries
MIGRATE_NS, MIGRATE_NAME = "smoke", "resnet50"
#: steps of the planted faults' runs: f1's source drains at step 2, and
#: f2-f4's destinations train 2 steps past where they start
MIGRATE_FAULT_STEPS = 2
#: the gate each planted fault must make fire
MIGRATE_FAULT_GATES = {"f1_torn_notice": "published",
                       "f2_unpublished_step": "prestage",
                       "f3_poisoned_bundle": "prestage",
                       "f4_stale_cut": "losses"}


def _migrate_sc(name: str, ckpt_dir: str, steps: int, **kw) -> dict:
    """A migrate_check scenario of phase train's ResNet-50 job."""
    return dict(name=name, model="resnet50", depth=DEPTH, classes=CLASSES,
                image=IMAGE, batch=BATCH, schedule=MIGRATE_STEPS,
                steps=steps, every=10, ckpt_dir=ckpt_dir, device=DEVICE,
                **kw)


def _loss_diff(got: list, want: list) -> float:
    """The largest |got - want| over the steps, inf when the counts
    differ."""
    if len(got) != len(want):
        return float("inf")
    return max((abs(a - b) for a, b in zip(got, want)), default=0.0)


def _source_problems(line: dict, at: int, train_losses: list,
                     published: int) -> list:
    """The source's gates, (gate, message) each: drained at step ``at``
    as a MOVE, its cut published once (``published``: the server's
    publish count over the run), steps 1..at bitwise phase train's."""
    out = []
    if not line["drained"] or line["drain_step"] != at:
        out.append(("drained", "drained %r at step %r, not at %d"
                    % (line["drained"], line["drain_step"], at)))
    if line["drain_reason"] != "migrate":
        out.append(("reason", "drain_reason %r" % line["drain_reason"]))
    pub = line["migrate_published"] or {}
    if pub.get("step") != at or published != 1:
        out.append(("published", "published %r, %d on the server"
                    % (pub, published)))
    got = migrate_check.losses(line)
    if not _loss_diff(got, train_losses[:at]) <= TRAIN_TOL:
        out.append(("losses", "steps 1-%d are not phase train's: %r vs %r"
                    % (at, got, train_losses[:at])))
    return out


def _destination_problems(line: dict, at: int, total: int,
                          train_losses: list, entries: list) -> list:
    """The destination's gates, (gate, message) each: step ``at``
    pre-staged and restored, steps at+1..total bitwise phase train's with
    one B1 launch each, no ``.prestage_*`` entry left among ``entries``
    (its checkpoint dir's)."""
    out = []
    if line["migrate_prefetched_step"] != at:
        out.append(("prestage", "pre-staged %r, not step %d"
                    % (line["migrate_prefetched_step"], at)))
    if line["resume_steps"] != [at]:
        out.append(("restore", "restored %r, not [%d]"
                    % (line["resume_steps"], at)))
    got = migrate_check.losses(line)
    want = train_losses[at:total]
    if not _loss_diff(got[:len(want)], want) <= TRAIN_TOL \
            or len(got) != len(want):
        out.append(("losses", "steps %d-%d are not phase train's: %r vs %r"
                    % (at + 1, total, got, want)))
    if line["launches"]["fused_sgd"] != total - at:
        out.append(("launches", "B1 launched %d times, not %d"
                    % (line["launches"]["fused_sgd"], total - at)))
    left = [n for n in entries if n.startswith(".prestage_")]
    if left:
        out.append(("leftovers", "left in the checkpoint dir: %r" % left))
    return out


def _fallback_problems(line: dict, train_losses: list) -> list:
    """A destination whose pre-stage missed: nothing pre-staged or
    restored, and its steps from 0 bitwise phase train's."""
    out = []
    if line["migrate_prefetched_step"] is not None or line["resume_steps"]:
        out.append("pre-staged %r, restored %r"
                   % (line["migrate_prefetched_step"],
                      line["resume_steps"]))
    got = migrate_check.losses(line)
    if not _loss_diff(got, train_losses[:len(got)]) <= TRAIN_TOL or \
            len(got) != MIGRATE_FAULT_STEPS:
        out.append("its %d steps from 0 are not phase train's: %r"
                   % (len(got), got))
    return out


def phase_train_migrate(smi: str, train_losses: list) -> dict:
    """The live-migration MOVE on its own: phase train's ResNet-50 v1.5
    job (224x224, batch 128, bf16 on fp32 params, ``fused_sgd`` (B1) at
    ``cosine_schedule(0.4, 30, 1)``, momentum 0.9, wd 1e-4, deterministic
    cuDNN, a checkpoint every 10 steps) moved mid-run through the port's
    ``ArtifactServer``, run here in a thread over a temporary store, with
    ``TPUJOB_ARTIFACT_STORE=0`` and ``TPUJOB_ARTIFACT_URL`` at the server,
    so that the state bundle rides HTTP only:

    (a) the source, in this process: the operator's notice
        ``{"namespace": "smoke", "name": "resnet50"}`` is written to
        ``TPUJOB_MIGRATE_FILE`` from step MIGRATE_AT's loss call; the run
        drains at that step as a MOVE and publishes its fresh cut once;
        its steps bitwise ``train_losses``;
    (b) the destination, a fresh process (``migrate_check``, through
        ``python -m paddle_operator_tpu_torch.launch``) started after the
        source exits, with ``TPUJOB_MIGRATE_STATE=smoke/resnet50:13`` and
        an empty checkpoint dir: it pre-stages and restores step 13 and
        trains to 30, steps 14-30 bitwise ``train_losses``, one B1 launch
        a step, no ``.prestage_*`` entry left;
    (c) four planted faults, each of which makes its gate
        (MIGRATE_FAULT_GATES) fire: f1, a torn notice
        (``{"namespace": ``): the source drains clean as a MOVE and
        publishes nothing; f2, a destination naming an unpublished step:
        the pre-stage misses and the run starts from step 0, bitwise
        phase train's; f3, a byte of the stored bundle flipped on the
        server's disk after (b): the server quarantines it
        (``poisoned_quarantined`` 1) and the destination falls back as in
        f2, assembling no step dir; f4, the step-10 dir published under
        step 13's key: the destination resumes, and the bitwise loss gate
        of (b) fails.

    Every loss comparison is at TRAIN_TOL (0). Printed beside the card:
    the bundle's and ``state.npz``'s bytes, the publish, pre-stage and
    restore seconds, the blackout by part (``migrate_check.blackout``)
    and the phase's seconds."""
    t0 = time.perf_counter()
    at, total = MIGRATE_AT, MIGRATE_STEPS
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_migrate_")
    dirs = {k: os.path.join(tmp, k) for k in (
        "store", "src", "dst", "f1", "f2", "f3", "f4")}
    notice = os.path.join(tmp, "migrate.json")
    move = {"namespace": MIGRATE_NS, "name": MIGRATE_NAME}
    key = "%s/%s" % (MIGRATE_NS, MIGRATE_NAME)
    fp = state_fingerprint(MIGRATE_NS, MIGRATE_NAME, at)
    runs, faults, counts = {}, {}, {}
    try:
        with ArtifactServer("127.0.0.1:0", store_dir=dirs["store"]) as srv, \
                migrate_check.environ(TPUJOB_ARTIFACT_STORE="0",
                                      TPUJOB_ARTIFACT_URL=srv.url,
                                      TPUJOB_MIGRATE_STATE=None,
                                      TPUJOB_MIGRATE_FILE=notice):
            def published() -> int:
                return srv.state.snapshot()["publish"]

            before = published()
            runs["source"] = migrate_check.run_scenario(_migrate_sc(
                "source", dirs["src"], total,
                notice={"file": notice, "at": at - 1, "intent": move}))
            counts["source_publishes"] = published() - before
            os.remove(notice)
            with migrate_check.environ(TPUJOB_MIGRATE_FILE=None):
                runs["destination"] = migrate_check.launch(
                    {"out": os.path.join(tmp, "pod"), "scenarios": [
                        _migrate_sc("destination", dirs["dst"], total)]},
                    env={"TPUJOB_MIGRATE_STATE": "%s:%d" % (key, at),
                         "TPUJOB_ARTIFACT_URL": srv.url,
                         "TPUJOB_ARTIFACT_STORE": "0"})["destination"]
            bundle_path = os.path.join(dirs["store"], fp + ".tpuart")
            sizes = {"bundle": os.path.getsize(bundle_path),
                     "state_npz": os.path.getsize(os.path.join(
                         dirs["src"], "step_%012d" % at, "state.npz"))}
            # (c) the planted faults
            before = published()
            faults["f1_torn_notice"] = migrate_check.run_scenario(
                _migrate_sc("f1", dirs["f1"], total, notice={
                    "file": notice, "at": MIGRATE_FAULT_STEPS - 1,
                    "raw": '{"namespace": '}))
            counts["f1_publishes"] = published() - before
            os.remove(notice)
            with migrate_check.environ(TPUJOB_MIGRATE_FILE=None):
                with migrate_check.environ(
                        TPUJOB_MIGRATE_STATE="%s:%d" % (key, at + 1)):
                    faults["f2_unpublished_step"] = \
                        migrate_check.run_scenario(_migrate_sc(
                            "f2", dirs["f2"], MIGRATE_FAULT_STEPS))
                blob = bytearray(open(bundle_path, "rb").read())
                blob[len(blob) // 2] ^= 0xFF
                with open(bundle_path, "wb") as f:
                    f.write(bytes(blob))
                del blob
                quarantined = srv.state.snapshot()["poisoned_quarantined"]
                with migrate_check.environ(
                        TPUJOB_MIGRATE_STATE="%s:%d" % (key, at)):
                    faults["f3_poisoned_bundle"] = \
                        migrate_check.run_scenario(_migrate_sc(
                            "f3", dirs["f3"], MIGRATE_FAULT_STEPS))
                    counts["f3_quarantined"] = srv.state.snapshot()[
                        "poisoned_quarantined"] - quarantined
                    ArtifactStore(url=srv.url).publish(fp, pack_state_dir(
                        os.path.join(dirs["src"], "step_%012d" % 10)))
                    faults["f4_stale_cut"] = migrate_check.run_scenario(
                        _migrate_sc("f4", dirs["f4"],
                                    at + MIGRATE_FAULT_STEPS))
            leftovers = {k: sorted(os.listdir(dirs[k]))
                         if os.path.isdir(dirs[k]) else []
                         for k in ("dst", "f2", "f3", "f4")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        cudnn.deterministic, cudnn.benchmark = saved
    src, dst = runs["source"], runs["destination"]
    gates = {"source": _source_problems(src, at, train_losses,
                                        counts["source_publishes"]),
             "destination": _destination_problems(
                 dst, at, total, train_losses, leftovers["dst"])}
    gates["f1_torn_notice"] = _source_problems(
        faults["f1_torn_notice"], MIGRATE_FAULT_STEPS, train_losses,
        counts["f1_publishes"])
    for name in ("f2_unpublished_step", "f3_poisoned_bundle",
                 "f4_stale_cut"):
        gates[name] = _destination_problems(
            faults[name], at, at + MIGRATE_FAULT_STEPS, train_losses,
            leftovers[name[:2]])
    parts = migrate_check.blackout(src, dst)
    keep = ("steps", "resume_steps", "drained", "drain_step",
            "drain_reason", "migrate_published", "migrate_prefetched_step",
            "migrate_stages", "cycle_stages", "launches", "wall_s")
    out = {
        "phase": "train_migrate", "card": smi,
        "config": {"depth": DEPTH, "classes": CLASSES, "image": IMAGE,
                   "batch": BATCH, "steps": total, "move_at": at,
                   "checkpoint_every": 10, "tier": "http"},
        "runs": {k: {f: r[f] for f in keep} | {
            "losses": migrate_check.losses(r)}
            for k, r in (runs | faults).items()},
        "bytes": sizes, "server_counts": counts,
        "launches": {"fused_sgd": src["launches"]["fused_sgd"]
                     + dst["launches"]["fused_sgd"]},
        "publish_s": src["migrate_stages"].get("publish_s"),
        "prestage_s": dst["migrate_stages"].get("prestage_s"),
        "restore_s": dst["cycle_stages"][0]["restore_s"],
        "blackout": parts, "leftovers": leftovers,
        "gates": {k: [g for g, _ in v] for k, v in gates.items()},
        "tolerance": TRAIN_TOL, "seconds": time.perf_counter() - t0,
    }
    emit(out)
    print("train_migrate (%s): bundle %d bytes, state.npz %d bytes; "
          "publish %.3f s, pre-stage %.3f s, restore %.3f s" % (
              smi, sizes["bundle"], sizes["state_npz"], out["publish_s"],
              out["prestage_s"], out["restore_s"]), flush=True)
    print("train_migrate (%s): blackout %.3f s: %s" % (
        smi, parts["total_s"], ", ".join(
            "%s %.3f" % (k[:-2], v) for k, v in parts.items()
            if k != "total_s")), flush=True)
    print("train_migrate (%s): phase %.1f s" % (smi, out["seconds"]),
          flush=True)
    problems = [msg for name in ("source", "destination")
                for _, msg in gates[name]]
    for name, gate in MIGRATE_FAULT_GATES.items():
        if gate not in {g for g, _ in gates[name]}:
            problems.append("the %s gate missed the planted fault %s"
                            % (gate, name))
    f1 = {g for g, _ in gates["f1_torn_notice"]}
    if f1 & {"drained", "reason"}:
        problems.append("f1: the torn notice's source did not drain clean "
                        "as a MOVE: %r" % gates["f1_torn_notice"])
    for name in ("f2_unpublished_step", "f3_poisoned_bundle"):
        problems += ["%s: %s" % (name, p) for p in
                     _fallback_problems(faults[name], train_losses)]
    if counts["f3_quarantined"] != 1:
        problems.append("f3: the server quarantined %d bundles, not 1"
                        % counts["f3_quarantined"])
    if "step_%012d" % at in leftovers["f3"]:
        problems.append("f3: a step dir was assembled from the poisoned "
                        "bundle")
    if faults["f4_stale_cut"]["migrate_prefetched_step"] != at:
        problems.append("f4: the stale cut was not pre-staged")
    if problems:
        fail("train_migrate: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# train_tp: tensor parallelism (tp, and ResNet's classifier over fsdp)
# ---------------------------------------------------------------------------

#: the runs' steps: (a) and (d) the first of their one-process phases'
#: runs (train_gpt's 20, train's 30), (b) and (c) two, the planted faults
#: two
TP_STEPS = {"gpt_tp2": 3, "gpt_2layers_dp2_tp2": 2, "bert_2layers_tp4": 2,
            "resnet50_dp2_fsdp2": 3}
TP_FAULT_STEPS = 2
#: |loss(workers) - loss(one process)| / loss allowed at each step: for
#: GPT and BERT train_dp's GPT class (DP_GPT_RTOL; on an H100 80GB HBM3
#: at 700 W (a) read 8.5e-6, (b) 1.7e-6, (c) 1.8e-6). For ResNet-50,
#: phase train's job (lr 0.4): the class of ``tp_check --run
#: resnet50_dp2_fsdp2`` over seeds 0-3 on the same card, where one
#: process with its parameters one ulp up parted from itself by up to
#: 3.1e-2 in 3 steps (6.1e-3, 6.8e-3, 9.3e-3, 3.1e-2) and the dp2 x fsdp2
#: world by 9.8e-3, 1.3e-2, 1.6e-3, 2.5e-2; train_dp's 5e-3 was read at
#: lr 0.01
TP_LOSS_RTOL = {"gpt": DP_GPT_RTOL, "bert": DP_GPT_RTOL, "resnet": 3.5e-2}
#: the same at step 0, before any update (the forward's rounding alone):
#: ResNet's train_dp class, DP_RESNET_RTOL (the readings above: 2.9e-4 -
#: 1.6e-3 for the world, 2.4e-4 - 1.1e-3 one ulp up)
TP_LOSS0_RTOL = {"resnet": DP_RESNET_RTOL}
#: step 0's gradients against one process's, each tile against its slice:
#: the largest ||g - g_one|| / ||g_one|| over the leaves, by model. GPT
#: and BERT: train_gpt's gradient class, GPT_GRAD_RTOL. ResNet's are read
#: in fp32 compute (``tp_check.grad_job``: in bf16 one ulp of the
#: parameters moves them by 0.99-1.11 over the tree). Its limit lies
#: between the class of ``tp_check --run resnet50_dp2_fsdp2`` on an H100
#: 80GB HBM3 at 700 W over seeds 0-3, where one process one ulp up parted
#: from itself by up to 2.75e-2 - 3.1e-2 at its farthest leaf and the
#: dp2 x fsdp2 world by 3.2e-2 - 4.1e-2 (1.6 times the ulp's at most,
#: leaf by leaf), and the planted fault's lowest reading, 1.16
TP_GRAD_RTOL = {"gpt": GPT_GRAD_RTOL, "bert": GPT_GRAD_RTOL, "resnet": 0.1}
#: the run each planted fault (``tp_check.FAULTS``) is planted in, and the
#: gate that must reject it
TP_FAULTS = {"row_sum_dropped": ("gpt_2layers_dp2_tp2", "loss"),
             "column_input_unsummed": ("gpt_2layers_dp2_tp2", "grads"),
             "norm_without_tp": ("gpt_2layers_dp2_tp2", "replicas"),
             "vocab_shifted": ("gpt_2layers_dp2_tp2", "loss"),
             "fsdp_gather_slice": ("resnet50_dp2_fsdp2", "grads")}
#: B2 at a tp rank's shapes: (a)'s 16 sequences on 6 of the 12 heads, and
#: (b)'s dp block of 8 on 6
TP_FLASH_CASES = tuple(
    ("tp_rank", (b, gpt.BASE_CONFIG["heads"] // 2, GPT_SEQ,
                 gpt.BASE_CONFIG["hidden"] // gpt.BASE_CONFIG["heads"]),
     "bfloat16", True) for b in (GPT_BATCH, GPT_BATCH // 2))


def tp_launches_per_step(run: str) -> dict:
    """B1 and B2 launches of a rank a step on the tp path, from the code:
    GPT's flash forward twice a layer (remat), dq and dkv once; ResNet's
    one fused SGD update; BERT's mask takes the einsum path."""
    model, layers, _, _ = tp_check.CARD_RUNS[run]
    if model == "gpt":
        return {"flash_fwd": 2 * layers, "flash_dq": layers,
                "flash_dkv": layers, "fused_sgd": 0}
    return {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
            "fused_sgd": int(model == "resnet")}


def _tp_problems(name: str, lines: list, one: list) -> list:
    """``(gate, message)`` of every gate a run of the phase fails: the
    global loss (the ranks' mean) within TP_LOSS_RTOL of one process's at
    every step (TP_LOSS0_RTOL at step 0); step 0's gradients within
    TP_GRAD_RTOL; replicas (the
    replicated leaves bitwise on every rank after every step and at the
    end, each tile bitwise on its dp replicas; equal clip norms); B1 and
    B2 launches of a rank a step; finite losses."""
    run = lines[0]["run"]
    model, _, axes, _ = tp_check.CARD_RUNS[run]
    problems = []
    steps = len(lines[0]["losses"])
    losses = np.mean([r["losses"] for r in lines], axis=0).tolist()
    rel = rel_diffs(losses, one)
    if len(rel) != steps or not max(rel) <= TP_LOSS_RTOL[model] \
            or not rel[0] <= TP_LOSS0_RTOL.get(model, TP_LOSS_RTOL[model]):
        problems.append(("loss", "%s losses part from one process's by %r"
                         % (name, rel)))
    rep = [[p[0] for p in r["fingerprints"]] for r in lines]
    same = all(x == rep[0] for x in rep) and len(
        {r["replicated"] for r in lines}) == 1
    per = len(lines) // axes.get("dp", 1)
    for r in range(per, len(lines)):
        same = same and [p[1] for p in lines[r]["fingerprints"]] == [
            p[1] for p in lines[r % per]["fingerprints"]] and \
            lines[r]["tiles"] == lines[r % per]["tiles"]
    if len({tuple(r["grad_norms"]) for r in lines}) != 1:
        same = False
    if not same:
        problems.append(("replicas", "%s replicas differ (clip norms %r)"
                         % (name, [r["grad_norms"] for r in lines])))
    want = {k: v * steps for k, v in tp_launches_per_step(run).items()}
    for r in lines:
        if not r["grads"]["max_rel_diff"] <= TP_GRAD_RTOL[model]:
            problems.append(("grads", "%s rank %d's step-0 gradients part "
                             "from one process's by %g at %s"
                             % (name, r["rank"], r["grads"]["max_rel_diff"],
                                r["grads"]["leaf"])))
        if any(r["launches"][k] != v for k, v in want.items()):
            problems.append(("launches", "%s rank %d launched %r, expected "
                             "%r" % (name, r["rank"], r["launches"], want)))
        if not r["split_leaves"]:
            problems.append(("layout", "%s rank %d holds no tile"
                             % (name, r["rank"])))
        if not all(np.isfinite(x) for x in r["losses"]):
            problems.append(("loss", "%s: a loss is not finite" % name))
    return problems


def _tp_scenarios(runs, grads: dict) -> list:
    """The card scenarios of ``runs`` sound, and (for the four-worker
    world) each planted fault in its run."""
    out = [{"kind": "card", "name": run, "run": run, "steps": TP_STEPS[run],
            "grads_ref": grads[run]} for run in runs]
    for fault, (run, _) in TP_FAULTS.items():
        if run in runs:
            out.append({"kind": "card", "name": run + "_" + fault,
                        "run": run, "steps": TP_FAULT_STEPS,
                        "fault": fault, "grads_ref": grads[run]})
    return out


def phase_train_tp(smi: str, gpt_losses: list = None,
                   resnet_losses: list = None) -> dict:
    """Tensor parallelism through the port's path: the reference's
    ``gpt_rules``, ``bert_rules`` and ``resnet_rules`` honoured by the
    train step over tp and fsdp (each rank holds its tile of every split
    leaf and of its optimizer state; Megatron's column- and row-parallel
    layers, the vocabulary split by rows and columns, ResNet's classifier
    gathered over fsdp), through ``run_training`` with the jobs'
    ``mesh_axes`` set as the reference's tests set them, under the
    one-process phases' numerics (TF32 off, deterministic cuDNN, and for
    GPT and BERT deterministic algorithms):

    (a) phase train_gpt's job (GPT-2 small at full width and depth, bf16,
        remat, the chunked head, adamw) on ``{"tp": 2}``, two workers,
        TP_STEPS steps, B2 on each rank's 6 heads, against train_gpt's
        first losses (``gpt_losses``, or one process run here);
    (b) the same at 2 layers on ``{"dp": 2, "tp": 2}``, four workers,
        against one process of that job;
    (c) BERT-base at 2 layers, 16 x 512, on ``{"tp": 4}`` (30522 does not
        divide by 4: the vocabulary's leaves stay whole, every layer's
        heads and MLP are split), against one process;
    (d) phase train's ResNet-50 job (``migrate_check.resnet_job``, batch
        128, ``fused_sgd``) on ``{"dp": 2, "fsdp": 2}``, against train's
        first losses (``resnet_losses``, or one process run here);

    and each planted fault of ``tp_check.FAULTS`` in (b) or (d), which its
    gate (TP_FAULTS) must reject. The workers start through ``python -m
    paddle_operator_tpu_torch.launch``; NCCL a card each where the
    machine has a card a worker, else gloo on this card (a correctness
    run, not a rate); the world of two and the world of four run at the
    same time. Gates: :func:`_tp_problems`. Printed: the tp
    collectives' count, bytes and host seconds a step, step ms a rank,
    peak GB a rank and the phase's seconds."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    lines: list = []
    backends = {}
    try:
        given = {"gpt_tp2": gpt_losses, "resnet50_dp2_fsdp2": resnet_losses}
        refs = {run: tp_check.one_process(
                    run, 0 if given.get(run) else TP_STEPS[run], tmp)
                for run in tp_check.CARD_RUNS}
        one = {run: (given.get(run) or r["losses"])[:TP_STEPS[run]]
               for run, r in refs.items()}
        grads = {run: r["grads"] for run, r in refs.items()}
        torch.cuda.empty_cache()
        t_world = time.perf_counter()
        for world in (2, 4):
            backends[world] = "nccl" if torch.cuda.device_count() >= world \
                else "gloo"

        def world_lines(world: int) -> list:
            runs = [r for r, spec in tp_check.CARD_RUNS.items()
                    if spec[3] == world]
            return tp_check.launch(
                {"out": os.path.join(tmp, "world%d" % world),
                 "scenarios": _tp_scenarios(runs, grads)},
                world=world, backend=backends[world], timeout=900)

        # the two worlds run at once (their workers share the host and
        # the card): one world's start overlaps the other's steps
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            for got in list(pool.map(world_lines, (2, 4))):
                for rank_lines in got:
                    lines += rank_lines
        world_s = time.perf_counter() - t_world
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs: dict = {}
    for line in lines:
        runs.setdefault(line["scenario"], []).append(line)
    runs = {k: sorted(v, key=lambda r: r["rank"]) for k, v in runs.items()}
    gates, summary = {}, {}
    for name, rs in runs.items():
        run = rs[0]["run"]
        gates[name] = _tp_problems(name, rs, one[run][:len(rs[0]["losses"])])
        steps = len(rs[0]["losses"])
        losses = np.mean([r["losses"] for r in rs], axis=0).tolist()
        summary[name] = {
            "losses": losses, "one_process_losses": one[run],
            "max_rel_loss_diff_vs_one_process": max(rel_diffs(losses,
                                                              one[run])),
            "grads": [r["grads"] for r in rs],
            "grad_norms_rank0": rs[0]["grad_norms"],
            "step_ms_median": [statistics.median(r["step_ms"][1:] or
                                                 r["step_ms"]) for r in rs],
            "tp_traffic_per_step": [
                {k: v / steps for k, v in r["tp_traffic"].items()}
                for r in rs],
            "launches": [r["launches"] for r in rs],
            "expected_per_step": tp_launches_per_step(run),
            "split_leaves": rs[0]["split_leaves"],
            "peak_gb": [r["peak_gb"] for r in rs],
            "mesh_history": [r["mesh_history"] for r in rs],
            "wall_s": [r["wall_s"] for r in rs],
            "gates_failed": sorted({g for g, _ in gates[name]})}
    out = {"phase": "train_tp", "card": smi,
           "backends": {str(k): v for k, v in backends.items()},
           "note": "workers share this one card over gloo: a correctness "
                   "check, not a multi-GPU rate"
                   if "gloo" in backends.values() else "a card a worker",
           "runs": summary,
           "tolerance": {"loss_rel": TP_LOSS_RTOL,
                         "step0_loss_rel": TP_LOSS0_RTOL,
                         "grad_rel": TP_GRAD_RTOL},
           "world_s": world_s, "seconds": time.perf_counter() - t0}
    emit(out)
    for name in tp_check.CARD_RUNS:
        r = summary[name]
        t = r["tp_traffic_per_step"][0]
        print("train_tp %s (%s, %s): tp collectives a step a rank %d "
              "(%d sums forward, %d backward, %d max, %d argmax, %d "
              "gathers), %.1f MB, %.3f s host; step ms a rank %s; peak GB "
              "%s; off one process by %.3g" % (
                  name, smi, backends[tp_check.CARD_RUNS[name][3]],
                  sum(t[k] for k in ("sum_forward", "sum_backward", "max",
                                     "argmax", "gather")),
                  t["sum_forward"], t["sum_backward"], t["max"],
                  t["argmax"], t["gather"], t["bytes"] / 1e6, t["seconds"],
                  ["%.1f" % x for x in r["step_ms_median"]],
                  ["%.2f" % x for x in r["peak_gb"]],
                  r["max_rel_loss_diff_vs_one_process"]), flush=True)
    print("train_tp (%s): phase %.1f s, worlds %.1f s"
          % (smi, out["seconds"], world_s), flush=True)
    problems = []
    for name, p in gates.items():
        fault = runs[name][0]["fault"]
        if fault:
            if TP_FAULTS[fault][1] not in {g for g, _ in p}:
                problems.append("the %s gate missed the planted fault %s"
                                % (TP_FAULTS[fault][1], fault))
        else:
            problems += [msg for _, msg in p]
    missing = set(tp_check.CARD_RUNS) - set(runs)
    if missing:
        problems.append("runs missing: %s" % sorted(missing))
    if problems:
        fail("train_tp: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# train_pp: GPipe over a pp axis
# ---------------------------------------------------------------------------

#: |loss(pipelined) - loss(one process)| / loss allowed at each step:
#: train_dp's GPT class, DP_GPT_RTOL. On an H100 80GB HBM3 at 700 W
#: (``python -m paddle_operator_tpu_torch.pp_check``, seeds 0-2) one
#: process one ulp up parted from itself by 7.9e-7 - 1.4e-6 in 3 steps
#: and the pipeline by 6.2e-7 - 1.3e-6; the planted faults' lowest
#: step-0 reading is 3.3e-4 (stages swapped; a bank a tick early 3.8e-4)
PP_LOSS_RTOL = DP_GPT_RTOL
#: the largest ||g - g_one|| / ||g_one|| of step 0's gradients over the
#: leaves (each rank's stage against its block): train_gpt's class,
#: GPT_GRAD_RTOL, between the same readings' one ulp up (0.0173 -
#: 0.0181 at the farthest leaf; the pipeline 0.0025 - 0.0027) and the
#: faults' lowest, 1.49
PP_GRAD_RTOL = GPT_GRAD_RTOL
PP_FAULT_STEPS = 1
#: B2 at a stage's shape: a microbatch of 2 sequences on the 12 heads,
#: held against its plain versions in the kernels phase
PP_FLASH_CASES = (
    ("pp_microbatch", (pp_check.CARD_BATCH // pp_check.CARD_MICRO,
                       gpt.BASE_CONFIG["heads"], pp_check.CARD_SEQ,
                       gpt.BASE_CONFIG["hidden"] // gpt.BASE_CONFIG["heads"]),
     "bfloat16", True),)
#: each planted fault (``pp_check.FAULTS``) and the gate that must reject
#: it
PP_FAULTS = {"sum_backward_reduces": "grads", "bank_one_early": "loss",
             "stages_swapped": "grads"}


def pp_bubble(n_stages: int = pp_check.CARD_STAGES,
              n_micro: int = pp_check.CARD_MICRO) -> float:
    """GPipe's bubble, the ticks a stage idles over a sweep:
    (S - 1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _pp_problems(name: str, lines: list, one: list) -> list:
    """``(gate, message)`` of every gate a train_pp run fails: every
    rank's loss (the same on every rank) within PP_LOSS_RTOL of one
    process's at every step; step 0's gradients within PP_GRAD_RTOL;
    replicas (the replicated leaves, the embedding, the final LayerNorm
    and the head, bitwise on every rank after every step; every rank's
    losses bitwise equal); the flash launches of a rank a step
    (``pp_check.launches_per_step``); finite losses."""
    problems = []
    steps = len(lines[0]["losses"])
    rel = rel_diffs(lines[0]["losses"], one)
    if len(rel) != steps or not max(rel) <= PP_LOSS_RTOL:
        problems.append(("loss", "%s losses part from one process's by %r"
                         % (name, rel)))
    if len({json.dumps(r["fingerprints"]) for r in lines}) != 1 or len(
            {r["rest_digest"] for r in lines}) != 1 or len(
            {tuple(r["losses"]) for r in lines}) != 1:
        problems.append(("replicas", "%s replicated leaves or losses "
                         "differ between ranks" % name))
    want = {k: v * steps for k, v in pp_check.launches_per_step().items()}
    for r in lines:
        if not r["grads"]["max_rel_diff"] <= PP_GRAD_RTOL:
            problems.append(("grads", "%s rank %d's step-0 gradients part "
                             "from one process's by %g at %s"
                             % (name, r["rank"], r["grads"]["max_rel_diff"],
                                r["grads"]["leaf"])))
        if any(r["launches"][k] != v for k, v in want.items()):
            problems.append(("launches", "%s rank %d launched %r, expected "
                             "%r" % (name, r["rank"], r["launches"], want)))
        if not all(np.isfinite(x) for x in r["losses"]):
            problems.append(("loss", "%s: a loss is not finite" % name))
    return problems


def phase_train_pp(smi: str) -> dict:
    """GPipe over a ``pp`` axis through the port's path
    (``parallel.pipeline.pipeline_apply``): GPT-2 small at full width and
    depth (hidden 768, 12 heads, T 1024, bf16 compute on fp32 params,
    dense) with its 12 blocks split into four stages of three on ``{"pp":
    4}``, four workers; the token embedding, the final LayerNorm and the
    chunked LM-head cross-entropy on every rank; a batch of 8 x 1024 as 4
    microbatches of 2; the loss and the gradients of the stacked blocks
    (each rank its stage's) and of the replicated leaves, and an adamw
    step, ``pp_check.CARD_STEPS`` times (``pp_check.card_run``), under
    deterministic algorithms with TF32 off.

    Against one process running the 12 blocks in sequence on the same
    parameters and whole batches (``pp_check.one_process``, the
    reference's ``test_pipeline_matches_sequential`` at full width), and
    each planted fault of ``pp_check.FAULTS`` for PP_FAULT_STEPS steps,
    which its gate (PP_FAULTS) must reject. B2 runs on every tick of every
    stage, junk ticks included, and in the backward of every tick: a rank
    launches (M + S - 1) x 3 flash forwards, dq and dkv a step (21 each;
    no remat). The workers start through ``python -m
    paddle_operator_tpu_torch.launch``; NCCL a card each where the
    machine has a card a worker, else gloo on this card (a correctness
    run, not a rate). Gates: :func:`_pp_problems`. Printed: step ms a
    rank, the pp hops a step with their bytes and host seconds, the
    bubble share, peak GB a rank and the phase's seconds."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    world = pp_check.CARD_STAGES
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    try:
        ref = pp_check.one_process(tmp)
        torch.cuda.empty_cache()
        t_world = time.perf_counter()
        mesh = {"pp": world}
        scenarios = [{"kind": "card", "name": "pp4", "mesh": mesh,
                      "steps": pp_check.CARD_STEPS,
                      "grads_ref": ref["grads"]}]
        scenarios += [{"kind": "card", "name": "pp4_" + fault, "mesh": mesh,
                       "steps": PP_FAULT_STEPS, "fault": fault,
                       "grads_ref": ref["grads"]} for fault in PP_FAULTS]
        lines = [ln for r in pp_check.launch(
            {"out": os.path.join(tmp, "world"), "scenarios": scenarios},
            world=world, backend=backend, timeout=600) for ln in r]
        world_s = time.perf_counter() - t_world
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs: dict = {}
    for line in lines:
        runs.setdefault(line["scenario"], []).append(line)
    runs = {k: sorted(v, key=lambda r: r["rank"]) for k, v in runs.items()}
    gates, summary = {}, {}
    for name, rs in runs.items():
        steps = len(rs[0]["losses"])
        gates[name] = _pp_problems(name, rs, ref["losses"][:steps])
        summary[name] = {
            "losses": rs[0]["losses"], "one_process_losses": ref["losses"],
            "max_rel_loss_diff_vs_one_process": max(rel_diffs(
                rs[0]["losses"], ref["losses"])),
            "grads": [r["grads"] for r in rs],
            "step_ms": [r["step_ms"] for r in rs],
            "step_ms_median": [statistics.median(r["step_ms"][1:] or
                                                 r["step_ms"]) for r in rs],
            "pp_traffic_per_step": [
                {k: v / steps for k, v in r["pp_traffic"].items()}
                for r in rs],
            "launches": [r["launches"] for r in rs],
            "expected_per_step": pp_check.launches_per_step(),
            "peak_gb": [r["peak_gb"] for r in rs],
            "wall_s": [r["wall_s"] for r in rs],
            "gates_failed": sorted({g for g, _ in gates[name]})}
    out = {"phase": "train_pp", "card": smi, "backend": backend,
           "note": "workers share this one card over gloo: a correctness "
                   "check, not a multi-GPU rate"
                   if backend == "gloo" else "a card a worker",
           "stages": world, "microbatches": pp_check.CARD_MICRO,
           "bubble_share": pp_bubble(), "runs": summary,
           "tolerance": {"loss_rel": PP_LOSS_RTOL, "grad_rel": PP_GRAD_RTOL},
           "world_s": world_s, "seconds": time.perf_counter() - t0}
    emit(out)
    sound = summary.get("pp4")
    if sound is not None:
        t = sound["pp_traffic_per_step"][0]
        print("train_pp (%s, %s): GPT-2 small, 12 blocks as %d stages of "
              "3, %d microbatches of %d; bubble %.4f; pp collectives a step "
              "a rank: %d hops forward, %d back, %d output sums, %d input "
              "sums, %.1f MB, %.3f s host; step ms a rank %s; peak GB %s; "
              "off one process by %.3g" % (
                  smi, backend, world, pp_check.CARD_MICRO,
                  pp_check.CARD_BATCH // pp_check.CARD_MICRO, pp_bubble(),
                  t["hop"], t["hop_backward"], t["sum_forward"],
                  t["sum_backward"], t["bytes"] / 1e6, t["seconds"],
                  ["%.1f" % x for x in sound["step_ms_median"]],
                  ["%.2f" % x for x in sound["peak_gb"]],
                  sound["max_rel_loss_diff_vs_one_process"]), flush=True)
    print("train_pp (%s): phase %.1f s, world %.1f s"
          % (smi, out["seconds"], world_s), flush=True)
    problems = []
    for name, p in gates.items():
        fault = runs[name][0]["fault"]
        if fault:
            if PP_FAULTS[fault] not in {g for g, _ in p}:
                problems.append("the %s gate missed the planted fault %s"
                                % (PP_FAULTS[fault], fault))
        else:
            problems += [msg for _, msg in p]
    missing = ({"pp4"} | {"pp4_" + f for f in PP_FAULTS}) - set(runs)
    if missing:
        problems.append("runs missing: %s" % sorted(missing))
    if problems:
        fail("train_pp: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# train_hybrid: tp beside sp and ep, MoE under tp
# ---------------------------------------------------------------------------

HYBRID_STEPS = 2
HYBRID_FAULT_STEPS = 1
#: per run (on an H100 80GB HBM3 at 700 W, ``python -m
#: paddle_operator_tpu_torch.hybrid_check``, seeds 0-2, 2 steps; "one
#: ulp" is one process with every parameter one ulp up against itself,
#: "the world" the eight workers against one process):
#: |loss(world) - loss(one process)| / loss allowed at each step: the
#: MoE-ep class, MOE_EP_LOSS_RTOL (routing flips; the world read up to
#: 3.8e-3 at (a)'s step 1, 8.0e-5 in (b); one ulp 2.2e-4 and 1.2e-4);
HYBRID_LOSS_RTOL = {"program1_bert_tiny_moe": MOE_EP_LOSS_RTOL,
                    "gpt_2layers_moe_tp2_sp2_ep2": MOE_EP_LOSS_RTOL}
#: the same at step 0 (the world up to 2.1e-4 and 2.9e-5; one ulp 7.8e-5
#: and 2.9e-5);
HYBRID_LOSS0_RTOL = {"program1_bert_tiny_moe": 1e-3,
                     "gpt_2layers_moe_tp2_sp2_ep2": 1e-3}
#: the step-0 clip norm against one process's gradients' norm: one ulp
#: read up to 1.8e-3 (a) and 8.2e-4 (b), the world 7.1e-4 and 1.1e-3;
#: the MoE leaves taken for tp tiles 1.1e-2 in (a);
HYBRID_NORM_RTOL = {"program1_bert_tiny_moe": 5e-3,
                    "gpt_2layers_moe_tp2_sp2_ep2": 5e-3}
#: the largest ||g - g_one|| / ||g_one|| of step 0's gradients over the
#: leaves (each tile against its slice): the MoE-ep class,
#: MOE_EP_GRAD_RTOL (one ulp up to 0.017 (a) and 0.18 (b), at (b)'s
#: near-zero attention key biases; the world 0.033 and 0.18; the
#: LayerNorms left unsummed over sp 0.78)
HYBRID_GRAD_RTOL = {"program1_bert_tiny_moe": MOE_EP_GRAD_RTOL,
                    "gpt_2layers_moe_tp2_sp2_ep2": MOE_EP_GRAD_RTOL}
#: each planted fault (``tp_check.HYBRID_FAULTS``): the run it is planted
#: in and the gate that must reject it
HYBRID_FAULTS = {
    "ln_grad_unsummed_over_sp": ("program1_bert_tiny_moe", "replicas"),
    "moe_leaves_as_tp_tiles": ("program1_bert_tiny_moe", "norm")}
#: B2 at (b)'s shapes, held against its plain versions in the kernels
#: phase: a ring hop of a tp rank's 6 heads of 12 on a 512-token sp
#: block of the 4 sequences, hop 0 causal and the other not
HYBRID_FLASH_CASES = tuple(
    ("ring_hop", (hybrid_check.GPT_BATCH, gpt.BASE_CONFIG["heads"] // 2,
                  hybrid_check.GPT_SEQ // 2,
                  gpt.BASE_CONFIG["hidden"] // gpt.BASE_CONFIG["heads"]),
     "bfloat16", causal) for causal in (True, False))
#: B4 at a rank's shapes on the hybrid path (as MOE_EP_B4_CASES, with the
#: global batch's tokens, width and experts): (b)'s rank, 2048 of the
#: 4096 tokens over its 4 of 8 experts; (a)'s, 32 of BERT TINY's 64
#: tokens (width 128) over its 2 of 4
HYBRID_B4_CASES = (
    ("hybrid_gpt_rank", 0, hybrid_check.GPT_BATCH * hybrid_check.GPT_SEQ
     // 2, MOE_EXPERTS // 2, MOE_EXPERTS // 2,
     hybrid_check.GPT_BATCH * hybrid_check.GPT_SEQ, 0, MOE_EXPERTS),
    ("program1_rank", 0, 32, 2, 2, 64, bert.TINY_CONFIG["hidden"], 4))


def hybrid_launches_per_step(run: str) -> dict:
    """B2 and B4 launches of a rank a step on the hybrid path, from the
    code. (a): BERT TINY's ring runs blockwise (a 16-token block is under
    the kernels' 256), no flash; both layers MoE, no remat. (b): each of
    the 2 layers' causal ring runs B2 on each of the sp 2 hops, the
    forward twice (remat), dq and dkv once; both layers MoE under
    remat. B4: :func:`moe_launches_per_step`."""
    model, axes = hybrid_check.CARD_RUNS[run]
    if model == "bert":
        cfg, remat, flash = hybrid_check.program1_config(axes["ep"]), \
            False, 0
    else:
        cfg = dict(gpt.BASE_CONFIG, layers=2, moe_experts=8, moe_every=1)
        remat, flash = True, cfg["layers"] * axes["sp"]
    return {"flash_fwd": 2 * flash, "flash_dq": flash, "flash_dkv": flash,
            **moe_launches_per_step(cfg, remat)}


def _same_on_holders(lines: list, axes: dict) -> bool:
    """Each group of leaves of :func:`tp_check.axes_digests` bitwise equal
    on the ranks that hold the same tiles of it (every rank for the
    replicated leaves); every rank's clip norms equal."""
    for key in lines[0]["axes_digests"]:
        split = [a for a in key.split(",") if a]
        seen: dict = {}
        for r in lines:
            holder = tuple(r["coords"][a] for a in split)
            seen.setdefault(holder, set()).add(r["axes_digests"].get(key))
        if any(len(v) != 1 for v in seen.values()):
            return False
    return len({tuple(r["grad_norms"]) for r in lines}) == 1


def hybrid_losses(lines: list) -> list:
    """A hybrid run's global loss a step: each rank's loss is its
    sequence block's part of its replica's, so the mean over the ranks
    times sp (the ranks along tp and ep hold the same tokens)."""
    sp = hybrid_check.CARD_RUNS[lines[0]["run"]][1].get("sp", 1)
    return (sp * np.mean([r["losses"] for r in lines], axis=0)).tolist()


def _hybrid_problems(name: str, lines: list, one: dict) -> list:
    """``(gate, message)`` of every gate a train_hybrid run fails: the
    global loss (:func:`hybrid_losses`) within HYBRID_LOSS_RTOL of one
    process's at every step (HYBRID_LOSS0_RTOL at step 0); the step-0
    clip norm within HYBRID_NORM_RTOL of one process's gradients' norm;
    step 0's gradients within HYBRID_GRAD_RTOL; replicas
    (:func:`_same_on_holders`); B2 and B4 launches of a rank a step;
    finite losses."""
    run = lines[0]["run"]
    problems = []
    steps = len(lines[0]["losses"])
    rel = rel_diffs(hybrid_losses(lines), one["losses"])
    if len(rel) != steps or not max(rel) <= HYBRID_LOSS_RTOL[run] \
            or not rel[0] <= HYBRID_LOSS0_RTOL[run]:
        problems.append(("loss", "%s losses part from one process's by %r"
                         % (name, rel)))
    norm = abs(lines[0]["grad_norms"][0] - one["grad_norm"]) / one[
        "grad_norm"]
    if not norm <= HYBRID_NORM_RTOL[run]:
        problems.append(("norm", "%s step-0 clip norm parts from one "
                         "process's by %g" % (name, norm)))
    if not _same_on_holders(lines, hybrid_check.CARD_RUNS[run][1]):
        problems.append(("replicas", "%s replicas differ" % name))
    want = {k: v * steps for k, v in hybrid_launches_per_step(run).items()}
    for r in lines:
        if not r["grads"]["max_rel_diff"] <= HYBRID_GRAD_RTOL[run]:
            problems.append(("grads", "%s rank %d's step-0 gradients part "
                             "from one process's by %g at %s"
                             % (name, r["rank"], r["grads"]["max_rel_diff"],
                                r["grads"]["leaf"])))
        if any(r["launches"][k] != v for k, v in want.items()):
            problems.append(("launches", "%s rank %d launched %r, expected "
                             "%r" % (name, r["rank"], r["launches"], want)))
        if not all(np.isfinite(x) for x in r["losses"]):
            problems.append(("loss", "%s: a loss is not finite" % name))
    return problems


def phase_train_hybrid(smi: str) -> dict:
    """The model axes beside each other and beside sp, through the port's
    path (``run_training`` -> ``build_train_step`` on a mesh of tp, sp
    and ep, the reference's rule tables), one world of eight workers
    under deterministic algorithms with TF32 off and the MoE kernels on:

    (a) the reference's dry-run program 1 (``__graft_entry__.py:65-96``):
        BERT TINY with 4 experts in every layer, ``moe_rules() +
        bert_rules()``, ``seq_axis="sp"``, adamw(1e-3) under the wd mask,
        clip 1.0, a batch of 2 x 32, on ``{"dp": 1, "tp": 2, "sp": 2,
        "ep": 2}``, HYBRID_STEPS steps: attention on each rank's 2 heads
        over the sp ring, B4 on each rank's 2 local experts;
    (b) GPT-2 small's width (768, 12 heads, T 1024) cut to 2 layers, 8
        experts in every layer, ``gpt_rules() + moe_rules()``, a batch of
        4 x 1024 on ``{"tp": 2, "sp": 2, "ep": 2}`` (``examples/
        train_gpt.make_job`` with ``TPUJOB_SP=2``), HYBRID_STEPS steps: B2
        on each rank's 6 heads on every ring hop, B4 on its 4 experts;

    each against one process of the same job (``hybrid_check.
    one_process``), and each planted fault of ``tp_check.HYBRID_FAULTS``
    in its run for HYBRID_FAULT_STEPS steps, which its gate (HYBRID_FAULTS)
    must reject. The workers start through ``python -m
    paddle_operator_tpu_torch.launch``; NCCL a card each where the
    machine has a card a worker, else gloo on this card (a correctness
    run, not a rate). Gates: :func:`_hybrid_problems`. Printed: step ms a
    rank, the tp, sp and ep collectives a step, peak GB a rank and the
    phase's seconds."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hybrid_")
    world = hybrid_check.CARD_WORKERS
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    try:
        one = {run: hybrid_check.one_process(run, HYBRID_STEPS, tmp)
               for run in hybrid_check.CARD_RUNS}
        torch.cuda.empty_cache()
        t_world = time.perf_counter()
        scenarios = [{"kind": "card", "name": run, "run": run,
                      "steps": HYBRID_STEPS, "grads_ref": one[run]["grads"]}
                     for run in hybrid_check.CARD_RUNS]
        scenarios += [{"kind": "card", "name": run + "_" + fault,
                       "run": run, "steps": HYBRID_FAULT_STEPS,
                       "fault": fault, "grads_ref": one[run]["grads"]}
                      for fault, (run, _) in HYBRID_FAULTS.items()]
        lines = [ln for r in hybrid_check.launch(
            {"out": os.path.join(tmp, "world"), "scenarios": scenarios},
            world=world, backend=backend, timeout=600) for ln in r]
        world_s = time.perf_counter() - t_world
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs: dict = {}
    for line in lines:
        runs.setdefault(line["scenario"], []).append(line)
    runs = {k: sorted(v, key=lambda r: r["rank"]) for k, v in runs.items()}
    gates, summary = {}, {}
    for name, rs in runs.items():
        run = rs[0]["run"]
        steps = len(rs[0]["losses"])
        ref = dict(one[run], losses=one[run]["losses"][:steps])
        gates[name] = _hybrid_problems(name, rs, ref)
        losses = hybrid_losses(rs)
        summary[name] = {
            "losses": losses, "one_process_losses": one[run]["losses"],
            "max_rel_loss_diff_vs_one_process": max(rel_diffs(
                losses, one[run]["losses"])),
            "step0_norm": rs[0]["grad_norms"][0],
            "one_process_step0_norm": one[run]["grad_norm"],
            "grads": [r["grads"] for r in rs],
            "step_ms_median": [statistics.median(r["step_ms"][1:] or
                                                 r["step_ms"]) for r in rs],
            "collectives_per_step": [
                {group: {k: v / steps for k, v in r[group].items()}
                 for group in ("tp_traffic", "sp_traffic", "moe_traffic")}
                for r in rs],
            "launches": [r["launches"] for r in rs],
            "expected_per_step": hybrid_launches_per_step(run),
            "peak_gb": [r["peak_gb"] for r in rs],
            "wall_s": [r["wall_s"] for r in rs],
            "gates_failed": sorted({g for g, _ in gates[name]})}
    out = {"phase": "train_hybrid", "card": smi, "backend": backend,
           "note": "workers share this one card over gloo: a correctness "
                   "check, not a multi-GPU rate"
                   if backend == "gloo" else "a card a worker",
           "runs": summary,
           "tolerance": {"loss_rel": HYBRID_LOSS_RTOL,
                         "step0_loss_rel": HYBRID_LOSS0_RTOL,
                         "norm_rel": HYBRID_NORM_RTOL,
                         "grad_rel": HYBRID_GRAD_RTOL},
           "world_s": world_s, "seconds": time.perf_counter() - t0}
    emit(out)
    for name in hybrid_check.CARD_RUNS:
        r = summary.get(name)
        if r is None:
            continue
        c = r["collectives_per_step"][0]
        tp, sp, ep = c["tp_traffic"], c["sp_traffic"], c["moe_traffic"]
        print("train_hybrid %s (%s, %s): collectives a step a rank: tp %d "
              "(%.1f MB, %.3f s host), sp %d hops %d all-to-alls (%.1f MB, "
              "%.3f s host), MoE %d (%.1f MB, %.3f s host); step ms a rank "
              "%s; peak GB %s; off one process by %.3g" % (
                  name, smi, backend,
                  sum(tp[k] for k in ("sum_forward", "sum_backward", "max",
                                      "argmax", "gather")),
                  tp["bytes"] / 1e6, tp["seconds"], sp["ring_shift"],
                  sp["all_to_all"], sp["bytes"] / 1e6, sp["seconds"],
                  sum(ep[k] for k in ("routing", "sum_forward",
                                      "sum_backward")),
                  ep["bytes"] / 1e6, ep["seconds"],
                  ["%.1f" % x for x in r["step_ms_median"]],
                  ["%.2f" % x for x in r["peak_gb"]],
                  r["max_rel_loss_diff_vs_one_process"]), flush=True)
    print("train_hybrid (%s): phase %.1f s, world %.1f s"
          % (smi, out["seconds"], world_s), flush=True)
    problems = []
    for name, p in gates.items():
        fault = runs[name][0]["fault"]
        if fault:
            if HYBRID_FAULTS[fault][1] not in {g for g, _ in p}:
                problems.append("the %s gate missed the planted fault %s"
                                % (HYBRID_FAULTS[fault][1], fault))
        else:
            problems += [msg for _, msg in p]
    missing = (set(hybrid_check.CARD_RUNS) | {
        run + "_" + f for f, (run, _) in HYBRID_FAULTS.items()}) - set(runs)
    if missing:
        problems.append("runs missing: %s" % sorted(missing))
    if problems:
        fail("train_hybrid: " + "; ".join(problems))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU", file=sys.stderr)
        return 2
    # cuBLAS reads this when its handle is made; deterministic algorithms
    # (the train_gpt phase) refuse cuBLAS without it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("chip_smoke: TF32 off for matmul and cuDNN (fp32 throughout)",
          flush=True)
    t0 = time.perf_counter()
    seconds = {}

    def phase(name, fn, *args):
        """Run a phase; print its seconds beside the host's load."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        print("chip_smoke: phase %s took %.1f s (host %d CPUs, load %.2f "
              "%.2f %.2f)" % (name, seconds[name], os.cpu_count(),
                              *os.getloadavg()), flush=True)
        return out

    env = phase("env", phase_env)
    smi = env["nvidia_smi"]
    phase("build", phase_build)
    kernels = phase("kernels", phase_kernels, hbm_rate(env["device"]))
    cache = phase("compile_cache", phase_compile_cache)
    cache_launches = cache["launches_cold_fleet"]
    serve = phase("serve", phase_serve, smi)
    train = phase("train", phase_train, smi)
    train_gpt_out = phase("train_gpt", phase_train_gpt, smi)
    moe_out = phase("train_gpt_moe", phase_train_gpt_moe, smi)
    bert_out = phase("train_bert", phase_train_bert, smi)
    dp_out = phase("train_dp", phase_train_dp, smi,
                   train["losses"]["fused_sgd"])
    sp_out = phase("train_sp", phase_train_sp, smi)
    ctr_out = phase("train_ctr", phase_train_ctr, smi)
    elastic_out = phase("train_elastic", phase_train_elastic, smi)
    moe_ep_out = phase("train_moe_ep", phase_train_moe_ep, smi,
                       moe_out["losses"]["kernels"][:MOE_EP_STEPS])
    migrate_out = phase("train_migrate", phase_train_migrate, smi,
                        train["losses"]["fused_sgd"])
    tp_out = phase("train_tp", phase_train_tp, smi,
                   train_gpt_out["losses"]["flash"],
                   train["losses"]["fused_sgd"])
    pp_out = phase("train_pp", phase_train_pp, smi)
    hybrid_out = phase("train_hybrid", phase_train_hybrid, smi)
    # the MoE-ep path's launches, summed over the ranks of its sound runs
    moe_ep_launches = {
        k: sum(n[k] for name in MOE_EP_SOUND
               for n in moe_ep_out["runs"][name]["launches"])
        for k in ("dispatch", "combine", "flash_fwd", "flash_dq",
                  "flash_dkv")}
    # the elastic path's launches, summed over the ranks of its sound
    # runs: (a) for B1, (b) for B2
    elastic_launches = {
        k: sum(r["launches"][k] for r in elastic_out["runs"][run])
        for run, keys in (("resnet_shrink", ("fused_sgd",)),
                          ("gpt_restart", ("flash_fwd", "flash_dq",
                                           "flash_dkv")))
        for k in keys}
    # the tp path's launches, summed over the ranks of its sound runs
    tp_launches = {
        k: sum(n[k] for name in tp_check.CARD_RUNS
               for n in tp_out["runs"][name]["launches"])
        for k in ("fused_sgd", "flash_fwd", "flash_dq", "flash_dkv")}
    # the pipeline's and the hybrid path's launches, summed over the ranks
    # of their sound runs
    pp_launches = {k: sum(n[k] for n in pp_out["runs"]["pp4"]["launches"])
                   for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    hybrid_launches = {
        k: sum(n[k] for name in hybrid_check.CARD_RUNS
               for n in hybrid_out["runs"][name]["launches"])
        for k in ("flash_fwd", "flash_dq", "flash_dkv", "dispatch",
                  "combine")}
    paged_shapes = kernels["kernels"][0]["shapes"]
    full = next(s for s in paged_shapes if s["case"] == "full_width"
                and s["q_dtype"] == s["kv_dtype"] == str(torch.float32))
    sgd = kernels["kernels"][1]
    flash = kernels["flash"]
    flash_rows = []
    for name, key, replaces in FLASH_KERNELS:
        row = flash["timing"][key]
        outputs = {"fwd": ("o", "lse"), "dq": ("dq",),
                   "dkv": ("dk", "dv")}[key]
        cases = _flash_cases(flash)
        flash_rows.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces,
            "launches": train_gpt_out["launches"]["flash"][key]
            + elastic_launches["flash_" + key]
            + moe_ep_launches["flash_" + key] + tp_launches["flash_" + key]
            + pp_launches["flash_" + key] + hybrid_launches["flash_" + key]
            + cache_launches[name],
            "max_abs_err": max(c["errors"][o]["max_abs_err"]
                               for c in cases for o in outputs),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    moe_rows = []
    for name, key, replaces in MOE_KERNELS:
        row = kernels["moe"]["timing"][MOE_MAIN[key]]
        moe_rows.append({
            "name": name, "route": "cuda", "source": MOE_SOURCE,
            "replaces": replaces,
            "launches": moe_out["launches"]["kernels"][key]
            + moe_ep_launches[key] + hybrid_launches[key]
            + cache_launches[name],
            "max_abs_err": max(r["max_abs_err"]
                               for case in kernels["moe"]["checks"].values()
                               for n, r in case.items()
                               if isinstance(r, dict) and n.startswith(key)),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    whole = time.perf_counter() - t0
    print("chip_smoke: phases (s) %s; the whole %.1f s (host %d CPUs, load "
          "%.2f %.2f %.2f)" % (
              ", ".join("%s %.1f" % kv for kv in seconds.items()), whole,
              os.cpu_count(), *os.getloadavg()), flush=True)
    emit({"phase": "summary", "seconds": whole, "phase_seconds": seconds,
          "host_cpus": os.cpu_count(), "host_load": list(os.getloadavg()),
          "bert_moe_launches": bert_out["bert_base_moe"]["launches"],
          "dp_launches_per_rank": {
              "fused_sgd": dp_out["two_workers_resnet50"]["launches"],
              "flash": dp_out["two_workers_gpt2_2layers"]["launches"]},
          "sp_flash_launches_per_rank": {
              "gpt2_sp4": sp_out["gpt2_sp4"]["launches"],
              "gpt2_2layers_dp2_sp2":
                  sp_out["gpt2_2layers_dp2_sp2"]["launches"]},
          "train_ctr_seconds": ctr_out["seconds"],
          "elastic_launches_per_rank": {
              run: [r["launches"] for r in elastic_out["runs"][run]]
              for run in ("resnet_shrink", "gpt_restart")},
          "train_elastic_seconds": elastic_out["seconds"],
          "moe_ep_launches_per_rank": {
              name: moe_ep_out["runs"][name]["launches"]
              for name in MOE_EP_SOUND},
          "train_moe_ep_seconds": moe_ep_out["seconds"],
          "migrate_launches": {
              k: migrate_out["runs"][k]["launches"]["fused_sgd"]
              for k in ("source", "destination")},
          "train_migrate_seconds": migrate_out["seconds"],
          "tp_launches_per_rank": {
              name: tp_out["runs"][name]["launches"]
              for name in tp_check.CARD_RUNS},
          "train_tp_seconds": tp_out["seconds"],
          "pp_launches_per_rank": pp_out["runs"]["pp4"]["launches"],
          "train_pp_seconds": pp_out["seconds"],
          "hybrid_launches_per_rank": {
              name: hybrid_out["runs"][name]["launches"]
              for name in hybrid_check.CARD_RUNS},
          "train_hybrid_seconds": hybrid_out["seconds"],
          "compile_cache_launches_cold_fleet": cache_launches})
    emit({"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": PAGED_SOURCE, "replaces": PAGED_REPLACES,
        "launches": serve["kernel_launches"]
        + cache_launches["paged_decode_attention"],
        "max_abs_err": max(s["errors"]["max_abs_err"] for s in paged_shapes
                           if s["q_dtype"] == str(torch.float32)),
        "ms": full["kernel_ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": full["library_ms"]}, {
        "name": "fused_sgd", "route": "cuda", "source": SGD_SOURCE,
        "replaces": SGD_REPLACES,
        "launches": train["launches"]["fused_sgd"]
        + elastic_launches["fused_sgd"]
        + migrate_out["launches"]["fused_sgd"] + tp_launches["fused_sgd"]
        + cache_launches["fused_sgd"],
        "max_abs_err": sgd["max_abs_err"], "ms": sgd["kernel_ms"],
        "plain_ms": sgd["plain_ms"], "bound_ms": sgd["bound_ms"],
        "bound_by": sgd["bound_by"], "library_ms": sgd["library_ms"]}]
        + flash_rows + moe_rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
