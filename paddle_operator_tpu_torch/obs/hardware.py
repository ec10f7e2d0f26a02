"""Hardware-efficiency telemetry of the port: its copy of
``paddle_operator_tpu/obs/hardware.py``, for the card. Analytic MFU,
roofline attribution and device-memory sampling: the plane that says
what the device did during the goodput seconds.

Three inputs, combined into per-step MFU and a roofline class:

* **step cost**: FLOPs per optimizer step, counted over one real step
  with ``torch.utils.flop_counter``'s formulas (:func:`step_cost_of`,
  :class:`StepFlopCounter`, ``cost_source="flop_counter"``), in place of
  XLA's ``cost_analysis``. The counter sees the matrix products that
  PyTorch dispatches; of the hand-written kernels only the flash triple
  does matrix products, and it reports them through its operators'
  FLOP formulas (``ops/attention.py``); B1, B3 and B4 report nothing
  (:mod:`..ops.optim`, :mod:`..ops.moe`). The counter has no bytes, so
  ``bytes_per_step`` is the job's figure or 0, and a 0 never exports an
  arithmetic intensity. A job's closed form (:func:`analytic_cost`)
  stands where the count gives nothing.
* **chip capability**: peak bf16 FLOP/s and HBM bytes/s by device name
  (:data:`CHIP_PEAKS`: the H100s, most specific first, then the
  reference's TPU rows), resolved for a CUDA device from
  ``torch.cuda.get_device_name``; the CPU, or an unknown name, takes the
  caller's calibrated ceiling, then a stamped default.
* **device memory**: ``torch.cuda.memory_stats`` and the device's total
  memory (:func:`device_memory_stats`); ``{}`` on the CPU.

``mfu = achieved FLOP/s / peak FLOP/s``, clamped at 1.0 with a warning;
``arithmetic intensity = flops / bytes`` against the chip's ridge point.

Which FLOPs: a step's count is what :class:`StepFlopCounter` sees run,
so it holds executed FLOPs (remat's recomputed forward included), except
that the flash attention operators report model FLOPs (the causal pairs
kept, the backward's recompute of the scores left out;
``ops.attention.flash_flops``). A block's ``mfu`` over a step with flash
attention is therefore neither model-FLOP nor hardware-FLOP utilisation:
executed FLOPs, attention counted as model FLOPs. A change to remat moves
it; a change to the flash kernels' recompute does not.

:class:`HardwarePlane` accumulates executed steps and their seconds into
the self-conserving ``result["hardware"]`` block (``total_flops ==
flops_per_step x steps``) and mirrors it into the trace
(``hardware_block``). On the card a launch returns before the device has
run it, so the runner times each step dispatch with :class:`StepClock`:
CUDA events recorded on the device's current stream before and after the
dispatch, read once the end event has completed, so ``step_seconds`` is
the time the card took from reaching the step to finishing it (its idle
waits for the host inside the step included), never the enqueue alone.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..utils.trace import tracer
from .worker import ThroughputBaseline

log = logging.getLogger("tpujob.obs.hardware")

#: peak dense bf16 FLOP/s and HBM bytes/s per device, keyed by a
#: lowercase substring of the device name; most specific first, the first
#: match wins. The H100s from NVIDIA's data sheets ("h100" is the SXM
#: part, "NVIDIA H100 80GB HBM3", at its 700 W limit); the TPU rows are
#: the reference's.
CHIP_PEAKS: Tuple[Tuple[str, float, float], ...] = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 nvl", 835e12, 3.9e12),
    ("h100", 989e12, 3.35e12),
    ("v6e", 918e12, 1640e9),     # Trillium
    ("v5p", 459e12, 2765e9),
    ("v5litepod", 197e12, 819e9),
    ("v5 lite", 197e12, 819e9),  # device_kind "TPU v5 lite"
    ("v5e", 197e12, 819e9),
    ("v4", 275e12, 1228e9),
    ("v3", 123e12, 900e9),
    ("v2", 45e12, 700e9),
)

#: conservative ceiling used when nothing better is known; MFU against
#: it is stamped ``source="default"``
DEFAULT_CPU_PEAK_FLOPS = 1e12
DEFAULT_CPU_BANDWIDTH = 100e9

#: below this absolute MFU a training step is not plausibly running on
#: the device the peak describes
MFU_COLLAPSE_FLOOR = 1e-3


@dataclass(frozen=True)
class ChipSpec:
    """One device's capability envelope. ``backend`` is the platform it
    describes (``gpu`` | ``cpu``): an MFU from this spec means something
    only for steps that ran there. ``source``: ``registry`` (a known
    device), ``calibrated`` (a measured ceiling) or ``default``."""

    device_kind: str
    backend: str
    peak_flops: float
    hbm_bandwidth: float
    source: str

    @property
    def ridge(self) -> float:
        """Roofline ridge point (FLOP/byte)."""
        if self.hbm_bandwidth <= 0:
            return 0.0
        return self.peak_flops / self.hbm_bandwidth


@dataclass(frozen=True)
class StepCost:
    """Per-optimizer-step work: FLOPs executed and HBM bytes moved.
    ``source``: ``flop_counter`` (FlopCounterMode over a real step),
    ``analytic`` (the job's closed form) or ``unavailable`` (neither: MFU
    is suppressed, not invented)."""

    flops: float
    bytes_accessed: float
    source: str

    @property
    def arithmetic_intensity(self) -> float:
        if self.bytes_accessed <= 0:
            return 0.0
        return self.flops / self.bytes_accessed


UNAVAILABLE_COST = StepCost(0.0, 0.0, "unavailable")


def lookup_chip(kind: str) -> Optional[Tuple[float, float]]:
    """Registry lookup by a substring of the device name."""
    k = kind.lower()
    for pat, flops, bw in CHIP_PEAKS:
        if pat in k:
            return flops, bw
    return None


def resolve_chip(device: Any = None,
                 calibrated_flops: Optional[float] = None,
                 calibrated_bandwidth: Optional[float] = None) -> ChipSpec:
    """The capability envelope of ``device`` (a ``torch.device`` or its
    name; None: the current CUDA device when there is a card, else the
    CPU). A CUDA device is looked up by ``torch.cuda.get_device_name`` in
    :data:`CHIP_PEAKS`; the CPU and an unknown name take the calibrated
    ceiling, then the default. Never raises."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    kind, backend = "cpu", "cpu"
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            kind, backend = torch.cuda.get_device_name(dev), "gpu"
    except (RuntimeError, AssertionError, ValueError) as e:
        log.warning("device %r unreadable (%s); using the CPU's spec",
                    device, e)
    hit = lookup_chip(kind)
    if hit is not None:
        return ChipSpec(kind, backend, hit[0], hit[1], "registry")
    if calibrated_flops is not None and calibrated_flops > 0:
        return ChipSpec(
            kind, backend, float(calibrated_flops),
            float(calibrated_bandwidth) if calibrated_bandwidth
            else DEFAULT_CPU_BANDWIDTH, "calibrated")
    return ChipSpec(kind, backend, DEFAULT_CPU_PEAK_FLOPS,
                    DEFAULT_CPU_BANDWIDTH, "default")


class StepFlopCounter(TorchDispatchMode):
    """The FLOPs of what runs under it, as ``FlopCounterMode`` counts them:
    each operator by its formula in ``torch.utils.flop_counter.
    flop_registry`` (the flash operators' included), an operator without
    one by its decomposition, counted, where it has one. Without
    ``FlopCounterMode``'s module tracker, and without the guard that
    makes a dispatch mode import ``torch._dynamo`` on its first operator,
    seconds on a host (once a process, in every worker of a world; run
    :mod:`.startup_probe` to measure both). The train phase of
    ``chip_smoke.py`` holds its count of a step to ``FlopCounterMode``'s,
    exactly."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        return False

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is None:
            decompose = getattr(func, "decompose", None)
            if decompose is not None:
                with self:
                    out = decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self.flops += formula(*args, **kwargs, out_val=out)
        return out


def step_cost_of(fn: Any, *args: Any, steps_per_call: int = 1,
                 bytes_per_step: float = 0.0
                 ) -> Tuple[Any, Optional[StepCost]]:
    """Run ``fn(*args)`` once, a real step, under :class:`StepFlopCounter`,
    and return ``(its output, the cost per optimizer step)``.

    Counting adds no step and draws nothing: the counted call is the one
    the caller would make anyway (the runner's first dispatch of a
    cycle). A call of ``steps_per_call`` fused steps is divided by it.
    The cost is None when the counter saw no FLOPs (the caller keeps its
    analytic figure, or MFU stays suppressed)."""
    k = max(1, int(steps_per_call))
    with StepFlopCounter() as counter:
        out = fn(*args)
    flops = float(counter.flops)
    if flops <= 0:
        return out, None
    return out, StepCost(flops / k, max(0.0, float(bytes_per_step)),
                         "flop_counter")


def analytic_cost(flops_per_step: float,
                  bytes_per_step: float = 0.0) -> StepCost:
    """The job's closed-form figures (e.g. 6 x params x tokens for a
    transformer)."""
    return StepCost(max(0.0, float(flops_per_step)),
                    max(0.0, float(bytes_per_step)), "analytic")


def device_memory_stats(device: Any = None) -> Dict[str, float]:
    """Live device-memory sample, ``{"in_use", "peak", "limit"}`` bytes:
    ``torch.cuda.memory_stats``' ``allocated_bytes.all.current`` and
    ``.peak``, and the device's total memory. ``{}`` on the CPU or when
    the stats cannot be read."""
    try:
        dev = torch.device(device if device is not None else "cpu")
        if dev.type != "cuda" or not torch.cuda.is_available():
            return {}
        stats = torch.cuda.memory_stats(dev)
        limit = torch.cuda.get_device_properties(dev).total_memory
    except (RuntimeError, AssertionError, ValueError):
        return {}
    out: Dict[str, float] = {}
    for key, name in (("allocated_bytes.all.current", "in_use"),
                      ("allocated_bytes.all.peak", "peak")):
        v = stats.get(key)
        if isinstance(v, (int, float)) and v >= 0:
            out[name] = float(v)
    out["limit"] = float(limit)
    return out


def clamped_mfu(achieved_flops_per_s: float,
                peak_flops: float) -> Tuple[float, bool]:
    """``(mfu, clamped)``. Above 1.0 the cost or the peak is wrong: a
    warning and a clamped value, never a crash."""
    if peak_flops <= 0 or achieved_flops_per_s <= 0:
        return 0.0, False
    mfu = achieved_flops_per_s / peak_flops
    if mfu > 1.0:
        log.warning(
            "MFU computed as %.3f > 1.0 (achieved %.3g FLOP/s vs peak "
            "%.3g): cost model or peak is inconsistent; clamping",
            mfu, achieved_flops_per_s, peak_flops)
        return 1.0, True
    return mfu, False


def roofline_class(intensity: float, chip: ChipSpec) -> str:
    """``compute_bound`` | ``memory_bound`` | ``unknown`` against the
    chip's ridge point."""
    if intensity <= 0 or chip.ridge <= 0:
        return "unknown"
    return "compute_bound" if intensity >= chip.ridge else "memory_bound"


class MfuBaseline(ThroughputBaseline):
    """The throughput baseline's never-normalize rule plus an absolute
    floor: MFU is a ratio against the device's own peak, so a collapse
    (a step that fell back to the CPU reads ~1e-5) shows on the first
    sample, before any baseline exists. Degraded samples never enter the
    baseline; recovery needs the floor and, once a baseline exists,
    ``recovery_ratio`` x its median."""

    def __init__(self, floor: float = MFU_COLLAPSE_FLOOR,
                 degraded_ratio: float = 0.25, recovery_ratio: float = 0.5,
                 window: int = 5, min_samples: int = 3) -> None:
        super().__init__(degraded_ratio=degraded_ratio,
                         recovery_ratio=recovery_ratio, window=window,
                         min_samples=min_samples)
        self.floor = float(floor)

    def observe(self, mfu: float) -> Optional[str]:
        v = float(mfu)
        if self.degraded:
            base = self.baseline if len(self._hist) >= self._min else None
            if v >= self.floor and (base is None
                                    or v >= self.recovery_ratio * base):
                self.degraded = False
                self._hist.append(v)
                return "recovered"
            return None
        if v < self.floor:
            # absolute collapse: fires before a baseline, sample not kept
            self.degraded = True
            return "degraded"
        return super().observe(v)


class HardwarePlane:
    """Runner-side accumulator: chip + step cost + executed steps -> the
    self-conserving ``result["hardware"]`` block.

    Thread-safe (the loop records, a scrape reads :meth:`block`) and
    bounded: three numbers of state however long the run.
    ``total_flops == flops_per_step x steps`` holds by construction, and
    :meth:`block` carries both sides so :func:`conservation_violations`
    re-checks it."""

    def __init__(self, chip: ChipSpec, cost: Optional[StepCost] = None,
                 device: Any = None) -> None:
        self.chip = chip
        self.cost = cost if cost is not None else UNAVAILABLE_COST
        self._device = device
        self._lock = threading.Lock()
        self._steps = 0
        self._step_seconds = 0.0
        self._hbm: Dict[str, float] = {}

    def set_cost(self, cost: Optional[StepCost]) -> None:
        """Install the step cost once a cycle has counted it (the chip is
        known when the plane is made, the cost once a step ran)."""
        if cost is not None:
            self.cost = cost

    def record(self, steps: int, seconds: float) -> None:
        """Bank ``steps`` optimizer steps that took ``seconds``."""
        if steps <= 0 or seconds < 0:
            return
        with self._lock:
            self._steps += int(steps)
            self._step_seconds += float(seconds)

    def sample_hbm(self) -> Dict[str, float]:
        """Sample live device memory; remembered for :meth:`block`."""
        stats = device_memory_stats(self._device)
        with self._lock:
            if stats:
                self._hbm = dict(stats)
            return dict(self._hbm)

    def mfu_of_rate(self, steps_per_second: float) -> Optional[float]:
        """MFU at an observed (readback-synced) step rate: what the worker
        gauge carries. None when the step cost is unavailable."""
        if self.cost.source == "unavailable" or self.cost.flops <= 0:
            return None
        mfu, _clamped = clamped_mfu(
            steps_per_second * self.cost.flops, self.chip.peak_flops)
        return mfu

    def block(self) -> Dict[str, Any]:
        """The self-conserving ``result["hardware"]`` block."""
        with self._lock:
            steps = self._steps
            step_seconds = self._step_seconds
            hbm = dict(self._hbm)
        total_flops = self.cost.flops * steps
        mfu: Optional[float] = None
        clamped = False
        if self.cost.source != "unavailable" and step_seconds > 0 \
                and self.cost.flops > 0:
            mfu, clamped = clamped_mfu(total_flops / step_seconds,
                                       self.chip.peak_flops)
        intensity = self.cost.arithmetic_intensity
        out: Dict[str, Any] = {
            "device_kind": self.chip.device_kind,
            "backend": self.chip.backend,
            "peak_flops": self.chip.peak_flops,
            "hbm_bandwidth": self.chip.hbm_bandwidth,
            "peak_source": self.chip.source,
            "cost_source": self.cost.source,
            "flops_per_step": self.cost.flops,
            "bytes_per_step": self.cost.bytes_accessed,
            "steps": steps,
            "step_seconds": round(step_seconds, 6),
            "total_flops": total_flops,
            "arithmetic_intensity": round(intensity, 6),
            "roofline": roofline_class(intensity, self.chip),
            "mfu": round(mfu, 6) if mfu is not None else None,
        }
        if clamped:
            out["mfu_clamped"] = True
        if hbm:
            out["hbm"] = {k: hbm[k] for k in sorted(hbm)}
        return out

    def emit_trace(self, job: str = "") -> Dict[str, Any]:
        """Mirror the block into the trace (``hardware_block``); returns
        the block."""
        blk = self.block()
        attrs: Dict[str, Any] = {
            k: v for k, v in blk.items()
            if k != "hbm" and v is not None}
        for k, v in (blk.get("hbm") or {}).items():
            attrs["hbm_%s" % k] = v
        if job:
            attrs["job"] = job
        tracer().event("hardware_block", **attrs)
        return blk


class StepClock:
    """The seconds each step dispatch took on ``device``'s clock, banked
    into ``plane``.

    On a CUDA device :meth:`begin` and :meth:`end` record a timing event
    on the current stream; the pair's ``elapsed_time`` is read once the
    end event has completed (:meth:`drain` polls, and with ``wait``
    synchronises), so the host never waits on the card to time a step.
    On the CPU the host clock around the call is the step's time."""

    def __init__(self, plane: HardwarePlane, device: Any) -> None:
        self._plane = plane
        self._cuda = torch.device(device).type == "cuda"
        self._pending: Deque[Tuple[int, Any, Any]] = deque()

    def begin(self) -> Any:
        if not self._cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def end(self, begun: Any, steps: int) -> None:
        if not self._cuda:
            self._plane.record(steps, time.perf_counter() - begun)
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._pending.append((steps, begun, ev))
        self.drain()

    def drain(self, wait: bool = False) -> None:
        """Bank every pair whose end has completed (every pair, after
        waiting for it, with ``wait``)."""
        while self._pending:
            steps, a, b = self._pending[0]
            if wait:
                b.synchronize()
            elif not b.query():
                return
            self._pending.popleft()
            self._plane.record(steps, a.elapsed_time(b) / 1e3)


def conservation_violations(block: Dict[str, Any],
                            label: str = "hardware block",
                            tol: float = 1e-6) -> List[str]:
    """Self-consistency audit: ``total_flops == flops_per_step x steps``
    (relative tolerance), MFU within [0, 1], and an MFU derivable from
    the block's own totals."""
    errs: List[str] = []
    try:
        fps = float(block.get("flops_per_step") or 0.0)
        steps = float(block.get("steps") or 0)
        total = float(block.get("total_flops") or 0.0)
    except (TypeError, ValueError):
        return ["%s: non-numeric flops/steps fields" % label]
    want = fps * steps
    if abs(total - want) > tol * max(1.0, abs(want)):
        errs.append("%s: total_flops %.6g != flops_per_step %.6g x "
                    "steps %g (hardware block does not conserve)"
                    % (label, total, fps, steps))
    mfu = block.get("mfu")
    if mfu is not None:
        mfu = float(mfu)
        if not (0.0 <= mfu <= 1.0):
            errs.append("%s: mfu %.6g outside [0, 1]" % (label, mfu))
        peak = float(block.get("peak_flops") or 0.0)
        secs = float(block.get("step_seconds") or 0.0)
        if peak > 0 and secs > 0 and not block.get("mfu_clamped"):
            derived = min(1.0, total / secs / peak)
            if abs(derived - mfu) > max(1e-4, 0.01 * derived):
                errs.append(
                    "%s: mfu %.6g not derivable from its own totals "
                    "(total_flops/step_seconds/peak = %.6g)"
                    % (label, mfu, derived))
    return errs
