"""Observability of the port: the worker plane of the reference's
``paddle_operator_tpu/obs`` (the runner's ``/metrics`` server, step
profile, straggler detection, throughput baseline: :mod:`.worker`), the
hardware-efficiency plane for the card (:mod:`.hardware`), and the
exposition helpers both render with (:mod:`.exposition`). The operator's
planes of ``obs/`` (ledger, SLOs, aggregation) are the control plane's
and are not ported."""

from .exposition import escape_label_value, format_value, \
    http_respond, parse_exposition  # noqa: F401
from .hardware import (  # noqa: F401
    CHIP_PEAKS, DEFAULT_CPU_PEAK_FLOPS, MFU_COLLAPSE_FLOOR, ChipSpec,
    HardwarePlane, MfuBaseline, StepClock, StepCost, StepFlopCounter,
    analytic_cost,
    clamped_mfu, conservation_violations, device_memory_stats,
    lookup_chip, resolve_chip, roofline_class, step_cost_of)
from .worker import (  # noqa: F401
    STEP_PHASES, STRAGGLER_K, StepProfiler, StragglerDetector,
    ThroughputBaseline, WorkerMetricsServer, median)
