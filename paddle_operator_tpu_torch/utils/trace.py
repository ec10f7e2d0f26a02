"""Per-stage host timings: the port's copy of
``paddle_operator_tpu/utils/trace.py``'s ``StageTimes``."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict


class StageTimes:
    """Thread-safe accumulator of per-stage host time.

    The input pipeline (:class:`..data.ShardedLoader`) and the training
    loop record where host wall-clock goes, under the JAX package's stage
    names: ``batch_build`` (source pull + window stack), ``device_put``
    (H2D issue), ``enqueue_wait`` (producer blocked on a full queue: the
    consumer is the bottleneck), ``dequeue_wait`` (consumer starved: the
    producer is the bottleneck), ``step_dispatch`` and ``dispatch_gap``
    (host time between step dispatches). ``summary()`` is the breakdown
    ``run_training`` reports.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._total: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._total[stage] = self._total.get(stage, 0.0) + seconds
            self._count[stage] = self._count.get(stage, 0) + 1

    @contextmanager
    def timed(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                stage: {
                    "ms": round(self._total[stage] * 1e3, 3),
                    "count": self._count[stage],
                    "mean_ms": round(
                        self._total[stage] * 1e3 / self._count[stage], 3),
                }
                for stage in sorted(self._total)
            }

    def reset(self) -> None:
        with self._lock:
            self._total.clear()
            self._count.clear()
