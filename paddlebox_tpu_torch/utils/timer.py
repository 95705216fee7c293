"""Span timers for profiling (counterpart of
``paddlebox_tpu/utils/timer.py``).

``with timer.span("step"): ...`` accumulates the span's wall-clock time
and count under one lock, so the trainer thread and background threads
may share a timer. Each span is also one event of the Chrome trace
(``obs/trace.py``, when ``obs_trace_dir`` turns it on), and with
``metric_prefix`` one observation of the ``<prefix>.<name>_ms`` histogram
in the global registry (``obs/metrics.py``), as in the reference. It also
opens ``torch.profiler.record_function(f"trainer.{name}")``, so a torch
profile shows the trainer's spans beside the step's ``train_step.*``
spans.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

from torch.profiler import record_function

from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY


class SpanTimer:
    """Named accumulating spans: ``with timer.span("pull"): ...``."""

    def __init__(self, metric_prefix: Optional[str] = None):
        self._lock = threading.Lock()
        self.total: Dict[str, float] = defaultdict(float)  # guarded-by: _lock
        self.count: Dict[str, int] = defaultdict(int)      # guarded-by: _lock
        self.metric_prefix = metric_prefix

    @contextlib.contextmanager
    def span(self, name: str):
        with trace.span(name), record_function(f"trainer.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.total[name] += dt
                    self.count[name] += 1
                if self.metric_prefix is not None:
                    REGISTRY.observe(f"{self.metric_prefix}.{name}_ms",
                                     dt * 1e3)

    def mean_ms(self, name: str) -> float:
        with self._lock:
            c = self.count.get(name, 0)
            return self.total[name] / c * 1e3 if c else 0.0

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{span: {total_s, count, mean_ms}}."""
        with self._lock:
            return {k: {"total_s": round(self.total[k], 6),
                        "count": self.count[k],
                        "mean_ms": round(self.total[k] / self.count[k] * 1e3
                                         if self.count[k] else 0.0, 4)}
                    for k in sorted(self.total)}

    def report(self) -> str:
        """One-line per-span report (the ``log_for_profile`` body)."""
        with self._lock:
            keys = sorted(self.total)
            parts = [f"{k}: {self.total[k]:.3f}s/{self.count[k]} "
                     f"(mean {self.total[k] / self.count[k] * 1e3:.2f}ms)"
                     if self.count[k] else f"{k}: 0.000s/0 (mean 0.00ms)"
                     for k in keys]
        return "  ".join(parts)

    def reset(self) -> None:
        with self._lock:
            self.total.clear()
            self.count.clear()
