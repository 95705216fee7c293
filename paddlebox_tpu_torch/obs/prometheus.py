"""Prometheus text exposition (format version 0.0.4) of the registry
(counterpart of ``paddlebox_tpu/obs/prometheus.py``, the same text for the
same registry).

``render(REGISTRY)`` is the ``/metrics`` body: each counter and gauge one
sample, each histogram the cumulative ``_bucket{le=...}`` series (every
8th log bucket, ``+Inf`` last), ``_sum`` and ``_count``. Names are
sanitized under one ``pbx_`` namespace (``serve.request_ms`` ->
``pbx_serve_request_ms``).

Imports neither torch nor numpy.
"""

from __future__ import annotations

import math
import re
from typing import List

from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "pbx_"

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def sanitize(name: str) -> str:
    s = _NAME_RE.sub("_", name)
    if s and s[0].isdigit():
        s = "_" + s
    return _PREFIX + s


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def render(registry: MetricsRegistry = REGISTRY) -> str:
    lines: List[str] = []
    for name, m in registry.items():
        pname = sanitize(name)
        if m.kind in ("counter", "gauge"):
            lines.append(f"# TYPE {pname} {m.kind}")
            lines.append(f"{pname} {_fmt(m.get())}")
            continue
        lines.append(f"# TYPE {pname} histogram")
        count = 0
        for bound, cum in m.cumulative_buckets():
            lines.append(f'{pname}_bucket{{le="{_fmt(bound)}"}} {cum}')
            count = cum
        # the count is the +Inf bucket of the same merge, so the series
        # agrees with itself while observers race the render
        lines.append(f"{pname}_sum {_fmt(m.sum)}")
        lines.append(f"{pname}_count {count}")
    return "\n".join(lines) + "\n"
