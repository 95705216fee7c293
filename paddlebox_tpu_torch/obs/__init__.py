"""Observability of the port (counterpart of ``paddlebox_tpu/obs/``):
``metrics`` (the typed registry ``REGISTRY``), ``trace`` (the Chrome-trace
span tracer), ``heartbeat`` (the per-pass JSONL records), ``postmortem``
(the crash bundle), ``slo`` (rules and alerts), ``prometheus`` and
``http`` (``/metrics`` and ``/healthz``), ``collector`` (one timeline
of many processes' trace dumps) and ``fleet`` (the host tier's metrics,
scraped into one ``/metrics``).

The modules import neither torch nor numpy, and the package imports none
of them until asked: the data feed's parse workers import ``obs.metrics``
and ``obs.trace``.
"""

import importlib

_LAZY = {"REGISTRY": "paddlebox_tpu_torch.obs.metrics",
         "MetricsRegistry": "paddlebox_tpu_torch.obs.metrics",
         "Counter": "paddlebox_tpu_torch.obs.metrics",
         "Gauge": "paddlebox_tpu_torch.obs.metrics",
         "Histogram": "paddlebox_tpu_torch.obs.metrics",
         "delta": "paddlebox_tpu_torch.obs.metrics",
         "TraceContext": "paddlebox_tpu_torch.obs.trace"}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
