"""Global stat counters (counterpart of ``paddlebox_tpu/utils/monitor.py``):
the reference's ``StatRegistry``/``StatValue`` surface over the typed
metrics registry. ``STATS`` is the process-global
``obs.metrics.REGISTRY``, so a counter added here shows in its
``snapshot()`` and in the per-pass heartbeat."""

from __future__ import annotations

from paddlebox_tpu_torch.obs.metrics import (Counter as StatValue,
                                             MetricsRegistry as StatRegistry,
                                             REGISTRY)

#: The process-global registry (the same object as ``obs.metrics.REGISTRY``).
STATS = REGISTRY

__all__ = ["StatValue", "StatRegistry", "STATS"]
