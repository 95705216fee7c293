"""Training metrics of the port (bucketed AUC, the named registry)."""

from paddlebox_tpu_torch.metrics.auc import (AucCalculator, auc_update,
                                             new_auc_state)
from paddlebox_tpu_torch.metrics.registry import MetricEntry, MetricRegistry

__all__ = ["AucCalculator", "auc_update", "new_auc_state", "MetricEntry",
           "MetricRegistry"]
