"""Training metrics of the port (bucketed AUC)."""

from paddlebox_tpu_torch.metrics.auc import (AucCalculator, auc_update,
                                             new_auc_state)

__all__ = ["AucCalculator", "auc_update", "new_auc_state"]
