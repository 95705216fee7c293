"""CTR models of the port."""

from paddlebox_tpu_torch.models.base import MLP, CTRModel, StackedMLP
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.dnn import FeedDNN
from paddlebox_tpu_torch.models.mmoe import MMoE
from paddlebox_tpu_torch.models.wide_deep import WideDeep

__all__ = ["MLP", "CTRModel", "StackedMLP", "DeepFM", "WideDeep", "FeedDNN",
           "MMoE"]
