"""CTR models of the port."""

from paddlebox_tpu_torch.models.base import MLP, CTRModel
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.wide_deep import WideDeep

__all__ = ["MLP", "CTRModel", "DeepFM", "WideDeep"]
