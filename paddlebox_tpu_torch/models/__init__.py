"""CTR models of the port."""

from paddlebox_tpu_torch.models.base import MLP, CTRModel
from paddlebox_tpu_torch.models.deepfm import DeepFM

__all__ = ["MLP", "CTRModel", "DeepFM"]
