"""The step's forward half (counterpart of
``paddlebox_tpu/trainer/train_step.py::TrainStep._features`` / ``predict``).

Forward: ``emb[Npad, D]``, ``segment_ids[Npad]``, ``cvm_in[B, 2]``,
``dense[B, Dd]`` -> seqpool+CVM -> model -> sigmoid. The module passed to
``predict`` holds the weights (the role of the reference's params pytree).
The training half (loss, backward, optimizers) comes with the training
path.
"""

from __future__ import annotations

import torch
from torch import nn

from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm


class TrainStep:
    def __init__(self, table_conf: TableConfig, batch_size: int,
                 num_slots: int, dense_dim: int = 0, use_cvm: bool = True):
        # The model's matmuls run in full float32, as in the JAX reference:
        # TF32 keeps about three decimal digits. The flags are process-wide.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.table_conf = table_conf
        self.batch_size = batch_size
        self.num_slots = num_slots
        self.dense_dim = dense_dim
        self.use_cvm = use_cvm

    @property
    def sparse_width(self) -> int:
        """Per-slot width of the pooled features the model sees (the
        reference's ``TrainStep.init`` shape)."""
        D = self.table_conf.pull_dim
        return D if self.use_cvm else D - 2

    def _features(self, emb: torch.Tensor, segment_ids: torch.Tensor,
                  cvm_in: torch.Tensor) -> torch.Tensor:
        return fused_seqpool_cvm(
            emb, segment_ids, cvm_in, self.batch_size, self.num_slots,
            self.use_cvm)

    @torch.inference_mode()
    def predict(self, model: nn.Module, emb: torch.Tensor,
                segment_ids: torch.Tensor, cvm_in: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        sparse = self._features(emb, segment_ids, cvm_in)
        return torch.sigmoid(model(sparse, dense))
