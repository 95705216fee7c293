"""Feed-style plain DNN CTR tower (counterpart of
``paddlebox_tpu/models/dnn.py``, BASELINE.json configs[2]): an ``MLP`` of
``hidden`` over the flattened inputs to one logit."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from paddlebox_tpu_torch.models.base import MLP, CTRModel


class FeedDNN(CTRModel):
    CONFIG_FIELDS = ("num_tasks", "hidden")

    def __init__(self, in_dim: int,
                 hidden: Sequence[int] = (511, 255, 255, 127, 127, 127, 127),
                 num_tasks: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_dim = in_dim
        self.hidden = tuple(hidden)
        self.num_tasks = num_tasks
        self.dtype = dtype
        self.mlp = MLP(in_dim, self.hidden, 1, dtype)

    def forward(self, sparse: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.mlp(self.flatten_inputs(sparse.to(self.dtype),
                                            dense))[:, 0].float()
