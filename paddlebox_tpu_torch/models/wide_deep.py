"""Wide&Deep over pooled slot embeddings
(counterpart of ``paddlebox_tpu/models/wide_deep.py``).

``wide`` is one ``Linear`` to a logit over the flattened inputs, ``deep``
an ``MLP`` over the same; the logit is their sum.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import MLP, CTRModel
from paddlebox_tpu_torch.models.base import dense as dense_layer


class WideDeep(CTRModel):
    CONFIG_FIELDS = ("num_tasks", "hidden")

    def __init__(self, in_dim: int, hidden: Sequence[int] = (256, 128, 64),
                 num_tasks: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_dim = in_dim
        self.hidden = tuple(hidden)
        self.num_tasks = num_tasks
        self.dtype = dtype
        self.wide = nn.Linear(in_dim, 1)
        self.deep = MLP(in_dim, self.hidden, 1, dtype)

    def forward(self, sparse: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        flat = self.flatten_inputs(sparse.to(self.dtype), dense)
        return (dense_layer(self.wide, flat, self.dtype)[:, 0] +
                self.deep(flat)[:, 0]).float()
