"""DeepFM over pooled slot embeddings
(counterpart of ``paddlebox_tpu/models/deepfm.py``).

Input layout follows ``ops.seqpool_cvm`` with use_cvm=True, cvm_offset=3:

    sparse[..., 0:2]  = [log(show+1), log(ctr)] context
    sparse[..., 2]    = per-feature wide weight (embed_w), summed = 1st order
    sparse[..., 3:]   = embedx vectors, the FM factors

The deep tower's products are ``nn.Linear`` (plain matmuls), as the
reference leaves them to XLA outside any TPU kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import MLP, CTRModel


class DeepFM(CTRModel):
    def __init__(self, in_dim: int, hidden: Sequence[int] = (512, 256, 128),
                 cvm_offset: int = 3, num_tasks: int = 1):
        super().__init__()
        self.in_dim = in_dim
        self.hidden = tuple(hidden)
        self.cvm_offset = cvm_offset
        self.num_tasks = num_tasks
        self.mlp = MLP(in_dim, self.hidden, 1)
        self.bias = nn.Parameter(torch.zeros(()))

    def forward(self, sparse: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = sparse.float()
        # first order: sum of per-slot wide weights
        first = torch.sum(x[..., 2:self.cvm_offset], dim=(1, 2))
        # FM second order over the embedx factors
        v = x[..., self.cvm_offset:]
        sum_sq = torch.square(torch.sum(v, dim=1))
        sq_sum = torch.sum(torch.square(v), dim=1)
        fm = 0.5 * torch.sum(sum_sq - sq_sum, dim=-1)
        # deep tower over everything
        deep = self.mlp(self.flatten_inputs(x, dense))[:, 0]
        return first + fm + deep + self.bias
