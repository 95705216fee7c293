"""MMoE multi-task CTR/CVR (counterpart of ``paddlebox_tpu/models/mmoe.py``,
BASELINE.json configs[3]).

A shared sparse bottom (the pooled embeddings), ``num_experts`` expert MLPs
held as one ``StackedMLP`` (the reference's vmapped MLP, weights with a
leading [E] axis), then per task a softmax gate over the experts, their mix
``einsum("be,beo->bo")`` and a tower MLP to one logit. Returns [B, T]
float32 logits."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import MLP, CTRModel, StackedMLP
from paddlebox_tpu_torch.models.base import dense as dense_layer


class MMoE(CTRModel):
    CONFIG_FIELDS = ("num_tasks", "num_experts", "expert_hidden",
                     "expert_out", "tower_hidden")

    def __init__(self, in_dim: int, num_tasks: int = 2, num_experts: int = 4,
                 expert_hidden: Sequence[int] = (256, 128),
                 expert_out: int = 64,
                 tower_hidden: Sequence[int] = (64, 32),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.in_dim = in_dim
        self.num_tasks = num_tasks
        self.num_experts = num_experts
        self.expert_hidden = tuple(expert_hidden)
        self.expert_out = expert_out
        self.tower_hidden = tuple(tower_hidden)
        self.experts = StackedMLP(in_dim, self.expert_hidden, expert_out,
                                  num_experts, dtype)
        self.gates = nn.ModuleList(nn.Linear(in_dim, num_experts)
                                   for _ in range(num_tasks))
        self.towers = nn.ModuleList(MLP(expert_out, self.tower_hidden, 1,
                                        dtype) for _ in range(num_tasks))

    def forward(self, sparse: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        flat = self.flatten_inputs(sparse.to(self.dtype), dense)
        ex = self.experts(flat)                       # [B, E, expert_out]
        logits = []
        for gate, tower in zip(self.gates, self.towers):
            g = torch.softmax(dense_layer(gate, flat, self.dtype), dim=-1)
            mixed = torch.einsum("be,beo->bo", g, ex)
            logits.append(tower(mixed)[:, 0])
        return torch.stack(logits, dim=-1).float()
