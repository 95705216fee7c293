"""Model base (counterpart of ``paddlebox_tpu/models/base.py``).

A model takes

    sparse [B, S, Dp]  — per-slot pooled+CVM-transformed embeddings
    dense  [B, Dd]     — dense slot values (may be width 0)

and returns logits [B]. Unlike flax, ``nn.Linear`` needs its input width
when it is built, so models take ``in_dim`` (``S * Dp + Dd``) explicitly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class MLP(nn.Module):
    """``Linear`` layers with ReLU between them, then a last ``Linear`` of
    width ``out_dim`` (flax ``MLP`` with its ``Dense_i`` submodules)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int = 1):
        super().__init__()
        widths = [in_dim, *hidden, out_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


class CTRModel(nn.Module):
    """Base of the CTR models: task count and the input flattening."""

    num_tasks: int = 1

    @staticmethod
    def flatten_inputs(sparse: torch.Tensor,
                       dense: Optional[torch.Tensor]) -> torch.Tensor:
        B = sparse.shape[0]
        flat = sparse.reshape(B, -1)
        if dense is not None and dense.shape[-1] > 0:
            flat = torch.cat([flat, dense.to(flat.dtype)], dim=-1)
        return flat
