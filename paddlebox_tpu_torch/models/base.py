"""Model base (counterpart of ``paddlebox_tpu/models/base.py``).

A model takes

    sparse [B, S, Dp]  — per-slot pooled+CVM-transformed embeddings
    dense  [B, Dd]     — dense slot values (may be width 0)

and returns logits [B] (single-task) or [B, T] (multi-task). Unlike flax,
``nn.Linear`` needs its input width when it is built, so models take
``in_dim`` (``S * Dp + Dd``) explicitly, then the reference's fields by
name (``CONFIG_FIELDS``, the ``kwargs`` of a serving bundle's
``model.json``).

``dtype``, as the flax models' field (float32 by default): under
``torch.bfloat16`` a layer casts its input, kernel and bias to bfloat16 for
its product and its bias add, as flax's ``nn.Dense(dtype=...)`` does, while
the parameters stay float32 masters under a float32 optimizer. Like the
reference's bundles, ``CONFIG_FIELDS`` leave ``dtype`` out: a model trained
in bfloat16 serves in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``layer(x)`` in ``dtype``: flax's ``nn.Dense(dtype=...)``, which
    casts the input, the kernel and the bias, then multiplies and adds the
    bias in that dtype (two roundings, as flax rounds twice)."""
    if dtype == torch.float32:
        return layer(x)
    return (x.to(dtype) @ layer.weight.to(dtype).t()) + layer.bias.to(dtype)


class MLP(nn.Module):
    """``Linear`` layers with ReLU between them, then a last ``Linear`` of
    width ``out_dim`` (flax ``MLP`` with its ``Dense_i`` submodules),
    computing in ``dtype``."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [in_dim, *hidden, out_dim]
        self.dtype = dtype
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(dense(layer, x, self.dtype))
        return dense(self.layers[-1], x, self.dtype)


class StackedMLP(nn.Module):
    """``num_stacked`` MLPs of one shape as stacked weights (flax's
    ``nn.vmap(MLP, variable_axes={"params": 0}, out_axes=1)``): layer ``i``
    holds ``kernels[i]`` [E, in, out] and ``biases[i]`` [E, out], the flax
    layout, with ReLU between layers. ``[B, in]`` -> ``[B, E, out]``, one
    batched matmul a layer."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 num_stacked: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [in_dim, *hidden, out_dim]
        self.dtype = dtype
        self.kernels = nn.ParameterList()
        self.biases = nn.ParameterList()
        for a, b in zip(widths[:-1], widths[1:]):
            # nn.Linear's init, drawn for each stacked member
            bound = 1.0 / a ** 0.5
            self.kernels.append(nn.Parameter(
                torch.empty(num_stacked, a, b).uniform_(-bound, bound)))
            self.biases.append(nn.Parameter(
                torch.empty(num_stacked, b).uniform_(-bound, bound)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        x = torch.einsum("bi,eio->beo", x.to(d), self.kernels[0].to(d)) + \
            self.biases[0].to(d)
        for w, b in zip(self.kernels[1:], self.biases[1:]):
            x = torch.einsum("bei,eio->beo", torch.relu(x), w.to(d)) + b.to(d)
        return x


class CTRModel(nn.Module):
    """Base of the CTR models: task count and the input flattening."""

    num_tasks: int = 1
    # the reference module's fields, in its order: what a bundle records
    CONFIG_FIELDS: Tuple[str, ...] = ("num_tasks",)

    @staticmethod
    def flatten_inputs(sparse: torch.Tensor,
                       dense: Optional[torch.Tensor]) -> torch.Tensor:
        B = sparse.shape[0]
        flat = sparse.reshape(B, -1)
        if dense is not None and dense.shape[-1] > 0:
            flat = torch.cat([flat, dense.to(flat.dtype)], dim=-1)
        return flat
