"""In-table sparse optimizers as plain tensor functions (counterpart of
``paddlebox_tpu/ops/sparse_optim.py``).

    adagrad:  scale = sqrt(g2sum0 / (g2sum0 + g2)); w -= lr * scale * g;
              g2 += mean(g^2)   (the scale uses the old g2)
    sgd:      w -= lr * g
    adam:     per-column m/v with bias correction; state = [t, m..., v...]

``mask`` [n] selects the rows that update: padding rows and embedx groups
below their show threshold keep w AND state untouched. The push kernel
(``csrc/sparse_push.cu``) restates the same rules; this module is the plain
version it is held against.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddlebox_tpu_torch.config import TableConfig

ADAM_BETA1, ADAM_BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def state_width(conf: TableConfig, dim: int) -> int:
    """Optimizer state columns of one column group of width ``dim``."""
    if conf.optimizer == "sgd":
        return 0
    if conf.optimizer == "adagrad":
        return 1
    if conf.optimizer == "adam":
        return 1 + 2 * dim
    raise ValueError(f"unknown sparse optimizer {conf.optimizer!r}")


def apply_update(conf: TableConfig, w: torch.Tensor, g: torch.Tensor,
                 state: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [n,d], g [n,d], state [n,state_width], mask [n] (bool or 0/1) ->
    (w', state')."""
    m = mask[:, None]
    lr = conf.learning_rate
    if conf.optimizer == "sgd":
        return w - lr * g * m, state
    if conf.optimizer == "adagrad":
        g2 = state[:, 0]
        g2sum0 = conf.initial_g2sum
        scale = torch.sqrt(g2sum0 / (g2sum0 + g2))
        new_w = w - lr * scale[:, None] * g
        new_g2 = g2 + torch.square(g).mean(dim=1)
        return (torch.where(m.bool(), new_w, w),
                torch.where(mask.bool(), new_g2, g2)[:, None])
    if conf.optimizer == "adam":
        d = w.shape[1]
        b1, b2 = ADAM_BETA1, ADAM_BETA2
        t = state[:, 0] + 1.0
        mom = state[:, 1:1 + d] * b1 + (1 - b1) * g
        vel = state[:, 1 + d:1 + 2 * d] * b2 + (1 - b2) * torch.square(g)
        mhat = mom / (1 - torch.pow(b1, t[:, None]))
        vhat = vel / (1 - torch.pow(b2, t[:, None]))
        new_w = w - lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
        new_state = torch.cat([t[:, None], mom, vel], dim=1)
        return (torch.where(m.bool(), new_w, w),
                torch.where(m.bool(), new_state, state))
    raise ValueError(f"unknown sparse optimizer {conf.optimizer!r}")
