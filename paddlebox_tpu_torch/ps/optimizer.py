"""Sparse optimizers of the host table (counterpart of
``paddlebox_tpu/ps/optimizer.py``).

The update rules, numpy in place over the deduplicated rows of one push,
one value group at a time (embed_w, embedx, expand):

- ``SparseSGD``: ``w -= lr * g``;
- ``SparseAdaGrad``, the Downpour rule with one scalar g2sum a group:
  ``w -= lr * sqrt(g0 / (g0 + g2sum)) * g``, then ``g2sum += mean(g^2)``;
- ``SparseAdam``: state ``[t, m..., v...]`` (``1 + 2 * dim`` floats), bias
  corrected.

Written as the reference writes them, so both packages' host tables give
the same bits. The device arena's update is ``ops/sparse_optim.py`` and the
push kernel (``ops/sparse_push.py``).
"""

from __future__ import annotations

import numpy as np

from paddlebox_tpu_torch.config import TableConfig


class SparseOptimizer:
    """Base: updates rows of a value group and their state for one push."""

    # float32 state slots a feature of the group needs
    state_width: int = 0

    def __init__(self, conf: TableConfig):
        self.conf = conf

    def init_state(self, state: np.ndarray) -> None:
        state[:] = 0.0

    def update(self, w: np.ndarray, g: np.ndarray, state: np.ndarray) -> None:
        """In place: ``w`` [n, d] given grads ``g`` [n, d] and the rows'
        state [n, state_width]."""
        raise NotImplementedError


class SparseSGD(SparseOptimizer):
    state_width = 0

    def update(self, w, g, state):
        w -= self.conf.learning_rate * g


class SparseAdaGrad(SparseOptimizer):
    """Downpour AdaGrad: one scalar g2sum a feature (a group)."""

    state_width = 1

    def update(self, w, g, state):
        g2 = state[:, 0]
        scale = np.sqrt(self.conf.initial_g2sum / (self.conf.initial_g2sum + g2))
        w -= self.conf.learning_rate * scale[:, None] * g
        g2 += np.square(g).mean(axis=1)


class SparseAdam(SparseOptimizer):
    """Per-dimension Adam; state ``[t, m..., v...]``."""

    def __init__(self, conf: TableConfig, dim: int,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8):
        super().__init__(conf)
        self.dim = dim
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.state_width = 1 + 2 * dim

    def update(self, w, g, state):
        d = self.dim
        t = state[:, 0] + 1.0
        m = state[:, 1:1 + d]
        v = state[:, 1 + d:1 + 2 * d]
        m *= self.beta1
        m += (1 - self.beta1) * g
        v *= self.beta2
        v += (1 - self.beta2) * np.square(g)
        mhat = m / (1 - self.beta1 ** t[:, None])
        vhat = v / (1 - self.beta2 ** t[:, None])
        w -= self.conf.learning_rate * mhat / (np.sqrt(vhat) + self.eps)
        state[:, 0] = t


def make_sparse_optimizer(conf: TableConfig, dim: int) -> SparseOptimizer:
    """The optimizer of one value group of width ``dim``."""
    if conf.optimizer == "sgd":
        return SparseSGD(conf)
    if conf.optimizer == "adagrad":
        return SparseAdaGrad(conf)
    if conf.optimizer == "adam":
        return SparseAdam(conf, dim)
    raise ValueError(f"unknown sparse optimizer {conf.optimizer!r}")
