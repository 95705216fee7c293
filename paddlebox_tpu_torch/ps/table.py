"""Embedding table, serving subset (counterpart of
``paddlebox_tpu/ps/table.py::EmbeddingTable``: ``load`` and
``pull(create=False)``).

A ``table.npz`` snapshot holds ``keys`` [n] uint64, ``values``
[n, pull_dim] float32, ``state`` [n, state_dim] float32 and ``embedx_ok``
[n] bool. The port keeps it on its device as keys sorted in their int64
view plus the matching values, and looks keys up with
``torch.searchsorted`` in that same view, so every lookup is exact.

Pull reproduces the reference bit for bit:

- an unknown key pulls zeros;
- key 0 (the padding feasign) pulls zeros;
- the embedx and expand columns of a row whose ``embedx_ok`` is False pull
  zeros. Those columns are zeroed once, at load.

Creating rows, push and the pass lifecycle belong to the training path.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from paddlebox_tpu_torch._device import DeviceLike, resolve_device
from paddlebox_tpu_torch.config import TableConfig


def state_dim(conf: TableConfig) -> int:
    """Width of a snapshot's ``state``: the sparse optimizer's state for
    each trainable group (embed_w, embedx, expand)."""
    widths = [w for w in (conf.cvm_offset - 2, conf.embedx_dim,
                          conf.expand_dim) if w]
    if conf.optimizer == "sgd":
        return 0
    if conf.optimizer == "adagrad":
        return len(widths)
    if conf.optimizer == "adam":
        return sum(1 + 2 * w for w in widths)
    raise ValueError(f"unknown sparse optimizer {conf.optimizer!r}")


class EmbeddingTable:
    def __init__(self, conf: TableConfig, device: DeviceLike = None):
        if conf.cvm_offset < 2:
            raise ValueError("cvm_offset must be >= 2 (show, clk)")
        if conf.variable_embedding:
            raise ValueError("variable_embedding is a device-arena mode of "
                             "the training path; the table does not take it")
        self.conf = conf
        self.dim = conf.pull_dim
        self.device = resolve_device(device)
        self._keys = torch.empty(0, dtype=torch.int64, device=self.device)
        self._values = torch.empty((0, self.dim), dtype=torch.float32,
                                   device=self.device)

    def __len__(self) -> int:
        return int(self._keys.shape[0])

    def load(self, path: str) -> None:
        with np.load(path) as data:
            self.load_snapshot({k: data[k] for k in
                                ("keys", "values", "embedx_ok")})

    def load_snapshot(self, snap: Dict[str, np.ndarray]) -> None:
        keys = np.ascontiguousarray(snap["keys"], dtype=np.uint64)
        values = np.asarray(snap["values"], dtype=np.float32)
        ok = np.asarray(snap["embedx_ok"], dtype=bool)
        n = keys.size
        if values.shape != (n, self.dim) or ok.shape != (n,):
            raise ValueError(
                f"snapshot of {n} keys has values {values.shape} and "
                f"embedx_ok {ok.shape}; expected ({n}, {self.dim}) and ({n},)")
        keys_t = torch.from_numpy(keys.view(np.int64)).to(self.device)
        skeys, order = torch.sort(keys_t, stable=True)
        if n > 1 and bool((skeys[1:] == skeys[:-1]).any()):
            raise ValueError("snapshot holds duplicate keys")
        vals = torch.from_numpy(values).to(self.device)[order]
        gated = ~torch.from_numpy(ok).to(self.device)[order]
        # embedx + expand columns are served only once a row has earned them
        vals[:, self.conf.cvm_offset:].masked_fill_(gated[:, None], 0.0)
        self._keys, self._values = skeys, vals

    def pull(self, keys: np.ndarray, create: bool = False) -> torch.Tensor:
        """``keys`` [N] uint64 -> [N, pull_dim] float32 on the table's
        device. Serving pulls never create rows."""
        if create:
            raise NotImplementedError(
                "pull(create=True) materializes rows, which is part of the "
                "training path; the port serves only (create=False)")
        q = torch.from_numpy(
            np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64)
        ).to(self.device)
        n = self._keys.shape[0]
        if n == 0:
            return torch.zeros((q.shape[0], self.dim), dtype=torch.float32,
                               device=self.device)
        pos = torch.searchsorted(self._keys, q).clamp_(max=n - 1)
        found = (self._keys[pos] == q) & (q != 0)
        return self._values[pos].masked_fill_(~found[:, None], 0.0)
