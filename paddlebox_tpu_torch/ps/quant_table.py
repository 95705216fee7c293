"""Int8 serving snapshots (counterpart of ``paddlebox_tpu/ps/quant_table.py``).

Serving pulls quantized rows while training keeps its own precision: the
int8 arena's scheme (``ps/device_table.py`` ``ArenaLayout``: symmetric
``[-QMAX, QMAX]``, one float32 scale a row and column group, show/clk exact
in float32) applied to the serving artifact.

- ``quantize_snapshot`` turns a canonical float32 snapshot (``keys``,
  ``values``, ``state``, optionally ``embedx_ok``: what
  ``EmbeddingTable.snapshot`` and ``DeviceTable``'s canonical layout give)
  into the int8 layout of ``QUANT_FIELDS``, on the host, with the
  reference's numpy arithmetic, so an artifact written by either package is
  the same bytes. The optimizer state is dropped: serving never updates.
- ``QuantServingTable`` is the pull-only serving table over such an
  artifact, resident on the serving device: the int8 rows, the scales, the
  stats and the gating flags, keys sorted in their int64 view and looked up
  with ``torch.searchsorted`` (as ``ps/serving_table.py`` looks up the
  float32 table). A pull dequantizes each group with one float32 product a
  column, which is the reference's numpy pull bit for bit. ``load``,
  ``load_delta`` take quantized artifacts, ``load_f32``,
  ``load_delta_f32`` quantize a float32 one on the way in.

Every dequantized weight is within one quantization step (its group's row
maximum over ``QMAX``) of its float32 source; show/clk are exact. The
artifact is derived: ``trainer/pass_manager.py`` commits it beside a base
or delta as ``<dir>.q8``, retention prunes it with its parent, and no
donefile record names it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch._device import DeviceLike, resolve_device
from paddlebox_tpu_torch.config import TableConfig

#: symmetric quantization range, shared with ``ArenaLayout.QMAX``
QMAX = 127.0

#: array names of one quantized artifact (.npz)
QUANT_FIELDS = ("keys", "qvalues", "scales", "stats", "embedx_ok")


def value_groups(conf: TableConfig) -> List[Tuple[int, int, bool]]:
    """(start column, width, gated) of the pulled value's trainable column
    groups, the layout ``ArenaLayout`` and ``EmbeddingTable`` derive from
    the config: scales are a group's, so a hot embed_w does not crush a
    small embedx group."""
    if conf.variable_embedding:
        raise ValueError(
            "variable_embedding rows carry per-row widths; the serving "
            "quantizer only handles the fixed pull layout")
    groups: List[Tuple[int, int, bool]] = []
    col = 2
    w_width = conf.cvm_offset - 2
    if w_width:
        groups.append((col, w_width, False))
        col += w_width
    if conf.embedx_dim:
        groups.append((col, conf.embedx_dim, True))
        col += conf.embedx_dim
    if conf.expand_dim:
        groups.append((col, conf.expand_dim, True))
    return groups


def quantize_snapshot(arrays: Mapping[str, np.ndarray],
                      conf: TableConfig) -> Dict[str, np.ndarray]:
    """Canonical float32 snapshot -> the int8 artifact's arrays.
    ``arrays`` needs ``keys`` and ``values`` (show/clk in value columns 0,
    1); ``embedx_ok`` is carried when present and otherwise derived from
    the show count (``show >= embedx_threshold``); ``state`` is ignored."""
    vals = np.asarray(arrays["values"], dtype=np.float32)
    keys = np.ascontiguousarray(arrays["keys"], dtype=np.uint64)
    if vals.shape != (keys.size, conf.pull_dim):
        raise ValueError(
            f"snapshot values {vals.shape} do not match "
            f"({keys.size}, {conf.pull_dim}) for table {conf.name!r}")
    groups = value_groups(conf)
    q = np.zeros((keys.size, conf.pull_dim), dtype=np.int8)
    scales = np.zeros((keys.size, max(len(groups), 1)), dtype=np.float32)
    for gi, (start, width, _gated) in enumerate(groups):
        g = vals[:, start:start + width]
        s = np.maximum(np.abs(g).max(axis=1), 1e-12) / QMAX
        scales[:, gi] = s
        q[:, start:start + width] = np.clip(
            np.round(g / s[:, None]), -QMAX, QMAX).astype(np.int8)
    emb_ok = arrays.get("embedx_ok")
    if emb_ok is None:
        emb_ok = vals[:, 0] >= conf.embedx_threshold
    return {"keys": keys, "qvalues": q, "scales": scales,
            "stats": np.ascontiguousarray(vals[:, :2], dtype=np.float32),
            "embedx_ok": np.asarray(emb_ok, dtype=bool)}


class QuantServingTable:
    """Pull-only int8 serving table on ``device`` (default ``cuda``; pass
    ``device="cpu"`` for host runs). Immutable between loads: a reload
    installs a whole new table."""

    def __init__(self, conf: TableConfig, device: DeviceLike = None):
        self.conf = conf
        self.dim = conf.pull_dim
        self.device = resolve_device(device)
        self._groups = value_groups(conf)
        self._install({"keys": np.zeros(0, np.uint64),
                       "qvalues": np.zeros((0, self.dim), np.int8),
                       "scales": np.zeros((0, max(len(self._groups), 1)),
                                          np.float32),
                       "stats": np.zeros((0, 2), np.float32),
                       "embedx_ok": np.zeros(0, bool)})

    def __len__(self) -> int:
        return int(self._keys.shape[0])

    # -- load ----------------------------------------------------------------

    def _install(self, arrs: Mapping[str, np.ndarray]) -> None:
        """Upload an artifact's rows, the padding key 0 dropped, sorted by
        the keys' int64 view (the order ``torch.searchsorted`` needs)."""
        keys = np.ascontiguousarray(arrs["keys"], dtype=np.uint64)
        live = keys != 0             # the padding feasign never owns a row
        kv = keys[live].view(np.int64)
        order = np.argsort(kv, kind="stable")

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(a, dtype)[live][order])).to(self.device)

        self._keys = torch.from_numpy(kv[order].copy()).to(self.device)
        self._q = up(arrs["qvalues"], np.int8)
        self._scales = up(arrs["scales"], np.float32)
        self._stats = up(arrs["stats"], np.float32)
        self._embedx_ok = up(arrs["embedx_ok"], bool)

    def _host(self) -> Dict[str, np.ndarray]:
        """Host copies of the installed rows, keys as uint64."""
        return {"keys": self._keys.cpu().numpy().view(np.uint64),
                "qvalues": self._q.cpu().numpy(),
                "scales": self._scales.cpu().numpy(),
                "stats": self._stats.cpu().numpy(),
                "embedx_ok": self._embedx_ok.cpu().numpy()}

    def _upsert(self, arrs: Mapping[str, np.ndarray]) -> None:
        """Apply a quantized delta: new rows append, existing rows are
        replaced whole (the delta's upsert contract)."""
        keys = np.ascontiguousarray(arrs["keys"], dtype=np.uint64)
        if not keys.size:
            return
        cur = self._host()
        ck = cur["keys"].view(np.int64)
        keep = np.ones(ck.size, dtype=bool)
        if ck.size:
            kv = keys.view(np.int64)
            pos = np.minimum(np.searchsorted(ck, kv), ck.size - 1)
            keep[pos[ck[pos] == kv]] = False
        self._install({
            name: np.concatenate([cur[name][keep], np.asarray(arrs[name])])
            for name in QUANT_FIELDS})

    def load(self, path: str) -> None:
        """Load a quantized artifact (.npz of ``QUANT_FIELDS``)."""
        with np.load(path) as data:
            self._install({k: data[k] for k in QUANT_FIELDS})

    def load_delta(self, path: str) -> None:
        with np.load(path) as data:
            self._upsert({k: data[k] for k in QUANT_FIELDS})

    def load_f32(self, path: str) -> None:
        """Quantize a float32 table artifact on load (a bundle or a
        checkpoint written without the export)."""
        with np.load(path) as data:
            self._install(quantize_snapshot(data, self.conf))

    def load_delta_f32(self, path: str) -> None:
        with np.load(path) as data:
            if not data["keys"].size:
                return
            self._upsert(quantize_snapshot(data, self.conf))

    # -- pull ----------------------------------------------------------------

    def pull(self, keys: np.ndarray, create: bool = False) -> torch.Tensor:
        """``keys`` [N] uint64 -> [N, pull_dim] float32 on the table's
        device, each group dequantized (``q * scale``). Unknown keys and the
        padding key pull zeros; a gated group pulls zeros until its row's
        ``embedx_ok``."""
        if create:
            raise ValueError(
                "QuantServingTable is pull-only (serving); it cannot "
                "materialize rows")
        q = torch.from_numpy(
            np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64)
        ).to(self.device)
        out = torch.zeros((q.shape[0], self.dim), dtype=torch.float32,
                          device=self.device)
        n = self._keys.shape[0]
        if not q.shape[0] or not n:
            return out
        pos = torch.searchsorted(self._keys, q).clamp_(max=n - 1)
        hit = self._keys[pos] == q          # key 0 is never stored
        out[:, :2] = self._stats[pos]
        ok = self._embedx_ok[pos][:, None]
        zero = out.new_zeros(())
        for gi, (start, width, gated) in enumerate(self._groups):
            g = self._q[pos, start:start + width].float() * \
                self._scales[pos, gi:gi + 1]
            out[:, start:start + width] = torch.where(ok, g, zero) \
                if gated else g
        return out.masked_fill_(~hit[:, None], 0.0)

    # -- introspection -------------------------------------------------------

    def memory_bytes(self) -> int:
        """Row payload bytes (values, scales, stats, gating), keys excluded,
        as ``EmbeddingTable.memory_bytes`` counts."""
        return int(self._q.nbytes + self._scales.nbytes +
                   self._stats.nbytes + self._embedx_ok.nbytes)
