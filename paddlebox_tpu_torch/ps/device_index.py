"""The device mirror of the native key index, and the in-step key dedup and
probe of device-prep training (counterpart of
``paddlebox_tpu/ps/device_index.py``).

- ``DeviceIndexMirror`` keeps a passive copy of the host ``NativeIndex``'s
  open-addressing table on the table's device: an int32 tensor
  [capacity + guard, 4] of (key_hi, key_lo, row, 0) quads holding the u32
  bit patterns (``NativeIndex.export_slots``). The host map stays
  authoritative; each insert it makes is exported as a (slot, hi, lo, row)
  record (``NativeIndex.prepare_dev``) and written into the mirror, so the
  two agree slot for slot. A rehash (growth, rebuild) moves every key: the
  map's ``generation`` then differs from the mirror's and the mirror
  resyncs in full.
- ``device_dedup`` sorts a batch's keys on the device and numbers their
  uniques (K5); ``device_probe`` resolves each unique against the mirror
  (K6). Each has a plain PyTorch version here, which runs for tensors on
  the CPU; a CUDA tensor takes the hand-written kernel
  (``ops/device_index_kernel.py``) or raises.

**One level, not two.** The reference keeps a second, 2M-slot "mini" table
for new keys and folds it into the main mirror now and then, because a JAX
scatter into the multi-GB main mirror, donated while queued steps still
hold it, copies it. Here ``apply_updates`` writes the records straight
into the main table with an in-place ``index_copy_`` on the device's
stream, ordered after the steps already queued, which copies nothing. The
probe's answers are the reference's two-level probe's: a key is in the
main table or in neither.

Keys that are not in the mirror resolve to row 0, the null row, and are
masked out of the update like padding. In the port's "ensure" mode the
host inserts every non-zero key before its step, so every key resolves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch._device import DeviceLike, resolve_device
from paddlebox_tpu_torch.ops.device_index_kernel import (SIGN, Dedup,
                                                         device_dedup_cuda,
                                                         device_probe_cuda)
from paddlebox_tpu_torch.ps.native import NativeIndex

MASK32 = 0xFFFFFFFF


def split_keys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint64 host keys -> (hi, lo) uint32 halves."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(MASK32)).astype(np.uint32))


def _np_fmix32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def host_hash(keys: np.ndarray) -> np.ndarray:
    """``Map64::hash`` of uint64 host keys, as uint32."""
    khi, klo = split_keys(keys)
    return _np_fmix32(khi ^ _np_fmix32(klo))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32): the product by c's
    two 16-bit halves, each below 2^48, so nothing overflows int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding u32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def key_halves(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 keys (uint64 bit patterns) -> (hi, lo) int64 in [0, 2^32)."""
    return (keys >> 32) & MASK32, keys & MASK32


def device_hash(khi: torch.Tensor, klo: torch.Tensor) -> torch.Tensor:
    """``Map64::hash`` in int64 arithmetic, bit-identical to the C++ map:
    int64 in [0, 2^32)."""
    return _fmix32(khi ^ _fmix32(klo))


def device_dedup_plain(keys: torch.Tensor) -> Dedup:
    """Plain version of K5: a stable sort of the packed keys,
    first-occurrence flags, ``cumsum`` and scatters."""
    n = keys.shape[0]
    dev = keys.device
    sorted_keys, order = torch.sort(keys ^ SIGN, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    uid = torch.cumsum(first, 0) - 1
    n_uniq = (uid[-1] + 1 if n else uid.new_zeros(())).to(torch.int32)
    inverse = torch.empty(n, dtype=torch.int32, device=dev)
    inverse[order] = uid.to(torch.int32)
    heads = uid[first]
    uniq = torch.zeros(n, dtype=torch.int64, device=dev)
    uniq[heads] = sorted_keys[first] ^ SIGN
    offsets = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
    offsets[heads] = torch.arange(n, dtype=torch.int32, device=dev)[first]
    return Dedup(inverse, uniq, n_uniq, order, offsets)


def device_dedup(keys: torch.Tensor) -> Dedup:
    """Dedup of [N] int64 keys: K5 on the card, the plain version on the
    CPU."""
    if keys.is_cuda:
        return device_dedup_cuda(keys)
    if keys.device.type != "cpu":
        raise ValueError(f"device_dedup: unsupported device {keys.device}")
    return device_dedup_plain(keys)


def device_probe_plain(tab: torch.Tensor, mask: int, window: int,
                       keys: torch.Tensor,
                       n_valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6, the reference's formulation: one
    [N, window, 4] gather from each key's home slot and a masked sum of
    the matching quad's row. Key 0 and the reserved key ~0 (which reads as
    an empty slot) are never found."""
    n = keys.shape[0]
    khi, klo = key_halves(keys)
    start = device_hash(khi, klo) & mask
    idx = start[:, None] + torch.arange(window, device=keys.device)[None]
    win = tab[idx]  # [N, window, 4]; the guard keeps idx in bounds
    empty = (win[..., 0] == -1) & (win[..., 1] == -1)
    match = ((win[..., 0].long() & MASK32) == khi[:, None]) & \
        ((win[..., 1].long() & MASK32) == klo[:, None]) & ~empty
    found = match.any(dim=1) & (keys != 0)
    if n_valid is not None:
        found &= torch.arange(n, device=keys.device) < n_valid
    row = torch.where(match, win[..., 2], 0).sum(dim=1)
    return torch.where(found, row, 0).to(torch.int32), found


def device_probe(tab: torch.Tensor, mask: int, window: int,
                 keys: torch.Tensor, n_valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows [N] int32, found [N] bool)`` of [N] int64 keys in a mirror
    table: K6 on the card, the plain version on the CPU."""
    if keys.is_cuda:
        return device_probe_cuda(tab, mask, window, keys, n_valid)
    if keys.device.type != "cpu":
        raise ValueError(f"device_probe: unsupported device {keys.device}")
    return device_probe_plain(tab, mask, window, keys, n_valid)


class DeviceIndexMirror:
    """Passive device copy of a ``NativeIndex``, kept in lockstep by the
    insert records of ``prepare_dev``."""

    def __init__(self, index: NativeIndex, device: DeviceLike = None):
        if not isinstance(index, NativeIndex):
            raise TypeError("the device mirror needs the single-map "
                            "NativeIndex (MtIndex has no slot export)")
        self.index = index
        self.window = index.max_run
        self.device = resolve_device(device)
        self.tab: Optional[torch.Tensor] = None
        self.mask = 0
        self.generation = -1
        self.sync()

    def memory_bytes(self) -> int:
        return int(self.tab.nbytes)

    def sync(self) -> None:
        """Full export and upload: 16 bytes a slot (268 MB at 2^24 slots).
        In place when the capacity has not changed."""
        host = torch.from_numpy(self.index.export_slots().view(np.int32))
        mask = self.index.capacity - 1
        if mask >= (1 << 31):
            raise ValueError("the device mirror takes fewer than 2^31 slots")
        if self.tab is not None and self.tab.shape == host.shape:
            self.tab.copy_(host)
        else:
            self.tab = None  # free the old table before the new one lands
            self.tab = host.to(self.device)
        self.mask = mask
        self.generation = self.index.generation

    def apply_updates(self, slots: np.ndarray, hi: np.ndarray,
                      lo: np.ndarray, rows: np.ndarray) -> None:
        """Write ``prepare_dev``'s insert records into the table, in place;
        resync in full instead if the map rehashed since the last sync."""
        if self.index.generation != self.generation:
            self.sync()
            return
        if not len(slots):
            return
        quads = np.zeros((len(slots), 4), dtype=np.uint32)
        quads[:, 0], quads[:, 1], quads[:, 2] = hi, lo, rows
        self.tab.index_copy_(
            0, torch.from_numpy(np.asarray(slots, np.int64)).to(self.device),
            torch.from_numpy(quads.view(np.int32)).to(self.device))

    def probe(self, keys: torch.Tensor,
              n_valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``device_probe`` of int64 keys on the mirror's device."""
        return device_probe(self.tab, self.mask, self.window, keys, n_valid)
