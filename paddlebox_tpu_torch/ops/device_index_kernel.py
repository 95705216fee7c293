"""In-step key dedup (K5) and mirror probe (K6): the CUDA wrappers.

Counterparts of ``paddlebox_tpu/ps/device_index.py::device_dedup`` and
``device_probe`` (XLA functions in the reference, not TPU kernels), over
``csrc/device_index.cu``. Their plain versions, and the functions that pick
one or the other by device, are in ``ps/device_index.py``.

Keys are uint64 bit patterns in int64 tensors. Each wrapper launches on the
current stream, does not synchronize, and counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from paddlebox_tpu_torch.ops import _build

# k ^ SIGN as int64 sorts in the unsigned order of k
SIGN = -(1 << 63)


class Dedup(NamedTuple):
    """``device_dedup``'s result, for N keys. uids follow ascending
    unsigned key order."""

    inverse: torch.Tensor    # [N] int32: each key's uid
    uniq_keys: torch.Tensor  # [N] int64: key of each uid, 0 past n_uniq
    n_uniq: torch.Tensor     # [] int32, on the device
    order: torch.Tensor      # [N] int64: key positions grouped by uid,
    #                          ascending within each (the push's order)
    offsets: torch.Tensor    # [N + 1] int32: where uid u's keys start in
    #                          order; N from n_uniq on


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("device_index")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.pbx_dedup_tile.argtypes = []
    lib.pbx_dedup_tile.restype = ctypes.c_int
    lib.pbx_device_dedup.argtypes = [vp, vp, i64] + [vp] * 6
    lib.pbx_device_dedup.restype = ctypes.c_int
    lib.pbx_device_probe.argtypes = [vp, i64, i64, ctypes.c_int, vp, vp, i64,
                                     vp, vp, vp]
    lib.pbx_device_probe.restype = ctypes.c_int
    lib.pbx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pbx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.pbx_cuda_error_string(rc).decode()}")


def _check_keys(keys: torch.Tensor, what: str) -> None:
    if not keys.is_cuda or keys.dtype != torch.int64 or keys.dim() != 1 or \
            not keys.is_contiguous():
        raise ValueError(f"{what}: keys must be a contiguous 1-D int64 CUDA "
                         f"tensor, got {keys.dtype} {tuple(keys.shape)} on "
                         f"{keys.device}")


def device_dedup_cuda(keys: torch.Tensor,
                      presorted: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                      ) -> Dedup:
    """K5: a stable ``torch.sort`` of the packed keys (``keys ^ SIGN``),
    then the hand-written count and write passes. ``presorted``, that
    sort's (values, indices), skips it."""
    _check_keys(keys, "device_dedup_cuda")
    n = keys.shape[0]
    dev = keys.device
    sorted_keys, order = presorted if presorted is not None else \
        torch.sort(keys ^ SIGN, stable=True)
    inverse = torch.empty(n, dtype=torch.int32, device=dev)
    uniq = torch.empty(n, dtype=torch.int64, device=dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    n_uniq = torch.empty(1, dtype=torch.int32, device=dev)
    if n == 0:
        offsets.zero_()
        n_uniq.zero_()
        return Dedup(inverse, uniq, n_uniq.reshape(()), order, offsets)
    lib = _lib()
    tile = lib.pbx_dedup_tile()
    counts = torch.empty(-(-n // tile), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib, lib.pbx_device_dedup(
        sorted_keys.data_ptr(), order.data_ptr(), n, counts.data_ptr(),
        inverse.data_ptr(), uniq.data_ptr(), offsets.data_ptr(),
        n_uniq.data_ptr(), stream), "device_dedup")
    device_dedup_cuda.launches += 1
    return Dedup(inverse, uniq, n_uniq.reshape(()), order, offsets)


device_dedup_cuda.launches = 0


def device_probe_cuda(tab: torch.Tensor, mask: int, window: int,
                      keys: torch.Tensor,
                      n_valid: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: ``(rows [N] int32, found [N] bool)`` of ``keys`` in the mirror
    ``tab`` ([cap + guard, 4] int32, ``mask`` = cap - 1); with ``n_valid``
    (an int32 device scalar) the keys from that position on are not
    probed (row 0, not found)."""
    _check_keys(keys, "device_probe_cuda")
    if tab.device != keys.device or tab.dtype != torch.int32 or \
            tab.dim() != 2 or tab.shape[1] != 4 or not tab.is_contiguous():
        raise ValueError("device_probe_cuda: tab must be a contiguous "
                         f"[slots, 4] int32 tensor on {keys.device}")
    if not 0 <= mask < (1 << 31) or window < 1 or \
            mask + window > tab.shape[0]:
        raise ValueError(f"device_probe_cuda: mask {mask} and window "
                         f"{window} do not fit {tab.shape[0]} slots")
    if n_valid is not None and (n_valid.device != keys.device or
                                n_valid.dtype != torch.int32 or
                                n_valid.numel() != 1):
        raise ValueError("device_probe_cuda: n_valid must be one int32 on "
                         f"{keys.device}")
    n = keys.shape[0]
    rows = torch.empty(n, dtype=torch.int32, device=keys.device)
    found = torch.empty(n, dtype=torch.bool, device=keys.device)
    if n == 0:
        return rows, found
    lib = _lib()
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    _raise_on(lib, lib.pbx_device_probe(
        tab.data_ptr(), tab.shape[0], mask, window, keys.data_ptr(),
        None if n_valid is None else n_valid.data_ptr(), n, rows.data_ptr(),
        found.data_ptr(), stream), "device_probe")
    device_probe_cuda.launches += 1
    return rows, found


device_probe_cuda.launches = 0
