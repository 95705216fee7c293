"""In-step key dedup (K5) and mirror probe (K6), alone and fused: the CUDA
wrappers.

Counterparts of ``paddlebox_tpu/ps/device_index.py::device_dedup`` and
``device_probe`` (XLA functions in the reference, not TPU kernels), over
``csrc/device_index.cu``. Their plain versions, and the functions that pick
one or the other by device, are in ``ps/device_index.py``.

K5 runs in two halves, each its own C entry: ``dedup_sort_cuda``, the
hand-written stable LSD radix sort of the packed keys (8 digits of 8 bits;
a digit whose one bin holds every key is skipped on the card, by the plan
the sort writes there), and ``dedup_number_cuda``, the count and write
passes over the sorted keys. ``device_dedup_cuda`` runs both.

Device prep runs ``device_dedup_probe_cuda``: K5's sort and count pass,
then a write pass that also resolves each unique it numbers against the
mirror (``dedup_number_probe_cuda``), so it launches no probe of its own.
``device_probe_cuda`` (K6 alone) probes any list of keys.

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
# the radix sort's digits: DIGITS of RADIX_BITS bits, the lowest first
DIGITS, RADIX_BITS = 8, 8


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


class RadixSort(NamedTuple):
    """``dedup_sort_cuda``'s result, for N keys."""

    keys: torch.Tensor  # [2, N] int64: buffers A and B of packed keys
    pos: torch.Tensor   # [2, N] int32: their positions
    plan: torch.Tensor  # [2 * DIGITS + 1] int32: digit d active ([d]), the
    #                     buffer pass d reads ([DIGITS + d]; 0 = A, 1 = B),
    #                     the buffer holding the sorted keys ([2 * DIGITS])
    work: torch.Tensor  # int32 scratch of the numbering passes

    def result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sorted packed keys and their positions (reads the plan on
        the host)."""
        final = int(self.plan[2 * DIGITS])
        return self.keys[final], self.pos[final]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("device_index"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entries of a library built from
    ``csrc/device_index.cu``."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in ("pbx_dedup_tile", "pbx_dedup_sort_tile",
                 "pbx_dedup_sort_bins", "pbx_dedup_digits"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    # the wrapper sizes the histogram and the plan by these
    if (lib.pbx_dedup_digits(), lib.pbx_dedup_sort_bins()) != (
            DIGITS, 1 << RADIX_BITS):
        raise RuntimeError("csrc/device_index.cu's radix sort differs from "
                           "its wrapper's digits")
    lib.pbx_dedup_sort.argtypes = [vp, i64] + [vp] * 6
    lib.pbx_dedup_sort.restype = ctypes.c_int
    lib.pbx_dedup_number.argtypes = [vp, vp, vp, i64] + [vp] * 7
    lib.pbx_dedup_number.restype = ctypes.c_int
    lib.pbx_dedup_number_probe.argtypes = [vp, vp, vp, i64] + [vp] * 7 + [
        i64, i64, ctypes.c_int, vp, vp, vp]
    lib.pbx_dedup_number_probe.restype = ctypes.c_int
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


def _check_mirror(tab: torch.Tensor, mask: int, window: int,
                  device: torch.device, what: str) -> None:
    if tab.device != device or tab.dtype != torch.int32 or \
            tab.dim() != 2 or tab.shape[1] != 4 or not tab.is_contiguous():
        raise ValueError(f"{what}: tab must be a contiguous [slots, 4] int32 "
                         f"tensor on {device}")
    if not 0 <= mask < (1 << 31) or window < 1 or \
            mask + window > tab.shape[0]:
        raise ValueError(f"{what}: mask {mask} and window {window} do not "
                         f"fit {tab.shape[0]} slots")


def dedup_sort_cuda(keys: torch.Tensor) -> RadixSort:
    """K5's sort half: the packed keys ``keys ^ SIGN`` and their positions,
    sorted stably by the hand-written radix sort, for N >= 1 keys. Two
    allocations: the key buffers, and one int32 tensor for the rest."""
    _check_keys(keys, "dedup_sort_cuda")
    n = keys.shape[0]
    if n == 0:
        raise ValueError("dedup_sort_cuda: no keys")
    dev = keys.device
    lib = _lib()
    bins = 1 << RADIX_BITS
    # tile counts first: the kernel reads them 16 bytes at a time
    sizes = (-(-n // lib.pbx_dedup_sort_tile()) * bins, 2 * n,
             DIGITS * bins + 1, 2 * DIGITS + 1, -(-n // lib.pbx_dedup_tile()))
    counts, pos, hist, plan, work = torch.empty(
        sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    out = RadixSort(torch.empty((2, n), dtype=torch.int64, device=dev),
                    pos.view(2, n), plan, work)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib, lib.pbx_dedup_sort(
        keys.data_ptr(), n, out.keys.data_ptr(), pos.data_ptr(),
        hist.data_ptr(), counts.data_ptr(), plan.data_ptr(), stream),
        "dedup_sort")
    dedup_sort_cuda.launches += 1
    return out


dedup_sort_cuda.launches = 0


def _number(srt: RadixSort, mirror=None):
    """The count and write passes over ``dedup_sort_cuda``'s result; with
    ``mirror`` = (tab, mask, window) the write pass also resolves each
    unique (``(Dedup, rows, found)``). The int32 outputs share one
    allocation, the int64 ones another."""
    n = srt.keys.shape[1]
    dev = srt.keys.device
    lib = _lib()
    uniq, order = torch.empty((2, n), dtype=torch.int64, device=dev)
    extra = n if mirror is not None else 0
    inverse, offsets, n_uniq, rows = torch.empty(
        2 * n + 2 + extra, dtype=torch.int32, device=dev).split(
            (n, n + 1, 1, extra))
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (srt.keys.data_ptr(), srt.pos.data_ptr(), srt.plan.data_ptr(), n,
            srt.work.data_ptr(), inverse.data_ptr(), uniq.data_ptr(),
            order.data_ptr(), offsets.data_ptr(), n_uniq.data_ptr())
    dd = Dedup(inverse, uniq, n_uniq.reshape(()), order, offsets)
    if mirror is None:
        _raise_on(lib, lib.pbx_dedup_number(*args, stream), "dedup_number")
        return dd
    tab, mask, window = mirror
    found = torch.empty(n, dtype=torch.bool, device=dev)
    _raise_on(lib, lib.pbx_dedup_number_probe(
        *args, tab.data_ptr(), tab.shape[0], mask, window, rows.data_ptr(),
        found.data_ptr(), stream), "dedup_number_probe")
    return dd, rows, found


def dedup_number_cuda(srt: RadixSort) -> Dedup:
    """K5's numbering half: the count and write passes over
    ``dedup_sort_cuda``'s result."""
    return _number(srt)


def dedup_number_probe_cuda(srt: RadixSort, tab: torch.Tensor, mask: int,
                            window: int
                            ) -> Tuple[Dedup, torch.Tensor, torch.Tensor]:
    """The numbering half with K6 folded into its write pass: ``(Dedup,
    rows [N] int32, found [N] bool)``, rows and found those of
    ``device_probe_cuda(tab, mask, window, uniq_keys, n_uniq)``."""
    _check_mirror(tab, mask, window, srt.keys.device,
                  "dedup_number_probe_cuda")
    return _number(srt, (tab, mask, window))


def device_dedup_cuda(keys: torch.Tensor) -> Dedup:
    """K5: the hand-written radix sort of the packed keys, then the
    hand-written count and write passes."""
    _check_keys(keys, "device_dedup_cuda")
    n = keys.shape[0]
    if n == 0:
        dev = keys.device
        return Dedup(torch.empty(0, dtype=torch.int32, device=dev),
                     torch.empty(0, dtype=torch.int64, device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev),
                     torch.empty(0, dtype=torch.int64, device=dev),
                     torch.zeros(1, dtype=torch.int32, device=dev))
    out = dedup_number_cuda(dedup_sort_cuda(keys))
    device_dedup_cuda.launches += 1
    return out


device_dedup_cuda.launches = 0


def device_dedup_probe_cuda(keys: torch.Tensor, tab: torch.Tensor,
                            mask: int, window: int
                            ) -> Tuple[Dedup, torch.Tensor, torch.Tensor]:
    """K5 with K6 folded in: the radix sort, the count pass and the write
    pass that resolves each unique it numbers in the mirror ``tab``
    ([cap + guard, 4] int32, ``mask`` = cap - 1). Returns ``(Dedup, rows
    [N] int32, found [N] bool)``; rows and found are 0 and False from
    n_uniq on."""
    _check_keys(keys, "device_dedup_probe_cuda")
    _check_mirror(tab, mask, window, keys.device, "device_dedup_probe_cuda")
    n = keys.shape[0]
    if n == 0:
        dev = keys.device
        return (device_dedup_cuda(keys),
                torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.bool, device=dev))
    out = _number(dedup_sort_cuda(keys), (tab, mask, window))
    device_dedup_probe_cuda.launches += 1
    return out


device_dedup_probe_cuda.launches = 0


def device_probe_cuda(tab: torch.Tensor, mask: int, window: int,
                      keys: torch.Tensor,
                      n_valid: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: ``(rows [N] int32, found [N] bool)`` of ``keys`` in the mirror
    ``tab`` ([cap + guard, 4] int32, ``mask`` = cap - 1); with ``n_valid``
    (an int32 device scalar) the keys from that position on are not
    probed (row 0, not found)."""
    _check_keys(keys, "device_probe_cuda")
    _check_mirror(tab, mask, window, keys.device, "device_probe_cuda")
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
