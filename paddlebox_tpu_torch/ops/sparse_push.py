"""Sparse push: merge per-key grads by unique row, add show/clk, gate the
embedx groups and apply the in-table optimizer; the CUDA kernel and its
plain version.

Counterpart of ``paddlebox_tpu/ps/device_table.py::ArenaLayout.push`` with
``ops/sparse_optim.py::apply_update`` (XLA functions in the reference, not
TPU kernels), for the float32 arena. Both versions update ``values`` and
``state`` in place, where the reference returns new arenas, and return
them. ``sparse_push`` takes the plain version for tensors on the CPU and the
hand-written kernel (``csrc/sparse_push.cu``) for tensors on the card; there
is no fallback between the two.

Inputs: ``values [cap, D]``, ``state [cap, max(state_dim, 1)]``,
``demb [Npad, D]`` (columns 0, 1 carry the show/clk increments),
``inverse [Npad]`` int32 position of each key's unique, ``uniq_rows
[Upad]`` int32 arena rows, ``uniq_mask [Upad]`` float32 (1.0 = live).
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING, Tuple

import torch

from paddlebox_tpu_torch.ops import _build, sparse_optim

if TYPE_CHECKING:
    from paddlebox_tpu_torch.ps.device_table import ArenaLayout

_OPTIMIZERS = {"sgd": 0, "adagrad": 1, "adam": 2}


def sparse_push_plain(layout: "ArenaLayout", values: torch.Tensor,
                      state: torch.Tensor, demb: torch.Tensor,
                      inverse: torch.Tensor, uniq_rows: torch.Tensor,
                      uniq_mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, line for line the reference's push. The merge
    is an ``index_add_``: in key order on the CPU, with atomics (in no fixed
    order) on the card."""
    conf = layout.conf
    upad = uniq_rows.shape[0]
    rows = uniq_rows.long()
    merged = torch.zeros((upad, demb.shape[1]), dtype=torch.float32,
                         device=demb.device)
    merged.index_add_(0, inverse.long(), demb)
    uraw = values[rows]
    ustate = state[rows]
    live = uniq_mask > 0.0
    new_show = uraw[:, 0] + merged[:, 0] * uniq_mask
    new_clk = uraw[:, 1] + merged[:, 1] * uniq_mask
    cols = [new_show[:, None], new_clk[:, None]]
    scols = []
    for gi, (start, width, gated) in enumerate(layout.groups):
        w = uraw[:, start:start + width]
        mask = live
        if gated:
            mask = mask & (new_show >= conf.embedx_threshold)
        g = merged[:, start:start + width]
        st = ustate[:, int(layout.state_offsets[gi]):
                    int(layout.state_offsets[gi + 1])]
        new_w, new_st = sparse_optim.apply_update(conf, w, g, st, mask)
        cols.append(new_w)
        if new_st.shape[1]:
            scols.append(new_st)
    new_uvals = torch.cat(cols, dim=1)
    new_ustate = torch.cat(scols, dim=1) if scols else ustate
    # padding entries all point at row 0 and carry its own values, so the
    # duplicate writes there are idempotent
    values[rows] = torch.where(live[:, None], new_uvals, uraw)
    state[rows] = torch.where(live[:, None], new_ustate, ustate)
    return values, state


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("sparse_push")
    fn = lib.pbx_sparse_push
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pbx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pbx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def merge_order(inverse: torch.Tensor, upad: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``order`` [Npad] int32, the key positions grouped by unique and
    ascending within each (a stable sort of ``inverse``), and ``offsets``
    [upad + 1] int32, where each unique's keys start in ``order``."""
    sorted_inv, order = torch.sort(inverse, stable=True)
    offsets = torch.searchsorted(
        sorted_inv, torch.arange(upad + 1, dtype=inverse.dtype,
                                 device=inverse.device), out_int32=True)
    return order.int(), offsets


def sparse_push_cuda(layout: "ArenaLayout", values: torch.Tensor,
                     state: torch.Tensor, demb: torch.Tensor,
                     inverse: torch.Tensor, uniq_rows: torch.Tensor,
                     uniq_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort ``inverse`` on the card, then launch the push kernel on the
    current stream. Precondition, not checked: the live uniques' rows are
    distinct and below the arena's capacity, and ``inverse`` is in
    ``[0, Upad)``. Counts each launch in ``sparse_push_cuda.launches``."""
    dev = values.device
    tensors = dict(values=values, state=state, demb=demb, inverse=inverse,
                   uniq_rows=uniq_rows, uniq_mask=uniq_mask)
    for name, t in tensors.items():
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"sparse_push_cuda: {name} is on {t.device}, "
                             f"values on {dev}; all must share one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"sparse_push_cuda: {name} must be contiguous")
    for name in ("values", "state", "demb", "uniq_mask"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"sparse_push_cuda: {name} must be float32, "
                             f"got {tensors[name].dtype}")
    for name in ("inverse", "uniq_rows"):
        if tensors[name].dtype != torch.int32 or tensors[name].dim() != 1:
            raise ValueError(f"sparse_push_cuda: {name} must be 1-D int32")
    dim = values.shape[1]
    if demb.shape != (inverse.shape[0], dim):
        raise ValueError(f"demb {tuple(demb.shape)} does not fit "
                         f"{inverse.shape[0]} keys of width {dim}")
    if state.dim() != 2 or state.shape[0] != values.shape[0] or \
            state.shape[1] < max(layout.state_dim, 1):
        raise ValueError(f"state {tuple(state.shape)} does not fit values "
                         f"{tuple(values.shape)} and state_dim "
                         f"{layout.state_dim}")
    if uniq_mask.shape != uniq_rows.shape:
        raise ValueError("uniq_mask and uniq_rows differ in shape")
    conf = layout.conf
    upad = uniq_rows.shape[0]
    if upad == 0:
        return values, state
    order, offsets = merge_order(inverse, upad)
    desc = []
    for gi, (start, width, gated) in enumerate(layout.groups):
        desc += [start, width, int(gated), int(layout.state_offsets[gi])]
    desc_arr = (ctypes.c_int * max(len(desc), 1))(*desc)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.pbx_sparse_push(
        values.data_ptr(), state.data_ptr(), demb.data_ptr(),
        order.data_ptr(), offsets.data_ptr(), uniq_rows.data_ptr(),
        uniq_mask.data_ptr(), upad, dim, state.shape[1],
        len(layout.groups), desc_arr, _OPTIMIZERS[conf.optimizer],
        conf.learning_rate, conf.initial_g2sum, conf.embedx_threshold,
        stream)
    if rc != 0:
        raise RuntimeError("sparse_push kernel launch failed: "
                           f"{lib.pbx_cuda_error_string(rc).decode()}")
    sparse_push_cuda.launches += 1
    return values, state


sparse_push_cuda.launches = 0


def sparse_push(layout: "ArenaLayout", values: torch.Tensor,
                state: torch.Tensor, demb: torch.Tensor,
                inverse: torch.Tensor, uniq_rows: torch.Tensor,
                uniq_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if values.is_cuda:
        return sparse_push_cuda(layout, values, state, demb, inverse,
                                uniq_rows, uniq_mask)
    if values.device.type != "cpu":
        raise ValueError(f"sparse_push: unsupported device {values.device}")
    return sparse_push_plain(layout, values, state, demb, inverse, uniq_rows,
                             uniq_mask)
