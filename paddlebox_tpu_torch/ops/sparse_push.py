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

The kernel's merge order comes from a stable sort of ``inverse`` and a
boundary kernel (``merge_order``; ``merge_order_plain`` is its plain
version), or from the caller: device-prep's dedup gives it.
``push_geometry`` fixes how the kernel spreads a row over lanes.

Inputs: ``values [cap, D]``, ``state [cap, max(state_dim, 1)]``,
``demb [Npad, D]`` (columns 0, 1 carry the show/clk increments),
``inverse [Npad]`` int32 position of each key's unique, ``uniq_rows
[Upad]`` int32 arena rows, ``uniq_mask [Upad]`` float32 (1.0 = live).
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING, Optional, Tuple

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


MAX_DIM = 256  # csrc/sparse_push.cu kMaxDim


def push_geometry(dim: int) -> Tuple[int, int]:
    """``(G, C)`` of the push kernel for rows of ``dim`` columns: a group of
    G lanes holds one unique's row, each lane C columns of it in registers,
    interleaved (lane l holds columns l, l + G, ...). G is the smallest power
    of two with ``4 G >= dim``, at most 32; ``C = ceil(dim / G)``."""
    if not 2 <= dim <= MAX_DIM:
        raise ValueError(f"push rows of {dim} columns: the kernel takes 2 to "
                         f"{MAX_DIM}")
    lanes = 1
    while 4 * lanes < dim and lanes < 32:
        lanes *= 2
    return lanes, -(-dim // lanes)


def group_desc(layout: "ArenaLayout") -> ctypes.Array:
    """The kernel's column-group descriptor, (start, width, gated, state
    offset) per group, as a C int array (``ArenaLayout`` builds it once)."""
    desc = []
    for gi, (start, width, gated) in enumerate(layout.groups):
        desc += [start, width, int(gated), int(layout.state_offsets[gi])]
    return (ctypes.c_int * max(len(desc), 1))(*desc)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("sparse_push")
    fn = lib.pbx_sparse_push
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pbx_merge_offsets.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_void_p]
    lib.pbx_merge_offsets.restype = ctypes.c_int
    lib.pbx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pbx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.pbx_cuda_error_string(rc).decode()}")


def merge_offsets_plain(inverse: torch.Tensor, upad: int) -> torch.Tensor:
    """``offsets`` [upad + 1] int32: where each unique's keys start in the
    keys grouped by unique (``inverse`` sorted or not, in ``[0, upad)``)."""
    counts = torch.bincount(inverse.long(), minlength=upad)
    if counts.shape[0] != upad:
        raise ValueError(f"inverse holds a unique >= upad {upad}")
    offsets = torch.zeros(upad + 1, dtype=torch.int32, device=inverse.device)
    offsets[1:] = counts.cumsum(0)
    return offsets


def merge_offsets(sorted_inv: torch.Tensor, upad: int) -> torch.Tensor:
    """The boundary kernel: ``merge_offsets_plain`` of the sorted inverse
    (int32, on the card), on the current stream. Counts each launch in
    ``merge_offsets.launches``."""
    if not sorted_inv.is_cuda or sorted_inv.dtype != torch.int32 or \
            sorted_inv.dim() != 1 or not sorted_inv.is_contiguous():
        raise ValueError("merge_offsets: sorted_inv must be a contiguous 1-D "
                         "int32 CUDA tensor")
    offsets = torch.empty(upad + 1, dtype=torch.int32,
                          device=sorted_inv.device)
    lib = _lib()
    stream = torch.cuda.current_stream(sorted_inv.device).cuda_stream
    _raise_on(lib, lib.pbx_merge_offsets(sorted_inv.data_ptr(),
                                         offsets.data_ptr(),
                                         sorted_inv.shape[0], upad, stream),
              "merge_offsets")
    merge_offsets.launches += 1
    return offsets


merge_offsets.launches = 0


def merge_order_plain(inverse: torch.Tensor, upad: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``order`` [Npad] int64, the key positions grouped by unique and
    ascending within each (a stable sort of ``inverse``), and ``offsets``
    [upad + 1] int32, where each unique's keys start in ``order``."""
    return (torch.sort(inverse, stable=True).indices,
            merge_offsets_plain(inverse, upad))


def merge_order(inverse: torch.Tensor, upad: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``merge_order_plain`` for a CPU ``inverse``; on the card a stable
    sort and the boundary kernel."""
    if not inverse.is_cuda:
        return merge_order_plain(inverse, upad)
    sorted_inv, order = torch.sort(inverse, stable=True)
    return order, merge_offsets(sorted_inv, upad)


def push_rows(layout: "ArenaLayout", values: torch.Tensor,
              state: torch.Tensor, demb: torch.Tensor, order: torch.Tensor,
              offsets: torch.Tensor, uniq_rows: torch.Tensor,
              uniq_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the push kernel on the current stream, given the merge order
    of ``merge_order``; the other inputs as ``sparse_push_cuda`` checks
    them. Counts each launch in ``sparse_push_cuda.launches``."""
    upad = uniq_rows.shape[0]
    if order.dtype != torch.int64 or order.shape != (demb.shape[0],) or \
            offsets.dtype != torch.int32 or offsets.shape != (upad + 1,):
        raise ValueError("push_rows: order must be int64 [Npad] and offsets "
                         "int32 [Upad + 1]")
    for name, t in (("order", order), ("offsets", offsets)):
        if t.device != values.device or not t.is_contiguous():
            raise ValueError(f"push_rows: {name} must be contiguous on "
                             f"{values.device}")
    conf = layout.conf
    dim = values.shape[1]
    lanes, cols = push_geometry(dim)
    lib = _lib()
    stream = torch.cuda.current_stream(values.device).cuda_stream
    _raise_on(lib, lib.pbx_sparse_push(
        values.data_ptr(), state.data_ptr(), demb.data_ptr(),
        order.data_ptr(), offsets.data_ptr(), uniq_rows.data_ptr(),
        uniq_mask.data_ptr(), upad, dim, state.shape[1], len(layout.groups),
        layout.push_desc, _OPTIMIZERS[conf.optimizer], lanes, cols,
        conf.learning_rate, conf.initial_g2sum, conf.embedx_threshold,
        stream), "sparse_push")
    sparse_push_cuda.launches += 1
    return values, state


def sparse_push_cuda(layout: "ArenaLayout", values: torch.Tensor,
                     state: torch.Tensor, demb: torch.Tensor,
                     inverse: torch.Tensor, uniq_rows: torch.Tensor,
                     uniq_mask: torch.Tensor,
                     merge: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort ``inverse`` on the card, find each unique's keys with the
    boundary kernel, then launch the push kernel, all on the current
    stream; ``merge`` gives the merge order (``order``, ``offsets``) in
    place of the sort and the boundary kernel. Precondition, not checked:
    the live uniques' rows are distinct and below the arena's capacity,
    ``inverse`` is in ``[0, Upad)`` and ``merge`` is ``merge_order``'s of
    it. Counts each launch in ``sparse_push_cuda.launches``."""
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
    upad = uniq_rows.shape[0]
    if upad == 0:
        return values, state
    order, offsets = merge if merge is not None else \
        merge_order(inverse, upad)
    return push_rows(layout, values, state, demb, order, offsets, uniq_rows,
                     uniq_mask)


sparse_push_cuda.launches = 0


def sparse_push(layout: "ArenaLayout", values: torch.Tensor,
                state: torch.Tensor, demb: torch.Tensor,
                inverse: torch.Tensor, uniq_rows: torch.Tensor,
                uniq_mask: torch.Tensor,
                merge: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors (with ``merge`` as the merge order when
    given), the plain version for CPU ones."""
    if values.is_cuda:
        return sparse_push_cuda(layout, values, state, demb, inverse,
                                uniq_rows, uniq_mask, merge)
    if values.device.type != "cpu":
        raise ValueError(f"sparse_push: unsupported device {values.device}")
    return sparse_push_plain(layout, values, state, demb, inverse, uniq_rows,
                             uniq_mask)
