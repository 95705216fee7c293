"""Sparse push: merge per-key grads by unique row, add show/clk, gate the
embedx groups and apply the in-table optimizer; the CUDA kernel and its
plain version.

Counterpart of ``paddlebox_tpu/ps/device_table.py::ArenaLayout.push`` with
``ops/sparse_optim.py::apply_update`` (XLA functions in the reference, not
TPU kernels), for every storage type of the arena: float32, bfloat16 and
int8 values, each with or without the variable-width layout
(``ps/device_table.py`` ``ArenaLayout`` says what each stores where). The
kernel has a variant for each (``push_variant`` names it), and each
variant counts its launches in ``PUSH_VARIANTS[name].launches`` beside the
total in ``sparse_push_cuda.launches``. Both versions update ``values`` and
``state`` in place, where the reference returns new arenas, and return
them. ``sparse_push`` takes the plain version for tensors on the CPU and the
hand-written kernel (``csrc/sparse_push.cu``) for tensors on the card; there
is no fallback between the two.

The kernel's merge order comes from a stable sort of ``inverse`` and a
boundary kernel (``merge_order``; ``merge_order_plain`` is its plain
version), or from the caller: device-prep's dedup gives it.
``push_geometry`` fixes how the kernel spreads a row over lanes.

The mesh step's requester merges its per-key grads before the exchange:
``merge_segments`` over a merge order it has (device prep: K5's, by
unique), or ``segment_merge`` by request position (the merge order as
above first). The merge alone is kernels of its own in
``csrc/sparse_push.cu``, counted in ``segment_merge_cuda.launches``;
``segment_merge_plain`` is its plain version, summing in the same fixed
order: key order, and past ``SEGMENT_CHUNK`` keys by chunks of that many,
whose sums add in chunk order.

The kernel also marks the step's rows dirty: given ``dirty``, a bool
bitmap [cap] (``DeviceTable.dirty_dev``), each unique's owner stores
``dirty[uniq_rows[u]] = True``, padding uniques' row 0 included. That is
the reference's ``dirty.at[uniq_rows].set(True)`` in its device-prep step
(``paddlebox_tpu/trainer/fused_step.py:373``, an XLA scatter), folded into
the launch the push makes anyway; ``mark_dirty_plain`` is its plain
version.

Inputs: ``values [cap, D]`` of the layout's value dtype, ``state [cap,
max(state_dim, 1)]`` float32, ``demb [Npad, pull_dim]`` float32 (columns
0, 1 carry the show/clk increments; ``pull_dim`` is wider than ``D`` under
the variable layout),
``inverse [Npad]`` int32 position of each key's unique, ``uniq_rows
[Upad]`` int32 arena rows, ``uniq_mask [Upad]`` float32 (1.0 = live).
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING, Optional, Tuple

import torch
import torch.nn.functional as F

from paddlebox_tpu_torch.ops import _build, sparse_optim

if TYPE_CHECKING:
    from paddlebox_tpu_torch.ps.device_table import ArenaLayout

_OPTIMIZERS = {"sgd": 0, "adagrad": 1, "adam": 2}


def mark_dirty_plain(dirty: torch.Tensor, uniq_rows: torch.Tensor) -> None:
    """Mark every unique's row in the bool bitmap ``dirty``, in place."""
    dirty.index_fill_(0, uniq_rows.long(), True)


def sparse_push_plain(layout: "ArenaLayout", values: torch.Tensor,
                      state: torch.Tensor, demb: torch.Tensor,
                      inverse: torch.Tensor, uniq_rows: torch.Tensor,
                      uniq_mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, line for line the reference's push for every
    layout. The merge is an ``index_add_``: in key order on the CPU, with
    atomics (in no fixed order) on the card."""
    conf = layout.conf
    upad = uniq_rows.shape[0]
    rows = uniq_rows.long()
    merged = torch.zeros((upad, demb.shape[1]), dtype=torch.float32,
                         device=demb.device)
    merged.index_add_(0, inverse.long(), demb)
    uraw = values[rows].float()
    ustate = state[rows]
    live = uniq_mask > 0.0
    so = layout.stat_off
    old_stats = ustate[:, :2] if layout.stats_in_state else uraw[:, :2]
    new_show = old_stats[:, 0] + merged[:, 0] * uniq_mask
    new_clk = old_stats[:, 1] + merged[:, 1] * uniq_mask
    stats = [new_show[:, None], new_clk[:, None]]
    # value columns 0, 1: show/clk, or (low precision) left as loaded
    cols = [uraw[:, :2]] if layout.stats_in_state else list(stats)
    scols = list(stats) if layout.stats_in_state else []
    scale_cols, qcols, new_code = [], [torch.zeros_like(uraw[:, :2])], None
    for gi, (start, width, gated) in enumerate(layout.groups):
        w = uraw[:, start:start + width]
        if layout.quantized:
            w = w * ustate[:, 2 + gi:3 + gi]
        mask = live
        if gated:
            mask = mask & (new_show >= conf.embedx_threshold)
        if layout.variable and gated:
            # the union group trains on the grads of the row's size code;
            # an unclaimed live row is claimed by the first of base and
            # expand whose merged grads hold a nonzero (base wins a tie)
            ex, ed = conf.embedx_dim, conf.expand_dim
            gb = merged[:, start:start + ex]
            ge = merged[:, start + ex:start + ex + ed]
            cur = ustate[:, layout.size_col]
            claim = torch.where((gb != 0.0).any(dim=1), 1.0,
                                torch.where((ge != 0.0).any(dim=1), 2.0,
                                            0.0))
            new_code = torch.where(live & (cur == 0.0), claim, cur)
            g = torch.where(
                (new_code == 1.0)[:, None], F.pad(gb, (0, width - ex)),
                torch.where((new_code == 2.0)[:, None],
                            F.pad(ge, (0, width - ed)), 0.0))
            mask = mask & (new_code > 0.0)
        else:
            g = merged[:, start:start + width]
        st = ustate[:, so + int(layout.state_offsets[gi]):
                    so + int(layout.state_offsets[gi + 1])]
        new_w, new_st = sparse_optim.apply_update(conf, w, g, st, mask)
        cols.append(new_w)
        if layout.quantized:
            # every group of a live row, masked ones too, at the scale of
            # its new max: IEEE divides (a tensor divisor, never a
            # multiply by a reciprocal), rounded half to even
            gscale = torch.clamp_min(new_w.abs().amax(dim=1), 1e-12) / \
                new_w.new_full((), layout.QMAX)
            scale_cols.append(gscale[:, None])
            qcols.append(torch.clamp(torch.round(new_w / gscale[:, None]),
                                     -layout.QMAX, layout.QMAX))
        if new_st.shape[1]:
            scols.append(new_st)
    if layout.quantized:
        new_uvals = torch.cat(qcols, dim=1)
        scols = scols[:2] + scale_cols + scols[2:]
    else:
        new_uvals = torch.cat(cols, dim=1)
    if layout.variable:
        scols.append(new_code[:, None])
    new_ustate = torch.cat(scols, dim=1) if scols else ustate
    # padding entries all point at row 0 and carry its own values, so the
    # duplicate writes there are idempotent
    values[rows] = torch.where(live[:, None], new_uvals, uraw).to(
        values.dtype)
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


# the kernel's storage kind of each value dtype, and its variant's name
_KINDS = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"),
          torch.int8: (2, "int8")}


def group_desc(layout: "ArenaLayout") -> ctypes.Array:
    """The kernel's layout descriptor as a C int array (``ArenaLayout``
    builds it once): the storage kind (0 float32, 1 bfloat16, 2 int8), the
    variable flag, the group count, ``stat_off``, ``size_col`` (-1 unless
    variable), ``embedx_dim``, ``expand_dim`` and the grad width; then per
    group (start, width, gated, first state column of its optimizer state,
    its int8 scale column or -1)."""
    conf = layout.conf
    desc = [_KINDS[layout.value_dtype][0], int(layout.variable),
            len(layout.groups), layout.stat_off, layout.size_col,
            conf.embedx_dim, conf.expand_dim, layout.grad_dim]
    for gi, (start, width, gated) in enumerate(layout.groups):
        desc += [start, width, int(gated),
                 layout.stat_off + int(layout.state_offsets[gi]),
                 2 + gi if layout.quantized else -1]
    return (ctypes.c_int * len(desc))(*desc)


def push_variant(layout: "ArenaLayout") -> str:
    """The kernel variant of a layout: ``f32``, ``bf16``, ``int8``,
    ``var_f32``, ``var_bf16`` or ``var_int8``."""
    kind = _KINDS[layout.value_dtype][1]
    return f"var_{kind}" if layout.variable else kind


class LaunchCounter:
    """The launch count of one push variant (the ``launches`` attribute
    that the wrappers carry, for a variant of a kernel)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


PUSH_VARIANTS = {v: LaunchCounter(f"sparse_push_{v}") for v in
                 ("f32", "bf16", "int8", "var_f32", "var_bf16", "var_int8")}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("sparse_push")
    fn = lib.pbx_sparse_push
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pbx_merge_offsets.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_void_p]
    lib.pbx_merge_offsets.restype = ctypes.c_int
    lib.pbx_segment_merge_scratch.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.pbx_segment_merge_scratch.restype = ctypes.c_int64
    lib.pbx_segment_merge.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p]
    lib.pbx_segment_merge.restype = ctypes.c_int
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


# csrc/sparse_push.cu kChunk: a segment of more keys sums by chunks of this
# many (a constant of the merge, never derived from the card)
SEGMENT_CHUNK = 1024


def _sum_in_order(src: torch.Tensor, order: Optional[torch.Tensor],
                  starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[n, D] float32, row s the sum of the rows of ``src`` at
    ``order[starts[s]:starts[s] + lens[s]]`` (``order`` None: those
    positions themselves), added in that order from 0; zeros where
    ``lens[s]`` is 0. One pass a key rank over all rows at once."""
    out = torch.zeros((starts.shape[0], src.shape[1]), dtype=torch.float32,
                      device=src.device)
    if starts.shape[0] == 0:
        return out
    # rows by length, longest first: the ones still adding at rank j are a
    # prefix
    lens_sorted, by_len = torch.sort(lens, descending=True, stable=True)
    longest = int(lens_sorted[0])
    # rows with more than j keys, for each rank j
    live_counts = starts.shape[0] - torch.searchsorted(
        lens_sorted.flip(0), torch.arange(longest, device=lens.device),
        right=True)
    acc = torch.zeros_like(out)
    for j, n in enumerate(live_counts.tolist()):
        at = starts[by_len[:n]] + j
        acc[:n] += src[at if order is None else order[at]]
    out[by_len] = acc
    return out


def segment_merge_plain(demb: torch.Tensor, order: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of the segment merge: ``g`` [n_seg, D] float32, row s
    the sum of ``demb``'s rows ``order[offsets[s]:offsets[s + 1]]``, in the
    kernel's fixed order (no ``index_add_``): a segment of at most
    ``SEGMENT_CHUNK`` keys from 0, its keys in that order; a longer one each
    chunk of ``SEGMENT_CHUNK`` keys so, then from 0 the chunks' sums in
    chunk order. A segment with no keys is zeros; keys past
    ``offsets[n_seg]`` are not read. One pass a key rank over all chunks at
    once, then one a chunk rank: at most ``SEGMENT_CHUNK`` passes plus the
    most chunks of a segment."""
    n_seg = offsets.shape[0] - 1
    if n_seg == 0 or demb.shape[0] == 0:
        return torch.zeros((n_seg, demb.shape[1]), dtype=torch.float32,
                           device=demb.device)
    starts = offsets[:-1].long()
    lens = offsets[1:].long() - starts
    C = SEGMENT_CHUNK
    # every segment is one chunk or more (an empty one is one empty chunk)
    chunks = torch.clamp_min(-(-lens // C), 1)
    first = torch.cumsum(chunks, 0) - chunks
    seg_of = torch.repeat_interleave(
        torch.arange(n_seg, device=lens.device), chunks)
    j = torch.arange(seg_of.shape[0], device=lens.device) - first[seg_of]
    partial = _sum_in_order(demb, order, starts[seg_of] + j * C,
                            torch.clamp_max(lens[seg_of] - j * C, C))
    g = partial[first]
    multi = (chunks > 1).nonzero().squeeze(1)
    if multi.shape[0]:
        g[multi] = _sum_in_order(partial, None, first[multi], chunks[multi])
    return g


def segment_merge_cuda(demb: torch.Tensor, order: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """``segment_merge_plain`` on the card (``csrc/sparse_push.cu``: a
    thread a (segment, column) output of a segment of at most 32 keys; a
    block of 128 threads a chunk of a longer one, the chunks' sums combined
    by the last of them to finish), on the current stream, bit for bit: the
    same fixed order. Counts each call in ``segment_merge_cuda.launches``."""
    dev = demb.device
    if demb.dtype != torch.float32 or demb.dim() != 2 or \
            not 1 <= demb.shape[1] <= MAX_DIM or \
            order.dtype != torch.int64 or order.shape != (demb.shape[0],) \
            or offsets.dtype != torch.int32 or offsets.dim() != 1 or \
            offsets.shape[0] < 1:
        raise ValueError("segment_merge_cuda: demb must be float32 [N, D] "
                         f"(D <= {MAX_DIM}), order int64 [N] and offsets "
                         "int32 [n_seg + 1]")
    for name, t in (("demb", demb), ("order", order), ("offsets", offsets)):
        if not t.is_cuda or t.device != dev or not t.is_contiguous():
            raise ValueError(f"segment_merge_cuda: {name} must be a "
                             f"contiguous CUDA tensor on {dev}")
    n_seg = offsets.shape[0] - 1
    n_keys, dim = demb.shape
    g = torch.empty((n_seg, dim), dtype=torch.float32, device=dev)
    lib = _lib()
    # the counters, the long kernel's work items and the chunks' sums, at
    # their worst case for n_keys
    words = lib.pbx_segment_merge_scratch(n_keys, dim)
    work = torch.empty(words, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib, lib.pbx_segment_merge(
        demb.data_ptr(), order.data_ptr(), offsets.data_ptr(), g.data_ptr(),
        work.data_ptr(), words, n_keys, n_seg, dim, stream), "segment_merge")
    segment_merge_cuda.launches += 1
    return g


segment_merge_cuda.launches = 0


def merge_segments(demb: torch.Tensor, order: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """``segment_merge_plain``'s ``g``, in its fixed order (key order, by
    chunks of ``SEGMENT_CHUNK`` keys past that many): the kernel on the
    card, the plain version on the CPU."""
    if demb.is_cuda:
        return segment_merge_cuda(demb.contiguous(), order, offsets)
    if demb.device.type != "cpu":
        raise ValueError(f"merge_segments: unsupported device {demb.device}")
    return segment_merge_plain(demb, order, offsets)


def segment_merge(demb: torch.Tensor, seg: torch.Tensor,
                  n_seg: int) -> torch.Tensor:
    """``g`` [n_seg, D]: row s the sum of the rows of ``demb`` [N, D] whose
    ``seg`` (int32 [N], in [0, n_seg]) is s, in ascending key order (by
    chunks of ``SEGMENT_CHUNK`` keys past that many, as
    ``segment_merge_plain`` says); a key
    whose ``seg`` is ``n_seg`` is dropped (the reference's
    ``jax.ops.segment_sum`` drops ids outside [0, num_segments)).
    ``merge_order`` of ``seg`` over n_seg + 1 segments, then the kernel on
    the card over the first n_seg of them, the plain version on the
    CPU."""
    order, offsets = merge_order(seg, n_seg + 1)
    return merge_segments(demb, order, offsets[:n_seg + 1])


def push_rows(layout: "ArenaLayout", values: torch.Tensor,
              state: torch.Tensor, demb: torch.Tensor, order: torch.Tensor,
              offsets: torch.Tensor, uniq_rows: torch.Tensor,
              uniq_mask: torch.Tensor, dirty: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the push kernel's variant of ``layout`` on the current
    stream, given the merge order of ``merge_order``; the other inputs as
    ``sparse_push_cuda`` checks them. Counts each launch in
    ``sparse_push_cuda.launches`` and in its variant's counter."""
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
        uniq_mask.data_ptr(), None if dirty is None else dirty.data_ptr(),
        upad, dim, state.shape[1], layout.push_desc, len(layout.push_desc),
        _OPTIMIZERS[conf.optimizer], lanes, cols, conf.learning_rate,
        conf.initial_g2sum, conf.embedx_threshold, stream), "sparse_push")
    sparse_push_cuda.launches += 1
    PUSH_VARIANTS[push_variant(layout)].launches += 1
    return values, state


def sparse_push_cuda(layout: "ArenaLayout", values: torch.Tensor,
                     state: torch.Tensor, demb: torch.Tensor,
                     inverse: torch.Tensor, uniq_rows: torch.Tensor,
                     uniq_mask: torch.Tensor,
                     merge: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     dirty: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort ``inverse`` on the card, find each unique's keys with the
    boundary kernel, then launch the push kernel, all on the current
    stream; ``merge`` gives the merge order (``order``, ``offsets``) in
    place of the sort and the boundary kernel, and the kernel marks each
    unique's row in ``dirty`` (a bool [cap] bitmap) when it is given.
    Precondition, not checked:
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
    if values.dtype != layout.value_dtype or values.dim() != 2 or \
            values.shape[1] != layout.dim:
        raise ValueError(f"sparse_push_cuda: values {values.dtype} "
                         f"{tuple(values.shape)} do not fit the layout's "
                         f"{layout.value_dtype} rows of width {layout.dim}")
    for name in ("state", "demb", "uniq_mask"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"sparse_push_cuda: {name} must be float32, "
                             f"got {tensors[name].dtype}")
    for name in ("inverse", "uniq_rows"):
        if tensors[name].dtype != torch.int32 or tensors[name].dim() != 1:
            raise ValueError(f"sparse_push_cuda: {name} must be 1-D int32")
    if demb.shape != (inverse.shape[0], layout.grad_dim):
        raise ValueError(f"demb {tuple(demb.shape)} does not fit "
                         f"{inverse.shape[0]} keys of width "
                         f"{layout.grad_dim}")
    if state.dim() != 2 or state.shape[0] != values.shape[0] or \
            state.shape[1] < max(layout.state_dim, 1):
        raise ValueError(f"state {tuple(state.shape)} does not fit values "
                         f"{tuple(values.shape)} and state_dim "
                         f"{layout.state_dim}")
    if uniq_mask.shape != uniq_rows.shape:
        raise ValueError("uniq_mask and uniq_rows differ in shape")
    if dirty is not None and (
            dirty.device != dev or dirty.dtype != torch.bool or
            dirty.shape != (values.shape[0],) or not dirty.is_contiguous()):
        raise ValueError(f"sparse_push_cuda: dirty must be a contiguous "
                         f"bool [{values.shape[0]}] tensor on {dev}")
    upad = uniq_rows.shape[0]
    if upad == 0:
        return values, state
    order, offsets = merge if merge is not None else \
        merge_order(inverse, upad)
    return push_rows(layout, values, state, demb, order, offsets, uniq_rows,
                     uniq_mask, dirty)


sparse_push_cuda.launches = 0


def sparse_push(layout: "ArenaLayout", values: torch.Tensor,
                state: torch.Tensor, demb: torch.Tensor,
                inverse: torch.Tensor, uniq_rows: torch.Tensor,
                uniq_mask: torch.Tensor,
                merge: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                dirty: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors (with ``merge`` as the merge order when
    given), the plain versions for CPU ones; each marks the uniques' rows
    in ``dirty`` when it is given."""
    if values.is_cuda:
        return sparse_push_cuda(layout, values, state, demb, inverse,
                                uniq_rows, uniq_mask, merge, dirty)
    if values.device.type != "cpu":
        raise ValueError(f"sparse_push: unsupported device {values.device}")
    sparse_push_plain(layout, values, state, demb, inverse, uniq_rows,
                      uniq_mask)
    if dirty is not None:
        mark_dirty_plain(dirty, uniq_rows)
    return values, state
