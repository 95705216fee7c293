"""Seqpool+CVM forward and backward: the CUDA kernels and their plain
versions.

Counterpart of ``paddlebox_tpu/ops/pallas_seqpool.py``
(``pallas_seqpool_cvm``, the TPU kernel, and the gather backward its
custom_vjp shares with ``ops/seqpool_cvm.py``). ``seqpool_cvm`` and
``seqpool_cvm_grad`` take the plain version for a tensor on the CPU and the
hand-written kernel (``csrc/seqpool_cvm.cu``, ``csrc/seqpool_cvm_grad.cu``)
for a tensor on the card; there is no fallback between the two.

Shapes: ``emb [Npad, D]`` float32, ``segment_ids [Npad]`` int32 in
``[0, B*S]`` (``B*S`` marks padding keys, which are discarded) ->
``[B, S, D]`` (``use_cvm``) or ``[B, S, D - cvm_offset]``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from paddlebox_tpu_torch.ops import _build

# widest row the kernels take (MAX_DIM in csrc/seqpool_cvm.cu and
# csrc/seqpool_cvm_grad.cu): the forward keeps a tile of 128 rows and its
# halo of 16 in shared memory
MAX_DIM = 256


def bulk_loads(emb: torch.Tensor, segment_ids: torch.Tensor) -> bool:
    """Whether the kernel loads its tiles by TMA bulk copy: both pointers
    16-byte aligned. Otherwise (a view that starts mid-allocation) it takes
    its 4-byte cp.async path; both run in the kernel."""
    return emb.data_ptr() % 16 == 0 and segment_ids.data_ptr() % 16 == 0


def _cvm(pooled: torch.Tensor, use_cvm: bool,
         cvm_offset: int) -> torch.Tensor:
    if use_cvm:
        log_show = torch.log(pooled[..., 0:1] + 1.0)
        log_ctr = torch.log(pooled[..., 1:2] + 1.0) - log_show
        return torch.cat([log_show, log_ctr, pooled[..., 2:]], dim=-1)
    return pooled[..., cvm_offset:]


def seqpool_cvm_plain(emb: torch.Tensor, segment_ids: torch.Tensor,
                      batch_size: int, num_slots: int, use_cvm: bool = True,
                      cvm_offset: int = 2,
                      pad_value: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into ``B*S + 1`` rows (the last
    one takes the padding keys), ``+ pad_value``, then the CVM columns.
    Accepts ids in any order. On CUDA ``index_add_`` sums with atomics, so
    its float sums vary in the last bits from run to run."""
    B, S, D = batch_size, num_slots, emb.shape[-1]
    pooled = torch.zeros((B * S + 1, D), dtype=torch.float32,
                         device=emb.device)
    pooled.index_add_(0, segment_ids.long(), emb.float())
    pooled = (pooled[:B * S] + pad_value).reshape(B, S, D)
    return _cvm(pooled, use_cvm, cvm_offset)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("seqpool_cvm")
    fn = lib.pbx_seqpool_cvm_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pbx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pbx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def seqpool_cvm_cuda(emb: torch.Tensor, segment_ids: torch.Tensor,
                     batch_size: int, num_slots: int, use_cvm: bool = True,
                     cvm_offset: int = 2,
                     pad_value: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.

    Precondition, not checked: ``segment_ids`` is non-decreasing, as the
    batch assembler and the Criteo reader emit it. Counts each launch in
    ``seqpool_cvm_cuda.launches``."""
    if not (emb.is_cuda and segment_ids.device == emb.device):
        raise ValueError("seqpool_cvm_cuda needs emb and segment_ids on the "
                         f"same CUDA device, got {emb.device} and "
                         f"{segment_ids.device}")
    if emb.dtype != torch.float32 or emb.dim() != 2:
        raise ValueError(f"emb must be 2-D float32, got {emb.dtype} "
                         f"{tuple(emb.shape)}")
    if segment_ids.dtype != torch.int32 or segment_ids.dim() != 1:
        raise ValueError("segment_ids must be 1-D int32, got "
                         f"{segment_ids.dtype} {tuple(segment_ids.shape)}")
    if segment_ids.shape[0] != emb.shape[0]:
        raise ValueError(f"{segment_ids.shape[0]} segment ids for "
                         f"{emb.shape[0]} embedding rows")
    if not (emb.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("emb and segment_ids must be contiguous")
    D = emb.shape[1]
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"the kernel takes 1 <= D <= {MAX_DIM}, got {D}")
    if use_cvm and D < 2:
        raise ValueError(f"use_cvm needs D >= 2 (show, clk), got {D}")
    if not use_cvm and not 0 <= cvm_offset < D:
        raise ValueError(f"cvm_offset {cvm_offset} out of range for D={D}")
    out_dim = D if use_cvm else D - cvm_offset
    n_seg = batch_size * num_slots
    out = torch.empty((n_seg, out_dim), dtype=torch.float32,
                      device=emb.device)
    if n_seg == 0:
        return out.view(batch_size, num_slots, out_dim)
    lib = _lib()
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    rc = lib.pbx_seqpool_cvm_fwd(emb.data_ptr(), segment_ids.data_ptr(),
                                 out.data_ptr(), emb.shape[0], D, n_seg,
                                 int(use_cvm), cvm_offset, float(pad_value),
                                 int(bulk_loads(emb, segment_ids)), stream)
    if rc != 0:
        raise RuntimeError("seqpool_cvm kernel launch failed: "
                           f"{lib.pbx_cuda_error_string(rc).decode()}")
    with _count_lock:            # thread-scope replicas launch at once
        seqpool_cvm_cuda.launches += 1
    return out.view(batch_size, num_slots, out_dim)


seqpool_cvm_cuda.launches = 0
_count_lock = threading.Lock()


def seqpool_cvm(emb: torch.Tensor, segment_ids: torch.Tensor,
                batch_size: int, num_slots: int, use_cvm: bool = True,
                cvm_offset: int = 2, pad_value: float = 0.0) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if emb.is_cuda:
        return seqpool_cvm_cuda(emb, segment_ids, batch_size, num_slots,
                                use_cvm, cvm_offset, pad_value)
    if emb.device.type != "cpu":
        raise ValueError(f"seqpool_cvm: unsupported device {emb.device}")
    return seqpool_cvm_plain(emb, segment_ids, batch_size, num_slots,
                             use_cvm, cvm_offset, pad_value)


# -- backward -----------------------------------------------------------------
#
# The straight-through gather of ``paddlebox_tpu/ops/seqpool_cvm.py::_bwd``
# (an XLA function there, reused by the TPU kernel's custom_vjp): each key
# takes its segment's pooled grad, except that columns < cvm_offset carry
# the instance's ``cvm_in`` and padding keys get zero rows. Shapes:
# ``g [B, S, D]`` (use_cvm) or ``[B, S, D - cvm_offset]``, ``segment_ids
# [Npad]`` int32, ``cvm_in [B, cvm_offset]`` -> ``d_emb [Npad, D]``.


def seqpool_cvm_grad_plain(g: torch.Tensor, segment_ids: torch.Tensor,
                           cvm_in: torch.Tensor, batch_size: int,
                           num_slots: int, use_cvm: bool = True,
                           cvm_offset: int = 2) -> torch.Tensor:
    """Plain PyTorch version, line for line the reference's ``_bwd``."""
    B, S = batch_size, num_slots
    tail = g.reshape(B * S, -1)
    if use_cvm:
        tail = tail[:, cvm_offset:]
    tail = torch.cat([tail, tail.new_zeros((1, tail.shape[-1]))], dim=0)
    seg = segment_ids.long()
    d_tail = tail[seg]
    cvm_pad = torch.cat([cvm_in, cvm_in.new_zeros((1, cvm_in.shape[-1]))],
                        dim=0)
    d_cvm = cvm_pad[torch.clamp(seg // S, max=B)]
    d_cvm = torch.where((seg < B * S)[:, None], d_cvm,
                        d_cvm.new_zeros(()))
    return torch.cat([d_cvm, d_tail], dim=-1)


def grad_lanes(dim: int) -> int:
    """Threads a key of the backward kernel, for rows of ``dim`` columns:
    the least power of two that leaves each thread at most 16 of them, but
    at most 8, so that a warp owns at least 4 keys and a block's chunks
    stay within 16 KB of shared memory."""
    lanes = 1
    while lanes * 16 < dim and lanes < 8:
        lanes *= 2
    return lanes


@functools.lru_cache(maxsize=None)
def _grad_lib() -> ctypes.CDLL:
    lib = _build.load("seqpool_cvm_grad")
    fn = lib.pbx_seqpool_cvm_grad
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pbx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pbx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def seqpool_cvm_grad_cuda(g: torch.Tensor, segment_ids: torch.Tensor,
                          cvm_in: torch.Tensor, batch_size: int,
                          num_slots: int, use_cvm: bool = True,
                          cvm_offset: int = 2) -> torch.Tensor:
    """Launch the backward kernel (``csrc/seqpool_cvm_grad.cu``) on the
    current stream. Ids may come in any order. Precondition, not checked:
    ids in ``[0, B*S]``. Counts each launch in
    ``seqpool_cvm_grad_cuda.launches``."""
    B, S = batch_size, num_slots
    dev = segment_ids.device
    if not (segment_ids.is_cuda and g.device == dev and cvm_in.device == dev):
        raise ValueError("seqpool_cvm_grad_cuda needs g, segment_ids and "
                         f"cvm_in on one CUDA device, got {g.device}, {dev} "
                         f"and {cvm_in.device}")
    if g.dtype != torch.float32 or cvm_in.dtype != torch.float32:
        raise ValueError(f"g and cvm_in must be float32, got {g.dtype} and "
                         f"{cvm_in.dtype}")
    if segment_ids.dtype != torch.int32 or segment_ids.dim() != 1:
        raise ValueError("segment_ids must be 1-D int32, got "
                         f"{segment_ids.dtype} {tuple(segment_ids.shape)}")
    if g.dim() != 3 or g.shape[:2] != (B, S):
        raise ValueError(f"g must be [{B}, {S}, D'], got {tuple(g.shape)}")
    if cvm_in.shape != (B, cvm_offset):
        raise ValueError(f"cvm_in must be [{B}, {cvm_offset}], got "
                         f"{tuple(cvm_in.shape)}")
    D = g.shape[-1] + (0 if use_cvm else cvm_offset)
    if not 0 <= cvm_offset < D:
        raise ValueError(f"cvm_offset {cvm_offset} out of range for D={D}")
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"the kernel takes 1 <= D <= {MAX_DIM}, got {D}")
    g = g.contiguous()
    cvm_in = cvm_in.contiguous()
    segment_ids = segment_ids.contiguous()
    n_keys = segment_ids.shape[0]
    d_emb = torch.empty((n_keys, D), dtype=torch.float32, device=dev)
    if n_keys == 0:
        return d_emb
    lib = _grad_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.pbx_seqpool_cvm_grad(g.data_ptr(), segment_ids.data_ptr(),
                                  cvm_in.data_ptr(), d_emb.data_ptr(),
                                  n_keys, D, B * S, S, int(use_cvm),
                                  cvm_offset, grad_lanes(D), stream)
    if rc != 0:
        raise RuntimeError("seqpool_cvm_grad kernel launch failed: "
                           f"{lib.pbx_cuda_error_string(rc).decode()}")
    seqpool_cvm_grad_cuda.launches += 1
    return d_emb


seqpool_cvm_grad_cuda.launches = 0


def seqpool_cvm_grad(g: torch.Tensor, segment_ids: torch.Tensor,
                     cvm_in: torch.Tensor, batch_size: int, num_slots: int,
                     use_cvm: bool = True,
                     cvm_offset: int = 2) -> torch.Tensor:
    """The backward kernel for CUDA tensors, the plain version for CPU ones."""
    if segment_ids.is_cuda:
        return seqpool_cvm_grad_cuda(g, segment_ids, cvm_in, batch_size,
                                     num_slots, use_cvm, cvm_offset)
    if segment_ids.device.type != "cpu":
        raise ValueError(f"seqpool_cvm_grad: unsupported device "
                         f"{segment_ids.device}")
    return seqpool_cvm_grad_plain(g, segment_ids, cvm_in, batch_size,
                                  num_slots, use_cvm, cvm_offset)
