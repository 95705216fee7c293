"""Seqpool+CVM forward: the CUDA kernel and its plain version.

Counterpart of ``paddlebox_tpu/ops/pallas_seqpool.py``
(``pallas_seqpool_cvm``, the TPU kernel). ``seqpool_cvm`` takes the plain
version for a tensor on the CPU and the hand-written kernel
(``csrc/seqpool_cvm.cu``) for a tensor on the card; there is no fallback
between the two.

Shapes: ``emb [Npad, D]`` float32, ``segment_ids [Npad]`` int32 in
``[0, B*S]`` (``B*S`` marks padding keys, which are discarded) ->
``[B, S, D]`` (``use_cvm``) or ``[B, S, D - cvm_offset]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paddlebox_tpu_torch.ops import _build


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
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
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
                                 stream)
    if rc != 0:
        raise RuntimeError("seqpool_cvm kernel launch failed: "
                           f"{lib.pbx_cuda_error_string(rc).decode()}")
    seqpool_cvm_cuda.launches += 1
    return out.view(batch_size, num_slots, out_dim)


seqpool_cvm_cuda.launches = 0


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
