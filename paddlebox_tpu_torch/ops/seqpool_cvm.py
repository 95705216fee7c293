"""Fused sequence sum-pool + CVM transform, forward
(counterpart of ``paddlebox_tpu/ops/seqpool_cvm.py::fused_seqpool_cvm``).

``pooled[b, s, :] = pad_value + sum_k emb[k, :]`` over the keys of (b, s),
then with ``use_cvm`` ``out[..., 0] = log(show + 1)``,
``out[..., 1] = log(clk + 1) - log(show + 1)`` and the rest copied; without
it the first ``cvm_offset`` columns are dropped. The optional per-key show/
click filter, embed filter and quantization of the non-CVM columns run
before the pool.

The default variant goes to ``ops.seqpool_kernel.seqpool_cvm`` (the CUDA
kernel on the card); the filter and quant variants, and
``fused_seqpool_cvm_with_conv`` and ``fused_seqpool_cvm_with_pcoc`` below,
are plain PyTorch on every device, as they are XLA code and not a TPU
kernel in the reference.

The backward is the reference's straight-through rule (``_bwd``), not the
derivative of the forward: every key of (b, s) takes the pooled output's
grad, except that columns < cvm_offset carry the instance's ``cvm_in``
(the channel by which show/clk counts reach the push) and padding keys get
zero rows. The derivative of the CVM log columns is discarded, and the
filter and quant options do not change the backward. It runs
``ops.seqpool_kernel.seqpool_cvm_grad`` (the CUDA kernel on the card).
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.ops.seqpool_kernel import (seqpool_cvm,
                                                    seqpool_cvm_grad,
                                                    seqpool_cvm_plain)


def fused_seqpool_cvm(emb: torch.Tensor, segment_ids: torch.Tensor,
                      cvm_in: torch.Tensor, batch_size: int, num_slots: int,
                      use_cvm: bool = True, cvm_offset: int = 2,
                      pad_value: float = 0.0, need_filter: bool = False,
                      show_coeff: float = 0.2, clk_coeff: float = 1.0,
                      threshold: float = 0.96, embed_threshold: float = 0.0,
                      quant_ratio: int = 0) -> torch.Tensor:
    """emb [Npad, D] -> [B, S, D] (use_cvm) or [B, S, D - cvm_offset].

    ``cvm_in`` [B, cvm_offset] is the per-instance (show, clk, ...) input
    that only the backward reads; its width must equal ``cvm_offset``."""
    if cvm_in.shape[-1] != cvm_offset:
        raise ValueError(
            f"cvm_in width {cvm_in.shape[-1]} != cvm_offset {cvm_offset}; "
            "the backward pass writes cvm_in into grad columns <cvm_offset")
    return _FusedSeqpoolCvm.apply(
        emb, segment_ids, cvm_in, batch_size, num_slots, use_cvm, cvm_offset,
        pad_value, need_filter, show_coeff, clk_coeff, threshold,
        embed_threshold, quant_ratio)


def _forward(emb, segment_ids, batch_size, num_slots, use_cvm, cvm_offset,
             pad_value, need_filter, show_coeff, clk_coeff, threshold,
             embed_threshold, quant_ratio):
    if not need_filter and quant_ratio <= 0:
        return seqpool_cvm(emb, segment_ids, batch_size, num_slots, use_cvm,
                           cvm_offset, pad_value)
    x = emb
    if need_filter:
        show, clk = x[:, 0], x[:, 1]
        keep = (show - clk) * show_coeff + clk * clk_coeff >= threshold
        if embed_threshold > 0.0:
            w = torch.abs(x[:, cvm_offset])
            ex = torch.sqrt(torch.sum(torch.square(x[:, cvm_offset + 1:]),
                                      dim=-1))
            keep = keep & (w + ex >= embed_threshold)
        x = torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    if quant_ratio > 0:
        q = float(quant_ratio)
        tail = torch.floor(x[:, cvm_offset:] * q + 0.5) / q
        x = torch.cat([x[:, :cvm_offset], tail], dim=-1)
    return seqpool_cvm_plain(x, segment_ids, batch_size, num_slots, use_cvm,
                             cvm_offset, pad_value)


class _FusedSeqpoolCvm(torch.autograd.Function):
    """The forward above with the straight-through backward."""

    @staticmethod
    def forward(ctx, emb, segment_ids, cvm_in, batch_size, num_slots,
                use_cvm, cvm_offset, pad_value, need_filter, show_coeff,
                clk_coeff, threshold, embed_threshold, quant_ratio):
        ctx.save_for_backward(segment_ids, cvm_in)
        ctx.dims = (batch_size, num_slots, use_cvm, cvm_offset)
        return _forward(emb, segment_ids, batch_size, num_slots, use_cvm,
                        cvm_offset, pad_value, need_filter, show_coeff,
                        clk_coeff, threshold, embed_threshold, quant_ratio)

    @staticmethod
    def backward(ctx, g):
        segment_ids, cvm_in = ctx.saved_tensors
        d_emb = seqpool_cvm_grad(g, segment_ids, cvm_in, *ctx.dims)
        return (d_emb,) + (None,) * 13


# -- the with_conv and with_pcoc variants ------------------------------------
# (``paddlebox_tpu/ops/seqpool_cvm.py:140-269``): XLA in the reference,
# plain PyTorch here on every device; the pool sums each (row, slot)'s keys
# in key order, with no atomics, the backward is the straight-through rule
# with the variant's own head columns.

def _pool(emb, segment_ids, batch_size, num_slots, pad_value):
    """``[B, S, D]`` sums of each (row, slot)'s keys plus ``pad_value``.

    The keys are stably sorted by segment id and each segment summed from
    0 in key order (``segment_reduce`` over offsets, one thread a segment
    and column on CUDA), so the sums are the same bits on every run and
    device, and the CPU's equal ``index_add_``'s. Ids in any order; ids
    ``>= B*S`` are padding and dropped."""
    B, S = batch_size, num_slots
    ids, order = torch.sort(segment_ids.long(), stable=True)
    offsets = torch.searchsorted(ids, torch.arange(B * S + 1,
                                                   device=ids.device))
    pooled = torch.segment_reduce(emb.float()[order], "sum", offsets=offsets,
                                  axis=0, unsafe=True)
    return (pooled + pad_value).reshape(B, S, -1)


def _expand_grad(tail: torch.Tensor, cvm_cols: torch.Tensor,
                 segment_ids: torch.Tensor, batch_size: int,
                 num_slots: int) -> torch.Tensor:
    """Per-key grads: the tail columns of each key's (row, slot), after
    the head columns filled with its instance's ``cvm_cols``; padding keys
    get zero rows (the reference's ``_expand_grad``)."""
    B, S = batch_size, num_slots
    segs = segment_ids.long()
    tail = torch.cat([tail, tail.new_zeros((1, tail.shape[-1]))])
    d_tail = tail[segs]
    cvm_pad = torch.cat([cvm_cols, cvm_cols.new_zeros((1,
                                                       cvm_cols.shape[-1]))])
    d_cvm = cvm_pad[torch.clamp(segs // S, max=B)]
    d_cvm = torch.where((segs < B * S)[:, None], d_cvm,
                        d_cvm.new_zeros(()))
    return torch.cat([d_cvm, d_tail], dim=-1)


def fused_seqpool_cvm_with_conv(emb: torch.Tensor, segment_ids: torch.Tensor,
                                cvm_in: torch.Tensor, batch_size: int,
                                num_slots: int, use_cvm: bool = True,
                                show_filter: bool = False,
                                pad_value: float = 0.0) -> torch.Tensor:
    """emb [Npad, 3+E] -> [B, S, 3+E] (or 2+E with ``show_filter``, E with
    ``use_cvm=False``); the pooled head ``[show, clk, conv]`` becomes
    ``[log(show+1), log(clk+1), log(conv+1) - log(clk+1)]``, the show
    column dropped by ``show_filter``. ``cvm_in`` [B, 3] = per-instance
    (show, clk, conv), written into the grad's first 3 columns."""
    if cvm_in.shape[-1] != 3:
        raise ValueError("with_conv needs cvm_in of width 3 (show,clk,conv)")
    return _SeqpoolCvmWithConv.apply(emb, segment_ids, cvm_in, batch_size,
                                     num_slots, use_cvm, show_filter,
                                     pad_value)


class _SeqpoolCvmWithConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, emb, segment_ids, cvm_in, batch_size, num_slots,
                use_cvm, show_filter, pad_value):
        ctx.save_for_backward(segment_ids, cvm_in)
        ctx.dims = (batch_size, num_slots, use_cvm, show_filter)
        pooled = _pool(emb, segment_ids, batch_size, num_slots, pad_value)
        if not use_cvm:
            return pooled[..., 3:]
        log_show = torch.log(pooled[..., 0:1] + 1.0)
        log_clk = torch.log(pooled[..., 1:2] + 1.0)
        conv = torch.log(pooled[..., 2:3] + 1.0) - log_clk
        head = [log_clk, conv] if show_filter else [log_show, log_clk, conv]
        return torch.cat(head + [pooled[..., 3:]], dim=-1)

    @staticmethod
    def backward(ctx, g):
        segment_ids, cvm_in = ctx.saved_tensors
        B, S, use_cvm, show_filter = ctx.dims
        head = 0 if not use_cvm else (2 if show_filter else 3)
        tail = g.reshape(B * S, -1)[:, head:]
        d_emb = _expand_grad(tail, cvm_in, segment_ids, B, S)
        d_cvm = torch.zeros_like(cvm_in) if ctx.needs_input_grad[2] else None
        return (d_emb, None, d_cvm) + (None,) * 5


def fused_seqpool_cvm_with_pcoc(emb: torch.Tensor, segment_ids: torch.Tensor,
                                cvm_in: torch.Tensor, q_values: torch.Tensor,
                                batch_size: int, num_slots: int,
                                pclk_num: int,
                                pad_value: float = 0.0) -> torch.Tensor:
    """emb [Npad, 4+P+E] -> [B, S, 2+2P+E]: the pooled head ``[show, clk,
    show2, clk2, pclk_1..P]`` becomes ``[log(show+1), log(clk+1) -
    log(show+1), log(pclk_i+1) - log(show2+1).., log(pclk_i+1) -
    log(clk2+1)..]``. ``cvm_in`` [B, 4] (show, clk, show2, clk2) and
    ``q_values`` [B, P] are written into the grad's first 4+P columns."""
    if cvm_in.shape[-1] != 4:
        raise ValueError("with_pcoc needs cvm_in width 4 "
                         "(show, clk, show2, clk2)")
    if q_values.shape[-1] != pclk_num:
        raise ValueError(f"q_values width {q_values.shape[-1]} != "
                         f"pclk_num {pclk_num}")
    return _SeqpoolCvmWithPcoc.apply(emb, segment_ids, cvm_in, q_values,
                                     batch_size, num_slots, pclk_num,
                                     pad_value)


class _SeqpoolCvmWithPcoc(torch.autograd.Function):

    @staticmethod
    def forward(ctx, emb, segment_ids, cvm_in, q_values, batch_size,
                num_slots, pclk_num, pad_value):
        ctx.save_for_backward(segment_ids, cvm_in, q_values)
        ctx.dims = (batch_size, num_slots, pclk_num)
        P = pclk_num
        pooled = _pool(emb, segment_ids, batch_size, num_slots, pad_value)
        log_show = torch.log(pooled[..., 0:1] + 1.0)
        log_clk = torch.log(pooled[..., 1:2] + 1.0)
        log_show2 = torch.log(pooled[..., 2:3] + 1.0)
        log_clk2 = torch.log(pooled[..., 3:4] + 1.0)
        log_pclk = torch.log(pooled[..., 4:4 + P] + 1.0)
        return torch.cat([log_show, log_clk - log_show, log_pclk - log_show2,
                          log_pclk - log_clk2, pooled[..., 4 + P:]], dim=-1)

    @staticmethod
    def backward(ctx, g):
        segment_ids, cvm_in, q_values = ctx.saved_tensors
        B, S, P = ctx.dims
        tail = g.reshape(B * S, -1)[:, 2 + 2 * P:]
        d_emb = _expand_grad(tail, torch.cat([cvm_in, q_values], dim=-1),
                             segment_ids, B, S)
        need = ctx.needs_input_grad
        return (d_emb, None,
                torch.zeros_like(cvm_in) if need[2] else None,
                torch.zeros_like(q_values) if need[3] else None,
                None, None, None, None)
