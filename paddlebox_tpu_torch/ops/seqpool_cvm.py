"""Fused sequence sum-pool + CVM transform, forward
(counterpart of ``paddlebox_tpu/ops/seqpool_cvm.py::fused_seqpool_cvm``).

``pooled[b, s, :] = pad_value + sum_k emb[k, :]`` over the keys of (b, s),
then with ``use_cvm`` ``out[..., 0] = log(show + 1)``,
``out[..., 1] = log(clk + 1) - log(show + 1)`` and the rest copied; without
it the first ``cvm_offset`` columns are dropped. The optional per-key show/
click filter, embed filter and quantization of the non-CVM columns run
before the pool.

The default variant goes to ``ops.seqpool_kernel.seqpool_cvm`` (the CUDA
kernel on the card); the filter and quant variants are plain PyTorch on
every device, as they are XLA code and not a TPU kernel in the reference.

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
