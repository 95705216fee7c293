"""CTR dense ops: data_norm, rank_attention, batch_fc, scaled_fc,
cross_norm_hadamard (counterpart of ``paddlebox_tpu/ops/ctr_ops.py``).

The reference composes each op from gathers and einsums that XLA fuses;
none is a TPU kernel. Here each is the same composition in torch:
``torch.einsum``/``matmul`` where the reference has ``einsum``/``dot``,
autograd where it has ``jax.grad``, with the reference's two departures
from plain autodiff kept:

- ``rank_attention`` gives gradients to ``rank_param`` only, never into
  the gathered neighbor features (the reference's ``stop_gradient``);
- its parameter block index is clamped to ``[0, max_rank**2 - 1]``, as
  XLA's gather clamps an out-of-range index (an instance whose own rank
  is above ``max_rank`` reads the last block, not an error), and such a
  read gets no gradient, as XLA's scatter drops an out-of-range update.

``build_rank_offset`` is host numpy, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# data_norm
# ---------------------------------------------------------------------------


def data_norm(x: torch.Tensor, batch_size: torch.Tensor,
              batch_sum: torch.Tensor, batch_square_sum: torch.Tensor,
              scale_w: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Streaming feature normalization: means = batch_sum / batch_size,
    scales = sqrt(batch_size / batch_square_sum), y = (x - means) * scales,
    then ``* scale_w`` and ``+ bias`` where given. The summary triple is
    a constant of the step (update it with ``data_norm_stats`` and
    ``data_norm_update_summary``)."""
    means = batch_sum / batch_size
    scales = torch.sqrt(batch_size / batch_square_sum)
    y = (x - means) * scales
    if scale_w is not None:
        y = y * scale_w
    if bias is not None:
        y = y + bias
    return y


def data_norm_stats(x: torch.Tensor,
                    row_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-column (count, sum, square_sum) of this batch, over the rows
    ``row_mask`` keeps (all rows without it)."""
    if row_mask is None:
        n = torch.full(x.shape[1:], float(x.shape[0]), dtype=x.dtype,
                       device=x.device)
        s = x.sum(dim=0)
        sq = torch.square(x).sum(dim=0)
    else:
        m = row_mask[:, None]
        n = torch.broadcast_to(row_mask.sum(), x.shape[1:])
        s = (x * m).sum(dim=0)
        sq = (torch.square(x) * m).sum(dim=0)
    return n, s, sq


def data_norm_update_summary(batch_size, batch_sum, batch_square_sum,
                             stats: Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor],
                             summary_decay_rate: float = 0.9999999):
    """summary <- summary * decay + the batch's stat."""
    n, s, sq = stats
    d = summary_decay_rate
    return (batch_size * d + n, batch_sum * d + s,
            batch_square_sum * d + sq)


# ---------------------------------------------------------------------------
# rank_attention
# ---------------------------------------------------------------------------


def rank_attention(x: torch.Tensor, rank_offset: torch.Tensor,
                   rank_param: torch.Tensor, max_rank: int) -> torch.Tensor:
    """Ad-rank feature crossing.

    x [ins, d]; rank_offset [ins, 2*max_rank+1] int: column 0 the
    instance's own rank (1-based, 0 = invalid), then (rank_k, row_k)
    pairs of its same-PV neighbors; rank_param [max_rank*max_rank*d,
    para_col], viewed as max_rank**2 blocks [d, para_col] picked by
    (own-1)*max_rank + (rank_k-1), clamped to the block range.

    out[i] = sum_k x[row_k] @ P[block_k]; gradients reach ``rank_param``
    only, and not through a clamped block."""
    ins, d = x.shape
    para_col = rank_param.shape[1]
    nblocks = max_rank * max_rank
    P = rank_param.reshape(nblocks, d, para_col)
    ro = rank_offset.to(device=x.device, dtype=torch.int64)
    own = ro[:, 0] - 1                                   # [ins]
    fast = ro[:, 1::2] - 1                               # [ins, max_rank]
    idx = ro[:, 2::2]                                    # [ins, max_rank]
    valid = (own[:, None] >= 0) & (fast >= 0)
    xg = x.detach()[idx.clamp(0, ins - 1)]               # [ins, k, d]
    xg = torch.where(valid[..., None], xg, torch.zeros_like(xg))
    raw = own[:, None] * max_rank + fast
    Pg = P[raw.clamp(0, nblocks - 1)]                    # [ins, k, d, col]
    # XLA's gather clamps an index past the end, and the scatter of its
    # gradient drops the update: such a block is read but not trained
    over = raw > nblocks - 1
    Pg = torch.where(over[..., None, None], Pg.detach(), Pg)
    Pg = torch.where(valid[..., None, None], Pg, torch.zeros_like(Pg))
    return torch.einsum("ikd,ikdc->ic", xg, Pg)


def build_rank_offset(ranks, pv_offsets, max_rank: int) -> np.ndarray:
    """The rank_offset matrix [ins, 2*max_rank+1] int32 from per-PV ad
    ranks: ``ranks`` [ins] 1-based (0 = unknown); the instances of PV j
    are rows [pv_offsets[j], pv_offsets[j+1])."""
    ins = len(ranks)
    out = np.zeros((ins, 2 * max_rank + 1), dtype=np.int32)
    out[:, 0] = ranks
    for j in range(len(pv_offsets) - 1):
        lo, hi = int(pv_offsets[j]), int(pv_offsets[j + 1])
        for i in range(lo, hi):
            if ranks[i] <= 0:
                continue
            for other in range(lo, hi):
                r = int(ranks[other])
                if 0 < r <= max_rank:
                    out[i, 2 * (r - 1) + 1] = r
                    out[i, 2 * (r - 1) + 2] = other
    return out


# ---------------------------------------------------------------------------
# batch_fc, scaled_fc
# ---------------------------------------------------------------------------


def batch_fc(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             batchcount: int) -> torch.Tensor:
    """Per-block FC: x [ins, batchcount*in_feat] in column blocks, w
    [in_feat, batchcount*out_feat], bias [batchcount*out_feat];
    out[:, b] = x_b @ w_b + bias_b."""
    ins = x.shape[0]
    in_feat = x.shape[1] // batchcount
    out_feat = w.shape[1] // batchcount
    xb = x.reshape(ins, batchcount, in_feat)
    wb = w.reshape(in_feat, batchcount, out_feat)
    out = torch.einsum("ibf,fbo->ibo", xb, wb)
    return out.reshape(ins, batchcount * out_feat) + bias.reshape(1, -1)


def scaled_fc(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              input_scale_factor: float, bias_scale_factor: float,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """out = (x * input_scale) @ w + bias * bias_scale, the product in
    ``compute_dtype`` (bf16 by default; the tensor cores on the card),
    returned in float32."""
    xh = (x * input_scale_factor).to(compute_dtype)
    wh = w.to(compute_dtype)
    out = torch.matmul(xh, wh).to(torch.float32)
    return out + bias * bias_scale_factor


# ---------------------------------------------------------------------------
# cross_norm_hadamard
# ---------------------------------------------------------------------------


def cross_norm_raw(x: torch.Tensor, fields_num: int,
                   embed_dim: int) -> torch.Tensor:
    """Unnormalized cross features [ins, fields_num*(3*embed_dim+1)]: per
    pair (a, b) of x [ins, 2*fields_num*embed_dim], [a, b, a*b, a.b]."""
    ins = x.shape[0]
    pairs = x.reshape(ins, fields_num, 2, embed_dim)
    a, b = pairs[:, :, 0], pairs[:, :, 1]
    had = a * b
    dot = had.sum(dim=-1, keepdim=True)
    return torch.cat([a, b, had, dot], dim=-1).reshape(ins, -1)


def cross_norm_hadamard(x: torch.Tensor, summary_mean: torch.Tensor,
                        summary_scale: torch.Tensor, fields_num: int,
                        embed_dim: int) -> torch.Tensor:
    """``cross_norm_raw`` with each column normalized as
    (v - mean) * scale by a data_norm-style summary."""
    raw = cross_norm_raw(x, fields_num, embed_dim)
    return (raw - summary_mean) * summary_scale
