"""Ring attention: sequence-parallel exact attention over the ``sp`` mesh
axis (counterpart of ``paddlebox_tpu/parallel/ring_attention.py``).

The sequence is split over the mesh's shards, shard ``d`` holding the
``d``-th block of ``T / n`` positions of Q, K and V on its device. In ``n``
ring steps each shard attends its Q block to the K/V block it holds, with
a running (max, sum, out) accumulator (the streaming softmax, exact
through log-sum-exp rescaling), then hands the K/V block to the next shard
through ``Mesh.ppermute``: after ``n`` hops every Q block has seen every
K/V block. Torch ops in the reference's order of operations (einsum, max,
exp), with its finite ``NEG_INF`` sentinel for masked scores: a row all of
whose scores are masked keeps p = 0 and its correction 0 rather than
exp(0) = 1. No fused attention kernel (the reference computes this
outside any Pallas kernel). Autograd through the ring gives the
gradients.

``ring_attention`` runs the ring over per-shard blocks;
``ring_self_attention`` splits ``[B, T, H, D]`` arrays on T over the mesh
and joins the result; ``dense_attention`` is the single-device reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from paddlebox_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e30


def _block_attn(q, k, v, m, l, o, q_pos, k_pos, causal: bool,
                scale: float):
    """One streaming-softmax step: q [B,Tq,H,D], k, v [B,Tk,H,D], m, l
    [B,H,Tq], o [B,Tq,H,D]; q_pos [Tq], k_pos [Tk] global positions."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m_blk = s.amax(dim=-1)
    m_new = torch.maximum(m, m_blk)
    p = torch.exp(s - m_new[..., None])
    p = torch.where(s > NEG_INF / 2, p, torch.zeros_like(p))
    corr = torch.exp(m - m_new)
    corr = torch.where(m <= NEG_INF / 2, torch.zeros_like(corr), corr)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], mesh: Mesh,
                   causal: bool = False,
                   scale: Optional[float] = None) -> List[torch.Tensor]:
    """``qs[d]``, ``ks[d]``, ``vs[d]``: shard ``d``'s [B, T_local, H, D]
    blocks, on its device. Returns each shard's output block."""
    n = mesh.size
    B, Tq, H, D = qs[0].shape
    scale = scale if scale is not None else 1.0 / float(D) ** 0.5
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc, q_pos = [], []
    for d, (q, dev) in enumerate(zip(qs, mesh.devices)):
        acc.append((torch.full((B, H, Tq), NEG_INF, device=dev),
                    torch.zeros((B, H, Tq), device=dev),
                    torch.zeros((B, Tq, H, D), device=dev)))
        q_pos.append(d * Tq + torch.arange(Tq, device=dev))
    kb, vb = [k.float() for k in ks], [v.float() for v in vs]
    for step in range(n):
        for d in range(n):
            src = (d - step) % n               # whose block shard d holds
            k_pos = src * Tq + torch.arange(Tq, device=q_pos[d].device)
            acc[d] = _block_attn(qs[d], kb[d], vb[d], *acc[d], q_pos[d],
                                 k_pos, causal, scale)
        if step < n - 1:
            kb, vb = mesh.ppermute(kb, perm), mesh.ppermute(vb, perm)
    out = []
    for q, (m, l, o) in zip(qs, acc):
        l = torch.clamp(l, min=1e-20)
        out.append((o / l.transpose(1, 2)[..., None]).to(q.dtype))
    return out


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh: Mesh, causal: bool = False) -> torch.Tensor:
    """q, k, v [B, T, H, D] with T divisible by the mesh's size: split on
    T over the shards (block ``d`` to shard ``d``'s device), the ring, the
    blocks joined on q's device."""
    n = mesh.size
    if q.shape[1] % n:
        raise ValueError(f"sequence {q.shape[1]} not divisible by {n} "
                         "shards")

    def split(x):
        return [c.to(dev) for c, dev in zip(x.chunk(n, dim=1),
                                            mesh.devices)]

    out = ring_attention(split(q), split(k), split(v), mesh, causal)
    return torch.cat([o.to(q.device) for o in out], dim=1)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Single-device attention, the reference: [B, T, H, D]."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(D, dtype=torch.float32, device=q.device))
    if causal:
        T = q.shape[1]
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
