"""The un-fused CVM op (counterpart of ``paddlebox_tpu/ops/cvm.py``, the
reference's ``cvm`` operator): prepends the log-show / log-CTR context to
an embedding whose first two columns are raw (show, clk). XLA in the
reference, plain PyTorch here on every device.

forward:
    use_cvm=True : y = [log(x0+1), log(x1+1)-log(x0+1), x2...]  (same width)
    use_cvm=False: y = x[..., 2:]
backward: dx[..., 0:2] = the op's CVM input (show, clk) of each row, not a
derivative but the channel that carries the counts to the sparse push,
and dx[..., 2:] = dy's tail; ``cvm_in`` gets a zero grad.
"""

from __future__ import annotations

import torch


def cvm(x: torch.Tensor, cvm_in: torch.Tensor,
        use_cvm: bool = True) -> torch.Tensor:
    return _Cvm.apply(x, cvm_in, use_cvm)


def _forward(x: torch.Tensor, use_cvm: bool) -> torch.Tensor:
    if use_cvm:
        log_show = torch.log(x[..., 0:1] + 1.0)
        log_ctr = torch.log(x[..., 1:2] + 1.0) - log_show
        return torch.cat([log_show, log_ctr, x[..., 2:]], dim=-1)
    return x[..., 2:]


class _Cvm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, cvm_in, use_cvm):
        ctx.save_for_backward(cvm_in)
        ctx.use_cvm = use_cvm
        return _forward(x, use_cvm)

    @staticmethod
    def backward(ctx, g):
        (cvm_in,) = ctx.saved_tensors
        tail = g[..., 2:] if ctx.use_cvm else g
        dx = torch.cat([cvm_in[..., :2].to(g.dtype), tail], dim=-1)
        d_cvm = torch.zeros_like(cvm_in) if ctx.needs_input_grad[1] else None
        return dx, d_cvm, None
