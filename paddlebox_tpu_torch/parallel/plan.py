"""The sharding plan, as far as the device-sharded engine uses it
(counterpart of parts of ``paddlebox_tpu/parallel/plan.py``): ``Plan`` with
its data and table axes and ``Plan.data_parallel``, and the gradient
helpers ``global_denominator``, ``reduce_loss`` and ``reduce_gradients``
over ``Mesh.psum``.

The gradient contract is the reference's:

1. the loss denominator is reduced over the shards BEFORE differentiation
   (``global_denominator``);
2. each shard differentiates a purely local loss;
3. the losses and the replicated dense params' gradients are summed over
   the shards AFTER it (``reduce_loss``, ``reduce_gradients``).

At ``ndev == 1`` every sum is the identity, so a one-shard mesh computes
the single-device step's numbers. The rule-matched specs, the ZeRO,
pipeline and expert layouts are not ported here (ROADMAP A.9b2).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from paddlebox_tpu_torch.parallel.mesh import AXIS_DP, Mesh


class PlanError(ValueError):
    """A plan that does not fit its mesh."""


@dataclasses.dataclass(frozen=True)
class Plan:
    """The mesh, the batch (data) axis and the table axis of a job."""

    mesh: Mesh
    data_axis: str = AXIS_DP
    table_axis: str = AXIS_DP
    name: str = "plan"

    def __post_init__(self):
        for ax in (self.data_axis, self.table_axis):
            if ax not in self.mesh.axis_names:
                raise PlanError(f"plan '{self.name}': axis '{ax}' not on "
                                f"the mesh {self.mesh.axis_names}")

    @classmethod
    def data_parallel(cls, mesh: Mesh, axis: str = AXIS_DP) -> "Plan":
        """Sync data parallelism: dense params replicated, the batch and
        the table sharded over ``axis``."""
        return cls(mesh=mesh, data_axis=axis, table_axis=axis,
                   name=f"dp-{axis}")


def global_denominator(xs: Sequence[torch.Tensor],
                       mesh: Mesh) -> torch.Tensor:
    """The shards' loss denominators (mask sums) summed, before the
    backward; a constant to it."""
    return mesh.psum(xs)


def reduce_loss(losses: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards' local losses (each over the global denominator) summed:
    the global-mean loss."""
    return mesh.psum(losses)


def reduce_gradients(grads: Sequence[Sequence[Optional[torch.Tensor]]],
                     mesh: Mesh) -> List[Optional[torch.Tensor]]:
    """``grads[d][i]``, shard ``d``'s gradient of replicated param ``i``
    (None = no gradient, a zero), summed over the shards in shard order,
    on shard 0's device."""
    out: List[Optional[torch.Tensor]] = []
    for i in range(len(grads[0])):
        parts = [g[i] for g in grads]
        if all(p is None for p in parts):
            out.append(None)
            continue
        ref = next(p for p in parts if p is not None)
        parts = [torch.zeros_like(ref) if p is None else p for p in parts]
        out.append(mesh.psum(parts))
    return out
