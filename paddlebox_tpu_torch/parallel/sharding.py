"""Expert parallelism (counterpart of ``paddlebox_tpu/parallel/sharding.py``
``expert_shardings``): a model's stacked ``[E, ...]`` expert weights (an
MMoE's ``StackedMLP``) split over the mesh's ``ep`` axis, each shard's
slice of the experts on its own device.

The reference annotates the params with a sharding and lets GSPMD
partition every consumer. Torch has no such annotation: a placement alone
moves weights but not the compute that reads them. So the port's
``expert_shardings`` returns the model with its expert stack replaced by a
``ShardedExperts`` module, a wrapper: its forward runs each shard's
experts on that shard's device and gathers their outputs in shard order
(``[B, E, out]``, as the stack gives them), and its slices are the
parameters the dense optimizer updates, each on its device. The gates and
towers stay replicated on the model's device. The plan (``Plan.expert``)
decides which tensors split and checks that the axis divides E: experts
the axis does not divide, or no tensor under the scope, raise
``PlanError``.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import StackedMLP
from paddlebox_tpu_torch.parallel.mesh import AXIS_EP, Mesh
from paddlebox_tpu_torch.parallel.plan import PartitionSpec, Plan, PlanError


class ShardedExperts(nn.Module):
    """A ``StackedMLP``'s ``E`` members split into ``ndev`` stacks of
    ``E / ndev``, stack ``s`` on shard ``s``'s device. ``[B, in]`` ->
    ``[B, E, out]`` on the input's device, the shards' outputs in shard
    order. Moving the module (``.to``) keeps each stack on its shard's
    device."""

    def __init__(self, stack: StackedMLP, plan: Plan,
                 specs: Dict[str, PartitionSpec]):
        super().__init__()
        self.devices = list(plan.mesh.devices)
        n = len(self.devices)
        self.shards = nn.ModuleList()
        for s in range(n):
            part = copy.deepcopy(stack)
            for name, p in stack.named_parameters():
                slices = plan.place(p.detach(), specs[name])
                part.get_parameter(name).data = slices[s].clone()
            self.shards.append(part)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for part, dev in zip(self.shards, self.devices):
            for p in part.parameters():
                if p.device != dev:
                    p.data = p.data.to(dev)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [part(x.to(dev)).to(x.device)
                for part, dev in zip(self.shards, self.devices)]
        return torch.cat(outs, dim=1)

    def unshard(self) -> StackedMLP:
        """The one stack of all ``E`` members, on the first shard's
        device."""
        whole = copy.deepcopy(self.shards[0])
        with torch.no_grad():
            for name, p in whole.named_parameters():
                parts = [part.get_parameter(name).detach().to(p.device)
                         for part in self.shards]
                p.data = torch.cat(parts)
        return whole


def expert_shardings(model: nn.Module, mesh: Mesh, axis: str = AXIS_EP,
                     expert_scope: str = "experts") -> nn.Module:
    """A copy of ``model`` whose ``expert_scope`` submodule (a
    ``StackedMLP``, every tensor leading with [E]) runs split over
    ``mesh``'s ``axis`` (``ShardedExperts``); every other tensor is
    replicated, as the plan's rules say. ``PlanError`` where E does not
    divide by the axis, or no tensor lies under the scope. The plan's
    resolved specs are the returned module's ``expert_specs``."""
    plan = Plan.expert(mesh, axis=axis, expert_scope=expert_scope)
    specs = plan.param_specs(model)
    stack = getattr(model, expert_scope, None)
    if not isinstance(stack, StackedMLP):
        raise PlanError(f"'{expert_scope}' of {type(model).__name__} is not "
                        "a stacked expert module (StackedMLP)")
    out = copy.deepcopy(model)
    prefix = f"{expert_scope}."
    setattr(out, expert_scope, ShardedExperts(
        stack, plan, {n[len(prefix):]: s for n, s in specs.items()
                      if n.startswith(prefix)}))
    out.expert_specs = specs
    return out


def unshard_experts(model: nn.Module,
                    expert_scope: str = "experts") -> nn.Module:
    """A copy of ``model`` (from ``expert_shardings``) with its experts
    one ``StackedMLP`` again: the unsharded model, for a bundle or a
    comparison."""
    out = copy.deepcopy(model)
    setattr(out, expert_scope, getattr(model, expert_scope).unshard())
    out.__dict__.pop("expert_specs", None)
    return out
