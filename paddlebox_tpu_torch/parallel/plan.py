"""The sharding plan (counterpart of ``paddlebox_tpu/parallel/plan.py``):
one declarative partition strategy a job, and the gradient helpers over
``Mesh.psum``.

A ``Plan`` holds the mesh, the batch (data) axis, the table axis and an
ordered tuple of ``Rule``s, each a regex and a ``PartitionSpec`` (here a
tuple of mesh axis names or None, one entry a leading dim). The rules are
resolved first match wins against a module's or a state's named tensors
(``match_partition_rules``), and validated: a rule that matches nothing, a
tensor no rule specs, a spec of higher rank than its tensor, an axis off
the mesh and a dimension the axis does not divide all raise ``PlanError``
when the plan is resolved, before a step runs. Scalars replicate without a
rule.

Names. The reference matches the ``/``-joined path of a flax pytree leaf
(``params/MLP_0/Dense_1/kernel``); the port matches the torch name of the
tensor, ``.``-joined (``mlp.layers.1.weight``), as ``named_parameters``
gives it: a flax module path becomes the torch attribute path, ``Dense_i``
the ``i``-th entry of its ``ModuleList`` and ``kernel`` / ``bias`` the
``weight`` / ``bias`` of its ``nn.Linear`` (``models/convert.py`` holds
each class's leaf order); a tensor kept as a flax leaf of its own keeps
its name (``blocks_w``, ``experts.kernels.0``). An optimizer state's
tensors are named ``<field>.<param name>`` (``mu.mlp.layers.1.weight``;
adam's ``count`` is a scalar), so the rules that cover the params cover
their state, as optax's paths embed the param path. A scope (the expert
plan's ``experts``) is matched as a whole path component, between dots.

The factories are the engines' layouts: ``data_parallel`` (sync DP, or
LocalSGD with ``local=True``: one replica a shard), ``zero`` (the flat
``[ndev, chunk]`` layout), ``pipeline`` (stacked stage tensors over
``pp``) and ``expert`` (stacked ``[E]`` experts over ``ep``). The port has
no compiler to hand specs to: an engine reads each tensor's spec and
places its slices on the shards' devices itself (``Plan.place``).

The gradient contract is the reference's:

1. the loss denominator is reduced over the shards BEFORE differentiation
   (``global_denominator``);
2. each shard differentiates a purely local loss;
3. the losses and the replicated dense params' gradients are summed over
   the shards AFTER it (``reduce_loss``, ``reduce_gradients``).

At ``ndev == 1`` every sum is the identity, so a one-shard mesh computes
the single-device step's numbers.
"""

from __future__ import annotations

import dataclasses
import re
from typing import (Any, Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import torch
from torch import nn

from paddlebox_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_EP, AXIS_PP,
                                               MESH_AXES, Mesh)

#: the axes a built-in plan factory ever shards
PLAN_SHARDED_AXES = (AXIS_DP, AXIS_EP, AXIS_PP)


class PlanError(ValueError):
    """A plan that does not fit its mesh or the tensors it is resolved
    against."""


class PartitionSpec(tuple):
    """One entry a leading dim: a mesh axis name (that dim split over the
    axis), a tuple of names, or None (whole). ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Rule:
    """Tensors whose name matches ``pattern`` (``re.search``) get
    ``spec``. First match wins."""

    pattern: str
    spec: PartitionSpec = PartitionSpec()

    def __post_init__(self):
        re.compile(self.pattern)   # a bad regex fails here, not at match


def _spec_axes(spec: PartitionSpec) -> Iterable[str]:
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, str):
            yield entry
        else:
            yield from entry


def named_tensors(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(name, tensor)`` of a module (its ``named_parameters``), a mapping
    or a list (names ``.``-joined, list entries by index); a leaf is
    anything with ``shape``, or a number."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
        return
    if isinstance(tree, Mapping):
        items: Iterable = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix.rstrip("."), tree
        return
    for key, sub in items:
        yield from named_tensors(sub, f"{prefix}{key}.")


def opt_state_tensors(model: nn.Module, state: Mapping
                      ) -> Dict[str, Any]:
    """A ``DenseOptimizer`` state's tensors by name: each per-parameter
    list's entries as ``<field>.<param name>``, the rest as they are."""
    names = [n for n, _ in model.named_parameters()]
    out: Dict[str, Any] = {}
    for field, v in state.items():
        if isinstance(v, (list, tuple)) and len(v) == len(names):
            for n, t in zip(names, v):
                out[f"{field}.{n}"] = t
        else:
            out.update(dict(named_tensors(v, f"{field}.")))
    return out


def _ndim(leaf) -> int:
    shape = getattr(leaf, "shape", ())
    return len(shape)


def match_partition_rules(rules: Sequence[Rule], tree: Any,
                          mesh: Optional[Mesh] = None
                          ) -> Dict[str, PartitionSpec]:
    """Resolve ordered ``rules`` against ``tree``'s named tensors
    (``named_tensors``) -> ``{name: spec}``. ``PlanError`` for a non-scalar
    tensor no rule matches, a rule that matches no tensor (unless none
    matched anything: a tree of scalars), a spec longer than its tensor's
    rank, and with ``mesh`` a sharded dim the mesh axis does not divide.
    Scalars replicate and consume no rule."""
    rules = tuple(rules)
    used = [False] * len(rules)
    specs: Dict[str, PartitionSpec] = {}
    for name, leaf in named_tensors(tree):
        ndim = _ndim(leaf)
        if ndim == 0:
            specs[name] = PartitionSpec()
            continue
        for i, rule in enumerate(rules):
            if re.search(rule.pattern, name):
                used[i] = True
                spec = rule.spec
                break
        else:
            raise PlanError(
                f"no partition rule matches '{name}' (rules: "
                f"{[r.pattern for r in rules]}): every non-scalar tensor "
                "must be specced, so nothing takes an accidental layout")
        if len(spec) > ndim:
            raise PlanError(f"rule '{rules[i].pattern}' gives rank-{ndim} "
                            f"'{name}' a {len(spec)}-entry spec {spec}")
        if mesh is not None:
            for d, entry in enumerate(spec):
                if entry is None:
                    continue
                size = 1
                for ax in ((entry,) if isinstance(entry, str) else entry):
                    size *= int(mesh.shape.get(ax, 0))
                if size and leaf.shape[d] % size:
                    raise PlanError(
                        f"'{name}' dim {d} (={leaf.shape[d]}) not divisible "
                        f"by mesh axes {spec[d]!r} (={size})")
        specs[name] = spec
    if any(used):
        for i, was_used in enumerate(used):
            if not was_used:
                raise PlanError(f"partition rule '{rules[i].pattern}' "
                                "matched no tensor: a dead rule is a "
                                "misspelled one")
    return specs


@dataclasses.dataclass(frozen=True)
class Plan:
    """The mesh, the ordered parameter rules, the batch (data) axis and the
    table axis of a job."""

    mesh: Mesh
    rules: Tuple[Rule, ...] = (Rule(".*"),)
    data_axis: str = AXIS_DP
    table_axis: str = AXIS_DP
    name: str = "plan"

    def __post_init__(self):
        axes = set(self.mesh.axis_names)
        for ax in (self.data_axis, self.table_axis):
            if ax not in axes:
                raise PlanError(
                    f"plan '{self.name}': axis '{ax}' not on the mesh "
                    f"{self.mesh.axis_names} (declared axes: {MESH_AXES})")
        for rule in self.rules:
            for ax in _spec_axes(rule.spec):
                if ax not in axes:
                    raise PlanError(
                        f"plan '{self.name}': rule '{rule.pattern}' shards "
                        f"over '{ax}', which is not on the mesh "
                        f"{self.mesh.axis_names}")

    @property
    def replicated(self) -> PartitionSpec:
        return PartitionSpec()

    @property
    def batch(self) -> PartitionSpec:
        """The leading [ndev] batch axis over the data axis."""
        return self.spec(self.data_axis)

    def spec(self, *entries) -> PartitionSpec:
        """A ``PartitionSpec`` whose every named entry is a mesh axis."""
        spec = PartitionSpec(*entries)
        for ax in _spec_axes(spec):
            if ax not in self.mesh.axis_names:
                raise PlanError(f"plan '{self.name}': spec axis '{ax}' not "
                                f"on the mesh {self.mesh.axis_names}")
        return spec

    def param_specs(self, params: Any) -> Dict[str, PartitionSpec]:
        """The rules resolved against a module's parameters (or any tree
        ``named_tensors`` takes), validated."""
        return match_partition_rules(self.rules, params, mesh=self.mesh)

    def opt_specs(self, model: nn.Module,
                  opt_state: Mapping) -> Dict[str, PartitionSpec]:
        """The same rules over a ``DenseOptimizer`` state of ``model``
        (``opt_state_tensors``' names); scalar counters replicate."""
        return match_partition_rules(
            self.rules, opt_state_tensors(model, opt_state), mesh=self.mesh)

    def place(self, t: torch.Tensor, spec: PartitionSpec
              ) -> List[torch.Tensor]:
        """``t`` laid out by ``spec`` on the mesh: for each shard, on its
        device, its slice of each dim ``spec`` splits over the mesh's axis
        (the whole dim elsewhere). Differentiable; a slice on ``t``'s own
        device is a view of it."""
        n = self.mesh.size
        out = []
        for s, dev in enumerate(self.mesh.devices):
            x = t
            for d, entry in enumerate(spec):
                if entry is None:
                    continue
                c = x.shape[d] // n
                x = x.narrow(d, s * c, c)
            out.append(x.to(dev))
        return out

    # -- factories: the engines' layouts -------------------------------------

    @classmethod
    def data_parallel(cls, mesh: Mesh, axis: str = AXIS_DP,
                      local: bool = False) -> "Plan":
        """Sync DP (dense params replicated), or LocalSGD (``local``: one
        replica a shard, its leading axis over ``axis``); the batch and
        the table sharded over ``axis``."""
        spec = PartitionSpec(axis) if local else PartitionSpec()
        return cls(mesh=mesh, rules=(Rule(".*", spec),), data_axis=axis,
                   table_axis=axis,
                   name=f"localsgd-{axis}" if local else f"dp-{axis}")

    @classmethod
    def zero(cls, mesh: Mesh, axis: str = AXIS_DP) -> "Plan":
        """The ZeRO flat layout: params and optimizer state as
        ``[ndev, chunk]`` over ``axis``."""
        return cls(mesh=mesh, rules=(Rule(".*", PartitionSpec(axis)),),
                   data_axis=axis, table_axis=axis, name=f"zero-{axis}")

    @classmethod
    def pipeline(cls, mesh: Mesh, axis: str = AXIS_PP,
                 stage_pattern: str = ".*") -> "Plan":
        """GPipe: tensors matching ``stage_pattern`` are stacked per stage,
        their leading dim over ``axis``; the rest (the input projection,
        the head) replicate."""
        rules = (Rule(stage_pattern, PartitionSpec(axis)),)
        if stage_pattern != ".*":
            rules += (Rule(".*", PartitionSpec()),)
        return cls(mesh=mesh, rules=rules, data_axis=axis, table_axis=axis,
                   name=f"pipeline-{axis}")

    @classmethod
    def expert(cls, mesh: Mesh, axis: str = AXIS_EP,
               expert_scope: str = "experts") -> "Plan":
        """Expert parallelism: tensors under ``expert_scope`` (a whole name
        component: "experts" does not claim "my_experts_aux") get their
        stacked leading [E] dim over ``axis``; the rest replicate."""
        return cls(mesh=mesh,
                   rules=(Rule(rf"(^|\.){re.escape(expert_scope)}(\.|$)",
                               PartitionSpec(axis)),
                          Rule(".*", PartitionSpec())),
                   data_axis=axis, table_axis=axis, name=f"expert-{axis}")


# -- the gradient contract ----------------------------------------------------

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
    on shard 0's device. Only for replicated params (sync DP): LocalSGD
    keeps each replica's local gradient, ZeRO scatters its own."""
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
