"""Pipeline parallelism: the GPipe schedule over a ``pp`` mesh axis
(counterpart of ``paddlebox_tpu/parallel/pipeline.py``).

The model is cut into ``n`` stages, stage ``d``'s params on shard ``d``'s
device, and ``m`` microbatches stream through: stage ``d`` computes
microbatch ``j`` at tick ``d + j`` and hands its output to stage ``d + 1``
through ``Mesh.ppermute``; the schedule runs ``n + m - 1`` ticks, a stage
idle in the bubble. Autograd through the schedule is the backward
pipeline, and the microbatches' gradients accumulate in it. One
controller runs every stage; a stage computes only the microbatches it
holds (the reference's uniform program computes every stage every tick
and masks what is not its own: the same numbers where they count).

- ``pipeline_apply`` / ``make_pipeline``: the schedule for homogeneous
  stage functions.
- ``PipelinedTower``: a CTR model whose dense tower is ``n x
  blocks_per_stage`` residual blocks ``h + tanh(h @ w + b)``, the input
  projection on stage 0 and the logit head on the last stage. Its stacked
  ``blocks_w [n, k, H, H]`` and ``blocks_b [n, k, H]`` (the reference's
  leaves) are kept stage by stage, ``blocks_w.<d>`` on stage ``d``'s
  device, as ``Plan.pipeline(stage_pattern="blocks_")`` lays them out. It
  drops into ``FusedTrainStep``, ``TrainStep`` and ``CTRTrainer`` like any
  model. ``sequential_reference`` is its forward with the stages applied
  in order, on one device.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import CTRModel
from paddlebox_tpu_torch.parallel.mesh import AXIS_PP, Mesh
from paddlebox_tpu_torch.parallel.plan import Plan, PlanError


def pipeline_apply(stage_fn: Callable, stage_params: Sequence[Any],
                   xs: torch.Tensor, mesh: Mesh,
                   inject_fn: Optional[Callable] = None,
                   extract_fn: Optional[Callable] = None) -> torch.Tensor:
    """The GPipe schedule: ``stage_fn(params, x) -> y`` is one stage (the
    activation's shape the same at every stage); ``stage_params[d]`` stage
    ``d``'s params, on its device; ``xs`` [m, ...] microbatches.
    ``inject_fn(mb)`` maps a microbatch to stage 0's input (an input
    projection) and ``extract_fn(y)`` the last stage's output to the
    recorded one (a logit head); both default to the identity. Returns
    [m, ...] on the last stage's device."""
    n, m = mesh.size, xs.shape[0]
    devs = mesh.devices
    fwd = [(i, (i + 1) % n) for i in range(n)]
    inject = inject_fn if inject_fn is not None else (lambda mb: mb)
    extract = extract_fn if extract_fn is not None else (lambda y: y)
    state: List[Optional[torch.Tensor]] = [None] * n
    outs: List[torch.Tensor] = []
    for t in range(n + m - 1):
        out: List[Optional[torch.Tensor]] = [None] * n
        for d in range(n):
            j = t - d
            if 0 <= j < m:
                inp = inject(xs[j].to(devs[0])) if d == 0 else state[d]
                out[d] = stage_fn(stage_params[d], inp)
        if t >= n - 1:
            outs.append(extract(out[n - 1]))
        state = mesh.ppermute(out, fwd)
    return torch.stack(outs)


def make_pipeline(stage_fn: Callable, mesh: Mesh, axis: str = AXIS_PP,
                  plan: Optional[Plan] = None) -> Callable:
    """``run(stacked_params, xs) -> ys``: ``stacked_params`` a tensor (or a
    list or dict of them) leading with [n_stages], laid out over ``axis``
    by the pipeline plan (stage ``d``'s slice on shard ``d``'s device,
    differentiably); ``xs`` / ``ys`` [m, ...] microbatches on the caller's
    device."""
    plan = plan if plan is not None else Plan.pipeline(mesh, axis=axis)
    mesh = plan.mesh
    n = mesh.size

    def run(stacked_params, xs: torch.Tensor) -> torch.Tensor:
        specs = plan.param_specs(stacked_params)
        leaves = dict(_leaves(stacked_params))
        for name, t in leaves.items():
            if t.shape[0] != n:
                raise PlanError(f"'{name}' leads with {t.shape[0]} stages "
                                f"over {n} shards")
        placed = {name: plan.place(t, specs[name])
                  for name, t in leaves.items()}
        stage_params = [_rebuild(stacked_params, placed, d)
                        for d in range(n)]
        return pipeline_apply(stage_fn, stage_params, xs, mesh).to(
            xs.device)

    return run


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        yield prefix.rstrip("."), tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        for k, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{k}.")


def _rebuild(tree, placed, d: int, prefix: str = ""):
    """Stage ``d``'s params: ``tree``'s structure over its leaves' slice
    ``d`` (the leading stage axis dropped)."""
    if isinstance(tree, torch.Tensor):
        return placed[prefix.rstrip(".")][d][0]
    if isinstance(tree, dict):
        return {k: _rebuild(v, placed, d, f"{prefix}{k}.")
                for k, v in tree.items()}
    return type(tree)(_rebuild(v, placed, d, f"{prefix}{k}.")
                      for k, v in enumerate(tree))


def _blocks(params, h: torch.Tensor) -> torch.Tensor:
    """A stage: its ``k`` residual blocks ``h + tanh(h @ w + b)``."""
    w, b = params
    for i in range(w.shape[0]):
        h = h + torch.tanh(h @ w[i] + b[i])
    return h


def _lecun_normal(shape, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at 2 sigma, scaled so
    its variance is 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)
    return t


class PipelinedTower(CTRModel):
    """A deep residual-MLP CTR tower, pipelined over ``mesh`` (the
    reference's ``PipelinedTower``): ``[B, S, D]`` pooled rows (and dense
    features) -> ``[B]`` logits. ``n_stages`` stages of
    ``blocks_per_stage`` blocks of width ``hidden``; ``microbatches``
    must divide the batch. Without a mesh (a bundle's model) the stages
    live where ``.to`` moves the module; with one, stage ``d``'s blocks
    stay on shard ``d``'s device, the projection on stage 0's and the
    head on the last stage's, whatever ``.to`` asks."""

    CONFIG_FIELDS = ("hidden", "blocks_per_stage", "microbatches",
                     "n_stages")

    def __init__(self, in_dim: int, hidden: int = 64,
                 blocks_per_stage: int = 2, microbatches: int = 4,
                 n_stages: Optional[int] = None, mesh: Optional[Mesh] = None,
                 axis: str = AXIS_PP):
        super().__init__()
        n = mesh.size if mesh is not None else int(n_stages or 1)
        if n_stages is not None and int(n_stages) != n:
            raise ValueError(f"n_stages {n_stages} on a mesh of {n}")
        self.in_dim, self.hidden = in_dim, hidden
        self.blocks_per_stage, self.microbatches = blocks_per_stage, \
            microbatches
        self.n_stages, self.axis = n, axis
        self._devices = None if mesh is None else list(mesh.devices)
        H, k = hidden, blocks_per_stage
        # the reference's init: lecun_normal kernels, zero biases; the
        # stacked blocks drawn as one (n*k*H, H) kernel, scaled by 0.5 so
        # the n*k-deep residual chain stays in tanh's linear range
        init = {"blocks_b": torch.zeros(n, k, H),
                "blocks_w": _lecun_normal((n * k * H, H), n * k * H)
                .reshape(n, k, H, H) * 0.5,
                "head_b": torch.zeros(1),
                "head_w": _lecun_normal((H, 1), H),
                "proj_b": torch.zeros(H),
                "proj_w": _lecun_normal((in_dim, H), in_dim)}
        if mesh is not None:
            # the plan lays the stacked blocks out stage by stage
            plan = Plan.pipeline(mesh, axis=axis, stage_pattern="blocks_")
            specs = plan.param_specs(init)
            stages = {name: [x[0].clone() for x in
                             plan.place(init[name], specs[name])]
                      for name in ("blocks_b", "blocks_w")}
            first, last = self._devices[0], self._devices[-1]
        else:
            stages = {name: list(init[name].unbind(0))
                      for name in ("blocks_b", "blocks_w")}
            first = last = None
        self.proj_w = nn.Parameter(init["proj_w"].to(first))
        self.proj_b = nn.Parameter(init["proj_b"].to(first))
        self.blocks_w = nn.ParameterList(stages["blocks_w"])
        self.blocks_b = nn.ParameterList(stages["blocks_b"])
        self.head_w = nn.Parameter(init["head_w"].to(last))
        self.head_b = nn.Parameter(init["head_b"].to(last))

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        if self._devices is not None:
            self._place()
        return self

    def _place(self) -> None:
        """Each tensor back on its stage's device (after a ``.to``)."""
        last = self._devices[-1]
        pins = [(self.proj_w, self._devices[0]),
                (self.proj_b, self._devices[0]),
                (self.head_w, last), (self.head_b, last)]
        for d, dev in enumerate(self._devices):
            pins += [(self.blocks_w[d], dev), (self.blocks_b[d], dev)]
        for p, dev in pins:
            if p.device != dev:
                p.data = p.data.to(dev)

    def stage_mesh(self) -> Mesh:
        """The mesh of the stages' current devices."""
        return Mesh([w.device for w in self.blocks_w], (self.axis,))

    def forward(self, sparse: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.flatten_inputs(sparse, dense).float()
        B, D = x.shape
        m = self.microbatches
        if B % m:
            raise ValueError(f"batch {B} % microbatches {m} != 0")
        xs = x.reshape(m, B // m, D)
        logits = pipeline_apply(
            _blocks, list(zip(self.blocks_w, self.blocks_b)), xs,
            self.stage_mesh(),
            inject_fn=lambda mb: mb @ self.proj_w + self.proj_b,
            extract_fn=lambda y: (y @ self.head_w + self.head_b)[:, 0])
        return logits.reshape(B).to(x.device)

    def flax_slots(self):
        """The reference's leaves in its order (``blocks_b``, ``blocks_w``,
        ``head_b``, ``head_w``, ``proj_b``, ``proj_w``); the stacked ones as
        their stages' tensors (``models/convert.py``)."""
        return [(tuple(self.blocks_b), False), (tuple(self.blocks_w), False),
                (self.head_b, False), (self.head_w, False),
                (self.proj_b, False), (self.proj_w, False)]


def sequential_reference(model: PipelinedTower, sparse: torch.Tensor,
                         dense: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """A ``PipelinedTower``'s forward with its stages applied in order on
    the input's device, the whole batch at once: the parity oracle."""
    dev = sparse.device
    x = CTRModel.flatten_inputs(sparse, dense).float()
    h = x @ model.proj_w.to(dev) + model.proj_b.to(dev)
    for w, b in zip(model.blocks_w, model.blocks_b):
        h = _blocks((w.to(dev), b.to(dev)), h)
    return (h @ model.head_w.to(dev) + model.head_b.to(dev))[:, 0]
