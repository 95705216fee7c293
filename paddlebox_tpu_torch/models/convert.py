"""Carry model weights between the flax leaf list and the torch module, for
every model class of the port.

The reference stores dense params as the flat leaf list of its flax pytree
(``dense.npz``, keys ``leaf_%05d``), in ``jax.tree_util`` order: dict keys
sorted as strings, so ``Dense_10`` comes before ``Dense_2`` and a layer's
``bias`` before its ``kernel``. The leaves of each class:

- ``DeepFM``: ``MLP_0/Dense_i/{bias, kernel}``, then the scalar ``bias``;
- ``WideDeep``: ``deep/Dense_i/{bias, kernel}``, then ``wide/{bias,
  kernel}``;
- ``FeedDNN``: ``MLP_0/Dense_i/{bias, kernel}``;
- ``MMoE``: ``experts/Dense_i/{bias, kernel}`` (the vmapped experts: bias
  [E, out], kernel [E, in, out]), then ``gate_t/{bias, kernel}``, then
  ``tower_t/Dense_i/{bias, kernel}``.

flax kernels are ``[in, out]``; ``nn.Linear.weight`` is ``[out, in]``, so a
``Linear``'s kernel leaf is its weight transposed. ``StackedMLP`` keeps the
flax layout, so its leaves are its tensors as they are.

- ``PipelinedTower`` (``parallel/pipeline.py``): ``blocks_b``,
  ``blocks_w`` (stacked ``[n_stages, ...]``, kept a tensor a stage:
  ``blocks_b.<d>``, ``blocks_w.<d>``), ``head_b``, ``head_w``, ``proj_b``,
  ``proj_w`` (kernels as flax keeps them).

A stacked leaf kept as one tensor a stage is a slot of a tuple of
tensors: the leaf is their stack. ``flax_order`` gives that order for a
module's own parameters (a stacked leaf's indices as a tuple), so that
tensors kept per parameter (an optimizer's ``mu``, ``nu``) follow it too
(``utils/checkpoint.py`` ``dense_arrays``). ``build_model`` builds a
model of a class named in a serving bundle (``model_from_flax_leaves``
with the leaves' weights); a class registered with
``register_model_class`` takes ``in_dim`` then its ``CONFIG_FIELDS`` and
gives its leaves in order by a ``flax_slots()`` method (``(tensor,
transposed)`` pairs).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.models.base import MLP, StackedMLP
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.dnn import FeedDNN
from paddlebox_tpu_torch.models.mmoe import MMoE
from paddlebox_tpu_torch.models.wide_deep import WideDeep
from paddlebox_tpu_torch.parallel.pipeline import PipelinedTower

# the model classes a bundle may name, by class name
MODEL_CLASSES: Dict[str, type] = {c.__name__: c for c in
                                  (DeepFM, WideDeep, FeedDNN, MMoE,
                                   PipelinedTower)}

# a leaf's tensor (or its stages' tensors) and whether flax transposes it
Slot = Tuple[Union[torch.Tensor, Tuple[torch.Tensor, ...]], bool]


def register_model_class(cls: type) -> None:
    MODEL_CLASSES[cls.__name__] = cls


def _layer_order(n_layers: int) -> List[int]:
    # Dense_10 sorts before Dense_2 in the pytree's key order
    return sorted(range(n_layers), key=lambda i: f"Dense_{i}")


def _named_order(prefix: str, n: int) -> List[int]:
    # gate_10 sorts before gate_2 too
    return sorted(range(n), key=lambda t: f"{prefix}_{t}")


def _linear_slots(layer: nn.Linear) -> List[Slot]:
    return [(layer.bias, False), (layer.weight, True)]


def _mlp_slots(mlp: MLP) -> List[Slot]:
    out: List[Slot] = []
    for i in _layer_order(len(mlp.layers)):
        out += _linear_slots(mlp.layers[i])
    return out


def _stacked_slots(stack: StackedMLP) -> List[Slot]:
    out: List[Slot] = []
    for i in _layer_order(len(stack.kernels)):
        out += [(stack.biases[i], False), (stack.kernels[i], False)]
    return out


def _slots(model: nn.Module) -> List[Slot]:
    """Each flax leaf's tensor of ``model``, in the leaf order, with
    whether flax keeps it transposed."""
    if isinstance(model, DeepFM):
        return _mlp_slots(model.mlp) + [(model.bias, False)]
    if isinstance(model, WideDeep):
        return _mlp_slots(model.deep) + _linear_slots(model.wide)
    if isinstance(model, FeedDNN):
        return _mlp_slots(model.mlp)
    if isinstance(model, MMoE):
        out = _stacked_slots(model.experts)
        for t in _named_order("gate", model.num_tasks):
            out += _linear_slots(model.gates[t])
        for t in _named_order("tower", model.num_tasks):
            out += _mlp_slots(model.towers[t])
        return out
    if hasattr(model, "flax_slots"):
        return list(model.flax_slots())
    raise TypeError(f"no flax leaf order for {type(model).__name__} "
                    f"(known: {', '.join(MODEL_CLASSES)}, or a class with "
                    "flax_slots())")


def flax_order(model: nn.Module) -> List[Tuple[Union[int, Tuple[int, ...]],
                                                 bool]]:
    """For each flax leaf of ``model``, in the leaf order: the index of its
    tensor in ``model.parameters()`` (a stacked leaf's: a tuple, a stage
    each) and whether flax keeps it transposed (a ``Linear``'s kernel)."""
    index = {id(p): j for j, p in enumerate(model.parameters())}
    return [(tuple(index[id(q)] for q in p) if isinstance(p, tuple)
             else index[id(p)], kernel) for p, kernel in _slots(model)]


def _host(t) -> np.ndarray:
    if isinstance(t, tuple):
        return np.stack([_host(q) for q in t])
    return t.detach().cpu().numpy()


def flax_leaves_from_model(model: nn.Module) -> List[np.ndarray]:
    """The flax leaf list (host float32 arrays) of ``model``'s weights."""
    out = []
    for t, kernel in _slots(model):
        x = _host(t)
        out.append((x.T if kernel else x).copy())
    return out


def load_flax_leaves(model: nn.Module, leaves: Sequence[np.ndarray]):
    """Copy the flax leaf list into ``model``'s tensors (each leaf checked
    against its tensor's shape first); returns ``model``."""
    slots = _slots(model)
    name = type(model).__name__
    if len(leaves) != len(slots):
        raise ValueError(f"{name} takes {len(slots)} leaves, got "
                         f"{len(leaves)}")
    arrays = []
    for i, ((t, kernel), leaf) in enumerate(zip(slots, leaves)):
        leaf = np.asarray(leaf)
        shape = ((len(t),) + tuple(t[0].shape) if isinstance(t, tuple)
                 else tuple(t.shape))
        want = shape[::-1] if kernel else shape
        if leaf.shape != want:
            raise ValueError(f"{name}: leaf {i} is {leaf.shape}, expected "
                             f"{want}")
        arrays.append(np.array(leaf.T if kernel else leaf, dtype=np.float32))
    with torch.no_grad():
        for (t, _), a in zip(slots, arrays):
            for q, x in (zip(t, a) if isinstance(t, tuple) else [(t, a)]):
                q.copy_(torch.from_numpy(np.array(x)))
    return model


def build_model(cls_name: str, kwargs: Dict, in_dim: int) -> nn.Module:
    """A fresh CPU model of the class named ``cls_name`` (a bundle's
    ``model.json`` ``class``), built from ``in_dim`` and the reference's
    ``kwargs`` (lists taken as tuples)."""
    if cls_name not in MODEL_CLASSES:
        raise ValueError(f"unknown model class {cls_name!r} (known: "
                         f"{', '.join(MODEL_CLASSES)}; see "
                         "register_model_class)")
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in kwargs.items()}
    return MODEL_CLASSES[cls_name](in_dim, **kw)


def model_from_flax_leaves(cls_name: str, kwargs: Dict,
                           leaves: Sequence[np.ndarray],
                           in_dim: int) -> nn.Module:
    """``build_model``'s model holding the weights of the flax leaf
    list."""
    return load_flax_leaves(build_model(cls_name, kwargs, in_dim), leaves)


def model_config(model: nn.Module) -> Dict:
    """``{"class", "kwargs"}`` of ``model``, as the reference's bundle
    records it (its fields by name, tuples as lists)."""
    kwargs = {}
    for f in model.CONFIG_FIELDS:
        v = getattr(model, f)
        kwargs[f] = list(v) if isinstance(v, tuple) else v
    return {"class": type(model).__name__, "kwargs": kwargs}


def _in_dim(leaves: Sequence[np.ndarray], axis: int = 0) -> int:
    # leaf 1 is the first layer's kernel: Dense_0 sorts first
    if len(leaves) < 2:
        raise ValueError(f"got {len(leaves)} leaves: no first-layer kernel")
    return int(np.shape(leaves[1])[axis])


def deepfm_from_flax_leaves(leaves: Sequence[np.ndarray],
                            hidden: Sequence[int],
                            cvm_offset: int = 3) -> DeepFM:
    """A CPU ``DeepFM`` holding the weights of the flax leaf list."""
    return load_flax_leaves(DeepFM(_in_dim(leaves), hidden, cvm_offset),
                            leaves)


def widedeep_from_flax_leaves(leaves: Sequence[np.ndarray],
                              hidden: Sequence[int]) -> WideDeep:
    """A CPU ``WideDeep`` holding the weights of the flax leaf list."""
    return load_flax_leaves(WideDeep(_in_dim(leaves), hidden), leaves)


def feeddnn_from_flax_leaves(
        leaves: Sequence[np.ndarray],
        hidden: Sequence[int] = (511, 255, 255, 127, 127, 127, 127)
) -> FeedDNN:
    """A CPU ``FeedDNN`` holding the weights of the flax leaf list."""
    return load_flax_leaves(FeedDNN(_in_dim(leaves), hidden), leaves)


def mmoe_from_flax_leaves(leaves: Sequence[np.ndarray], num_tasks: int = 2,
                          num_experts: int = 4,
                          expert_hidden: Sequence[int] = (256, 128),
                          expert_out: int = 64,
                          tower_hidden: Sequence[int] = (64, 32)) -> MMoE:
    """A CPU ``MMoE`` holding the weights of the flax leaf list (the
    experts' first kernel [E, in, out] gives ``in_dim``)."""
    return load_flax_leaves(
        MMoE(_in_dim(leaves, axis=1), num_tasks, num_experts,
             expert_hidden, expert_out, tower_hidden), leaves)


flax_leaves_from_deepfm = flax_leaves_from_model
flax_leaves_from_widedeep = flax_leaves_from_model
flax_leaves_from_feeddnn = flax_leaves_from_model
flax_leaves_from_mmoe = flax_leaves_from_model


def pipelined_tower_from_flax_leaves(leaves: Sequence[np.ndarray],
                                     microbatches: int = 4, mesh=None
                                     ) -> PipelinedTower:
    """A ``PipelinedTower`` holding the weights of the reference's leaves
    (``blocks_b``, ``blocks_w`` [n, k, H, H], ``head_b``, ``head_w``,
    ``proj_b``, ``proj_w`` [in, H]), its stages over ``mesh`` (None: on
    the CPU)."""
    n, k, H, _ = np.shape(leaves[1])
    return load_flax_leaves(
        PipelinedTower(int(np.shape(leaves[5])[0]), hidden=int(H),
                       blocks_per_stage=int(k), microbatches=microbatches,
                       n_stages=None if mesh is not None else int(n),
                       mesh=mesh), leaves)
