"""Carry DeepFM and Wide&Deep weights between the flax leaf list and the
torch module.

The reference stores dense params as the flat leaf list of its flax pytree
(``dense.npz``, keys ``leaf_%05d``), in ``jax.tree_util`` order: dict keys
sorted as strings. For DeepFM that is ``MLP_0/Dense_i/{bias, kernel}`` for
each layer ``i`` in the string order of ``Dense_<i>``, then the scalar
``bias``; for Wide&Deep ``deep/Dense_i/{bias, kernel}``, then
``wide/{bias, kernel}``. flax kernels are ``[in, out]``;
``nn.Linear.weight`` is ``[out, in]``.

``flax_order`` gives that order for a module's own parameters, so that
tensors kept per parameter (an optimizer's ``mu``, ``nu``) follow it too
(``utils/checkpoint.py`` ``dense_arrays``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from torch import nn

from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.wide_deep import WideDeep


def _layer_order(n_layers: int) -> List[int]:
    # Dense_10 sorts before Dense_2 in the pytree's key order
    return sorted(range(n_layers), key=lambda i: f"Dense_{i}")


def _set_linear(layer: nn.Linear, kernel: np.ndarray, bias: np.ndarray,
                name: str) -> None:
    want = (layer.out_features, layer.in_features)
    if kernel.shape[::-1] != want or bias.shape != (layer.out_features,):
        raise ValueError(f"{name}: kernel {kernel.shape} / bias {bias.shape} "
                         f"do not fit Linear{want[::-1]}")
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.array(kernel.T,
                                                     dtype=np.float32)))
        layer.bias.copy_(torch.from_numpy(np.array(bias, dtype=np.float32)))


def _linear_leaves(layer: nn.Linear) -> List[np.ndarray]:
    return [layer.bias.detach().cpu().numpy().copy(),
            layer.weight.detach().cpu().numpy().T.copy()]


def flax_order(model: nn.Module) -> List[Tuple[int, bool]]:
    """For each flax leaf of ``model`` (a ``DeepFM`` or ``WideDeep``), in
    the leaf order: the index of its tensor in ``model.parameters()`` and
    whether flax keeps it transposed (a kernel)."""
    if isinstance(model, DeepFM):
        layers, tail = model.mlp.layers, [(model.bias, False)]
    elif isinstance(model, WideDeep):
        layers = model.deep.layers
        tail = [(model.wide.bias, False), (model.wide.weight, True)]
    else:
        raise TypeError(f"no flax leaf order for {type(model).__name__} "
                        "(DeepFM and WideDeep have one)")
    slots = []
    for i in _layer_order(len(layers)):
        slots += [(layers[i].bias, False), (layers[i].weight, True)]
    index = {id(p): j for j, p in enumerate(model.parameters())}
    return [(index[id(p)], kernel) for p, kernel in slots + tail]


def deepfm_from_flax_leaves(leaves: Sequence[np.ndarray],
                            hidden: Sequence[int],
                            cvm_offset: int = 3) -> DeepFM:
    """A CPU ``DeepFM`` holding the weights of the flax leaf list."""
    n_layers = len(hidden) + 1
    if len(leaves) != 2 * n_layers + 1:
        raise ValueError(f"DeepFM with hidden={tuple(hidden)} has "
                         f"{2 * n_layers + 1} leaves, got {len(leaves)}")
    layers = {i: (np.asarray(leaves[2 * j + 1]), np.asarray(leaves[2 * j]))
              for j, i in enumerate(_layer_order(n_layers))}
    model = DeepFM(layers[0][0].shape[0], hidden, cvm_offset)
    for i, layer in enumerate(model.mlp.layers):
        _set_linear(layer, *layers[i], f"Dense_{i}")
    with torch.no_grad():
        model.bias.copy_(torch.tensor(np.asarray(leaves[-1])))
    return model


def flax_leaves_from_deepfm(model: DeepFM) -> List[np.ndarray]:
    """The flax leaf list (host float32 arrays) of ``model``'s weights."""
    layers = model.mlp.layers
    out: List[np.ndarray] = []
    for i in _layer_order(len(layers)):
        out += _linear_leaves(layers[i])
    out.append(model.bias.detach().cpu().numpy().copy())
    return out


def widedeep_from_flax_leaves(leaves: Sequence[np.ndarray],
                              hidden: Sequence[int]) -> WideDeep:
    """A CPU ``WideDeep`` holding the weights of the flax leaf list."""
    n_layers = len(hidden) + 1
    if len(leaves) != 2 * n_layers + 2:
        raise ValueError(f"WideDeep with hidden={tuple(hidden)} has "
                         f"{2 * n_layers + 2} leaves, got {len(leaves)}")
    deep = {i: (np.asarray(leaves[2 * j + 1]), np.asarray(leaves[2 * j]))
            for j, i in enumerate(_layer_order(n_layers))}
    wide_bias, wide_kernel = (np.asarray(x) for x in leaves[-2:])
    model = WideDeep(wide_kernel.shape[0], hidden)
    for i, layer in enumerate(model.deep.layers):
        _set_linear(layer, *deep[i], f"deep/Dense_{i}")
    _set_linear(model.wide, wide_kernel, wide_bias, "wide")
    return model


def flax_leaves_from_widedeep(model: WideDeep) -> List[np.ndarray]:
    """The flax leaf list (host float32 arrays) of ``model``'s weights."""
    layers = model.deep.layers
    out: List[np.ndarray] = []
    for i in _layer_order(len(layers)):
        out += _linear_leaves(layers[i])
    return out + _linear_leaves(model.wide)
