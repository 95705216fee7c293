"""Carry DeepFM weights between the flax leaf list and the torch module.

The reference stores dense params as the flat leaf list of its flax pytree
(``dense.npz``, keys ``leaf_%05d``), in ``jax.tree_util`` order: dict keys
sorted as strings. For DeepFM that is ``MLP_0/Dense_i/{bias, kernel}`` for
each layer ``i`` in the string order of ``Dense_<i>``, then the scalar
``bias``. flax kernels are ``[in, out]``; ``nn.Linear.weight`` is
``[out, in]``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch.models.deepfm import DeepFM


def _layer_order(n_layers: int) -> List[int]:
    # Dense_10 sorts before Dense_2 in the pytree's key order
    return sorted(range(n_layers), key=lambda i: f"Dense_{i}")


def deepfm_from_flax_leaves(leaves: Sequence[np.ndarray],
                            hidden: Sequence[int],
                            cvm_offset: int = 3) -> DeepFM:
    """A CPU ``DeepFM`` holding the weights of the flax leaf list."""
    n_layers = len(hidden) + 1
    if len(leaves) != 2 * n_layers + 1:
        raise ValueError(f"DeepFM with hidden={tuple(hidden)} has "
                         f"{2 * n_layers + 1} leaves, got {len(leaves)}")
    order = _layer_order(n_layers)
    kernels = {}
    biases = {}
    for j, i in enumerate(order):
        biases[i] = np.array(leaves[2 * j], dtype=np.float32)
        kernels[i] = np.array(leaves[2 * j + 1], dtype=np.float32)
    model = DeepFM(kernels[0].shape[0], hidden, cvm_offset)
    with torch.no_grad():
        for i, layer in enumerate(model.mlp.layers):
            want = (layer.out_features, layer.in_features)
            if kernels[i].shape[::-1] != want or \
                    biases[i].shape != (layer.out_features,):
                raise ValueError(
                    f"Dense_{i}: kernel {kernels[i].shape} / bias "
                    f"{biases[i].shape} do not fit Linear{want[::-1]}")
            layer.weight.copy_(torch.from_numpy(kernels[i].T.copy()))
            layer.bias.copy_(torch.from_numpy(biases[i]))
        model.bias.copy_(torch.tensor(np.asarray(leaves[-1])))
    return model


def flax_leaves_from_deepfm(model: DeepFM) -> List[np.ndarray]:
    """The flax leaf list (host float32 arrays) of ``model``'s weights."""
    layers = model.mlp.layers
    out: List[np.ndarray] = []
    for i in _layer_order(len(layers)):
        out.append(layers[i].bias.detach().cpu().numpy().copy())
        out.append(layers[i].weight.detach().cpu().numpy().T.copy())
    out.append(model.bias.detach().cpu().numpy().copy())
    return out
