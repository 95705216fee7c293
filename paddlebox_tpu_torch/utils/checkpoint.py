"""Dense-parameter leaf files (counterpart of
``paddlebox_tpu/utils/checkpoint.py``).

Dense params are stored as one ``.npz`` of ``leaf_%05d`` arrays in the
reference's pytree leaf order, committed atomically
(``ckpt/atomic.py::write_npz``). Loading validates the key set and every
leaf's shape and dtype against a template before any array is returned.
The port keeps no pytree: the caller passes the leaf template (arrays, or
anything with ``shape`` and ``dtype``).

A dense state ``(model, opt_state)``, the pair a checkpoint's
``dense.npz`` holds, has the leaves of the reference's ``(params,
opt_state)``: the model's flax leaves (``models/convert.py``), then the
optimizer's in optax's order: adam's, adamw's and lamb's ``count``,
``mu``, ``nu``, adagrad's ``sum_of_squares``, lars's ``trace``, none for
sgd; under gradient merging (``optax.MultiSteps``) ``mini_step``,
``gradient_step``, the inner optimizer's leaves, then ``acc_grads``. Each
per-parameter list is in the flax leaf order, kernels transposed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.ckpt.atomic import write_npz
from paddlebox_tpu_torch.models.convert import flax_order

__all__ = ["leaf_arrays", "write_npz", "save_leaves", "load_leaves",
           "dense_arrays", "load_dense"]

# the optimizer state's fields in optax's leaf order ("inner" is the
# state of the optimizer that gradient merging wraps)
_OPT_FIELDS = ("mini_step", "gradient_step", "inner", "count", "mu", "nu",
               "sum_of_squares", "trace", "acc_grads")


def leaf_arrays(leaves: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    return {f"leaf_{i:05d}": np.asarray(x) for i, x in enumerate(leaves)}


def save_leaves(path: str, leaves: Sequence[np.ndarray]) -> None:
    write_npz(path, leaf_arrays(leaves))


def load_leaves(path: str, template: Sequence) -> List[np.ndarray]:
    with np.load(path) as data:
        expect = [f"leaf_{i:05d}" for i in range(len(template))]
        got = set(data.files)
        missing = [k for k in expect if k not in got]
        extra = sorted(got - set(expect))
        if missing or extra:
            raise ValueError(
                f"checkpoint {path} does not match template: "
                f"missing keys {missing or 'none'}, unexpected keys "
                f"{extra or 'none'} (template has {len(template)} leaves)")
        loaded = [data[k] for k in expect]
    for i, (a, b) in enumerate(zip(loaded, template)):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"leaf {i} shape {a.shape} != template "
                             f"{tuple(b.shape)}")
        if a.dtype != np.dtype(b.dtype):
            raise ValueError(f"leaf {i} dtype {a.dtype} != template "
                             f"{b.dtype}")
    return loaded


def _dense_tensors(dense_state: Any) -> List[Tuple[torch.Tensor, bool]]:
    """Every tensor of ``(model, opt_state)`` in the reference's leaf
    order, each with whether its leaf is the transpose (a kernel)."""
    try:
        model, opt_state = dense_state
    except (TypeError, ValueError):
        raise TypeError("a dense state is the pair (model, opt_state)") \
            from None
    order = flax_order(model)
    params = [p.detach() for p in model.parameters()]
    return [(_pick(params, j), kernel) for j, kernel in order] + \
        _opt_tensors(opt_state, order)


def _pick(tensors, j):
    """Tensor ``j``, or a stacked leaf's stage tensors (a list) where ``j``
    is a tuple of indices."""
    return [tensors[i] for i in j] if isinstance(j, tuple) else tensors[j]


def _opt_tensors(opt_state: Dict[str, Any], order
                 ) -> List[Tuple[torch.Tensor, bool]]:
    unknown = set(opt_state) - set(_OPT_FIELDS)
    if unknown:
        raise ValueError(f"optimizer state fields {sorted(unknown)} have no "
                         "leaf order")
    out: List[Tuple[torch.Tensor, bool]] = []
    for field in _OPT_FIELDS:
        if field not in opt_state:
            continue
        v = opt_state[field]
        if isinstance(v, torch.Tensor):
            out.append((v, False))
        elif isinstance(v, dict):
            out += _opt_tensors(v, order)
        else:
            out += [(_pick(v, j), kernel) for j, kernel in order]
    return out


def dense_arrays(dense_state: Any) -> Dict[str, np.ndarray]:
    """``(model, opt_state)`` as the ``leaf_%05d`` arrays of the
    reference's ``dense.npz``: host copies, which later steps do not
    change."""
    leaves = []
    for t, kernel in _dense_tensors(dense_state):
        x = (np.stack([q.to("cpu", copy=True).numpy() for q in t])
             if isinstance(t, list) else t.to("cpu", copy=True).numpy())
        leaves.append(np.ascontiguousarray(x.T) if kernel else x)
    return leaf_arrays(leaves)


@torch.no_grad()
def load_dense(path: str, dense_state: Any) -> Any:
    """Load a ``dense.npz`` into ``(model, opt_state)`` in place (every
    leaf checked against it first) and return it."""
    tensors = _dense_tensors(dense_state)
    template = list(dense_arrays(dense_state).values())
    for (t, kernel), a in zip(tensors, load_leaves(path, template)):
        a = a.T.copy() if kernel else a
        for q, x in (zip(t, a) if isinstance(t, list) else [(t, a)]):
            q.copy_(torch.from_numpy(np.array(x)))
    return dense_state
