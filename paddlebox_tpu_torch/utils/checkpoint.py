"""Dense-parameter leaf files (counterpart of
``paddlebox_tpu/utils/checkpoint.py``).

A params list is stored as one ``.npz`` of ``leaf_%05d`` arrays, committed
atomically (write a temporary file, fsync, rename). Loading validates the
key set and every leaf's shape and dtype against a template before any
array is returned. The port keeps no pytree: the caller passes the leaf
template (arrays, or anything with ``shape`` and ``dtype``).
"""

from __future__ import annotations

import os
import uuid
from typing import Dict, List, Sequence

import numpy as np


def leaf_arrays(leaves: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    return {f"leaf_{i:05d}": np.asarray(x) for i, x in enumerate(leaves)}


def write_npz(path: str, arrays: Dict[str, np.ndarray],
              compressed: bool = True) -> None:
    """Commit ``arrays`` to ``path`` atomically."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            (np.savez_compressed if compressed else np.savez)(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


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
