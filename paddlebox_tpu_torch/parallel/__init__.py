"""Multi-device execution of the port (counterpart of
``paddlebox_tpu/parallel/``): the mesh and its collectives (``mesh``), the
plan's gradient helpers (``plan``), the batch split (``dp_step``) and the
fused train step over a device-sharded table (``fused_dp_step``).

Every name resolves at first use (PEP 562), so importing the package
imports none of its modules, and no torch through them.
"""

import importlib

_LAZY = {
    "AXIS_DP": "paddlebox_tpu_torch.parallel.mesh",
    "AXIS_MP": "paddlebox_tpu_torch.parallel.mesh",
    "AXIS_SP": "paddlebox_tpu_torch.parallel.mesh",
    "AXIS_EP": "paddlebox_tpu_torch.parallel.mesh",
    "AXIS_PP": "paddlebox_tpu_torch.parallel.mesh",
    "MESH_AXES": "paddlebox_tpu_torch.parallel.mesh",
    "Mesh": "paddlebox_tpu_torch.parallel.mesh",
    "make_mesh": "paddlebox_tpu_torch.parallel.mesh",
    "Plan": "paddlebox_tpu_torch.parallel.plan",
    "PlanError": "paddlebox_tpu_torch.parallel.plan",
    "ShardedBatch": "paddlebox_tpu_torch.parallel.dp_step",
    "split_batch": "paddlebox_tpu_torch.parallel.dp_step",
    "FusedShardedTrainStep": "paddlebox_tpu_torch.parallel.fused_dp_step",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
