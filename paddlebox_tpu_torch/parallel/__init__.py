"""Multi-device execution of the port (counterpart of
``paddlebox_tpu/parallel/``): the mesh and its collectives (``mesh``), the
sharding plan and the gradient helpers (``plan``), the data-parallel step
over a host table and the batch split (``dp_step``), the fused train step
over a device-sharded table (``fused_dp_step``), ZeRO (``zero``), expert
parallelism (``sharding``), the GPipe pipeline (``pipeline``), ring
attention (``ring_attention``), and the multi-host layer: the TCP
transport between processes (``coordinator``) and the role and start of a
process of a job (``fleet``, a module: ``from paddlebox_tpu_torch.parallel
import fleet``).

Every name resolves at first use (PEP 562), so importing the package
imports none of its modules, and no torch through them. The function
``ring_attention`` is reached through its module (a package attribute of
that name is the module once it is imported).
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
    "PLAN_SHARDED_AXES": "paddlebox_tpu_torch.parallel.plan",
    "PartitionSpec": "paddlebox_tpu_torch.parallel.plan",
    "Plan": "paddlebox_tpu_torch.parallel.plan",
    "PlanError": "paddlebox_tpu_torch.parallel.plan",
    "Rule": "paddlebox_tpu_torch.parallel.plan",
    "match_partition_rules": "paddlebox_tpu_torch.parallel.plan",
    "ShardedBatch": "paddlebox_tpu_torch.parallel.dp_step",
    "ShardedTrainStep": "paddlebox_tpu_torch.parallel.dp_step",
    "split_batch": "paddlebox_tpu_torch.parallel.dp_step",
    "stack_batches": "paddlebox_tpu_torch.parallel.dp_step",
    "FusedShardedTrainStep": "paddlebox_tpu_torch.parallel.fused_dp_step",
    "ZeroShardedTrainStep": "paddlebox_tpu_torch.parallel.zero",
    "expert_shardings": "paddlebox_tpu_torch.parallel.sharding",
    "PipelinedTower": "paddlebox_tpu_torch.parallel.pipeline",
    "make_pipeline": "paddlebox_tpu_torch.parallel.pipeline",
    "pipeline_apply": "paddlebox_tpu_torch.parallel.pipeline",
    "sequential_reference": "paddlebox_tpu_torch.parallel.pipeline",
    "dense_attention": "paddlebox_tpu_torch.parallel.ring_attention",
    "Coordinator": "paddlebox_tpu_torch.parallel.coordinator",
    "local_endpoints": "paddlebox_tpu_torch.parallel.coordinator",
    "np_from_bytes": "paddlebox_tpu_torch.parallel.coordinator",
    "np_to_bytes": "paddlebox_tpu_torch.parallel.coordinator",
    "Role": "paddlebox_tpu_torch.parallel.fleet",
    "ring_self_attention": "paddlebox_tpu_torch.parallel.ring_attention",
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
