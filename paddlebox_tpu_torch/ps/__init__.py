"""Embedding tables of the port: the serving table, the host table (the
DRAM tier and its sparse optimizers), the hash-sharded host table, the
device-resident table of the training path, the tiered tables over the
two, the device-sharded table of the mesh engine and the cross-host table
of a multi-host job (``DistributedTable``).

Every name resolves at first use (PEP 562): a PS shard child imports this
package and must import no torch.
"""

import importlib

_LAZY = {
    "EmbeddingTable": "paddlebox_tpu_torch.ps.table",
    "ShardedTable": "paddlebox_tpu_torch.ps.sharded",
    "SparsePS": "paddlebox_tpu_torch.ps.server",
    "DistributedTable": "paddlebox_tpu_torch.ps.distributed",
    "DeviceTable": "paddlebox_tpu_torch.ps.device_table",
    "ShardedDeviceTable": "paddlebox_tpu_torch.ps.sharded_device_table",
    "TieredDeviceTable": "paddlebox_tpu_torch.ps.tiered_table",
    "TieredShardedDeviceTable": "paddlebox_tpu_torch.ps.tiered_table",
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
