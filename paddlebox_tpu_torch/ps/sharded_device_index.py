"""The per-shard index mirrors of the device-sharded table, for the mesh
engine's device prep (counterpart of
``paddlebox_tpu/ps/sharded_device_index.py``).

One ``DeviceIndexMirror`` (``ps/device_index.py``) a shard, its table on
that shard's device: the step's owner body on shard ``s`` dedups what the
requesters sent it and probes its own mirror (K5 with K6 folded in), so no
routing plan is built on the host in the hot loop. The table's
``ensure_keys`` routes new keys by the owner hash and writes them into the
right shard's native index and mirror before a run ships.

The reference stacks the shards' mirrors into one ``[ndev, S, 4]`` array
for its ``shard_map`` and keeps a second, "mini" level per shard; the
port's mirror has one level (``ps/device_index.py`` says why, and its probe
answers as the reference's two-level one does), and each shard's body reads
its own mirror, so no stacked view is needed.
"""

from __future__ import annotations

from typing import List, Sequence

from paddlebox_tpu_torch.parallel.mesh import Mesh
from paddlebox_tpu_torch.ps.device_index import DeviceIndexMirror
from paddlebox_tpu_torch.ps.native import NativeIndex


class ShardedDeviceIndexMirror:
    """``ndev`` mirrors, shard ``s``'s over ``indexes[s]`` on
    ``mesh.devices[s]``."""

    def __init__(self, indexes: Sequence[NativeIndex], mesh: Mesh):
        if len(indexes) != mesh.size:
            raise ValueError(f"{len(indexes)} indexes for a mesh of "
                             f"{mesh.size} shards")
        self.mesh = mesh
        self.ndev = mesh.size
        self.shards: List[DeviceIndexMirror] = [
            DeviceIndexMirror(ix, dev)
            for ix, dev in zip(indexes, mesh.devices)]

    def sync(self) -> None:
        """Every shard's full export and upload."""
        for m in self.shards:
            m.sync()

    def memory_bytes(self) -> int:
        return sum(m.memory_bytes() for m in self.shards)
