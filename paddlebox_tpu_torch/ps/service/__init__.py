"""Networked parameter-server service: the hash-sharded PS over the wire
(counterpart of ``paddlebox_tpu/ps/service/``).

N shard server children (``shard_server``), each owning the ``shard_of``
slice of every table, behind a versioned request/reply protocol over the
serving transport's length-prefixed frames; a client (``client``) that
partitions, deduplicates and pipelines each shard's traffic, retries
transient failures and raises :class:`ShardUnavailable` when a shard
stays down. Neither side imports torch.
"""

from paddlebox_tpu_torch.ps.service.client import (RemotePS, RemoteTable,
                                                   ServiceClient,
                                                   ShardUnavailable)
from paddlebox_tpu_torch.ps.service.shard_server import (ShardHandle,
                                                         ShardService,
                                                         ShardSpawnError)

__all__ = ["ServiceClient", "RemoteTable", "RemotePS",
           "ShardUnavailable", "ShardHandle", "ShardService",
           "ShardSpawnError"]
