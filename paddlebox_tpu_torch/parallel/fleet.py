"""The fleet surface: a process's role and the start of its transport
(counterpart of ``paddlebox_tpu/parallel/fleet.py``). A job calls::

    role = fleet.init()                  # from arguments or environment
    table = DistributedTable(conf, role.coordinator)   # world > 1
    ...
    fleet.barrier()
    fleet.stop()

The rank and the endpoints come from the arguments, else from
``PBOX_TRAINER_ID`` / ``PBOX_TRAINER_ENDPOINTS``, else from
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINER_ENDPOINTS`` (comma-separated
``host:port``), else rank 0 of a world of 1. A world of more than one rank
starts a ``Coordinator`` on the rank's endpoint; a world of one opens no
socket.

``init_torch_distributed=True`` (the reference's ``init_jax_distributed``)
also starts ``torch.distributed``'s default process group over the world:
``backend`` None picks gloo when ``device`` is the CPU and NCCL on the card
(``device`` None = the card). Its store listens at ``dist_endpoint``, else
at ``PBOX_DIST_ENDPOINT``, else on the host of ``endpoints[0]`` at that
endpoint's port plus one: never on the coordinator's own port, which rank
0's coordinator holds. ``stop()`` closes the coordinator and destroys a
process group that ``init`` started.

Imports no torch unless ``init_torch_distributed`` is set.
"""

from __future__ import annotations

import dataclasses
import os
from typing import TYPE_CHECKING, List, Optional

from paddlebox_tpu_torch.parallel.coordinator import Coordinator

if TYPE_CHECKING:
    from paddlebox_tpu_torch._device import DeviceLike

_ENV_ID = ("PBOX_TRAINER_ID", "PADDLE_TRAINER_ID")
_ENV_EPS = ("PBOX_TRAINER_ENDPOINTS", "PADDLE_TRAINER_ENDPOINTS")
_ENV_DIST = "PBOX_DIST_ENDPOINT"


@dataclasses.dataclass
class Role:
    rank: int
    world: int
    endpoints: List[str]
    coordinator: Optional[Coordinator] = None
    # the torch.distributed backend init started ("gloo", "nccl"), or None
    dist_backend: Optional[str] = None

    def is_first_worker(self) -> bool:
        return self.rank == 0


_ROLE: Optional[Role] = None


def dist_store_endpoint(endpoints: List[str],
                        dist_endpoint: Optional[str] = None) -> str:
    """The ``host:port`` of the process group's store: ``dist_endpoint``,
    else ``PBOX_DIST_ENDPOINT``, else ``endpoints[0]``'s host at its port
    plus one."""
    if dist_endpoint:
        return dist_endpoint
    if os.environ.get(_ENV_DIST):
        return os.environ[_ENV_DIST]
    host, port = endpoints[0].rsplit(":", 1)
    return f"{host}:{int(port) + 1}"


def _init_process_group(rank: int, world: int, endpoints: List[str],
                        device: "DeviceLike", backend: Optional[str],
                        dist_endpoint: Optional[str]) -> str:
    import torch.distributed as dist

    from paddlebox_tpu_torch._device import resolve_device
    if backend is None:
        backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{dist_store_endpoint(endpoints, dist_endpoint)}",
        world_size=world, rank=rank)
    return backend


def init(rank: Optional[int] = None,
         endpoints: Optional[List[str]] = None,
         init_torch_distributed: bool = False,
         device: "DeviceLike" = None,
         backend: Optional[str] = None,
         dist_endpoint: Optional[str] = None) -> Role:
    """Resolve the role, start the coordinator when the world has more
    than one rank and, with ``init_torch_distributed``, the process
    group."""
    global _ROLE
    if endpoints is None:
        for var in _ENV_EPS:
            if os.environ.get(var):
                endpoints = os.environ[var].split(",")
                break
        else:
            endpoints = ["127.0.0.1:0"]
    if rank is None:
        for var in _ENV_ID:
            if os.environ.get(var):
                rank = int(os.environ[var])
                break
        else:
            rank = 0
    world = len(endpoints)
    coord = Coordinator(rank, endpoints) if world > 1 else None
    dist_backend = None
    if init_torch_distributed and world > 1:
        try:
            dist_backend = _init_process_group(rank, world, endpoints,
                                               device, backend,
                                               dist_endpoint)
        except BaseException:
            coord.close()
            raise
    _ROLE = Role(rank=rank, world=world, endpoints=endpoints,
                 coordinator=coord, dist_backend=dist_backend)
    return _ROLE


def role() -> Role:
    if _ROLE is None:
        return init()
    return _ROLE


def worker_index() -> int:
    return role().rank


def worker_num() -> int:
    return role().world


def is_first_worker() -> bool:
    return role().is_first_worker()


def barrier(name: str = "fleet") -> None:
    r = role()
    if r.coordinator is not None:
        r.coordinator.barrier(name)


def stop() -> None:
    global _ROLE
    if _ROLE is not None:
        if _ROLE.coordinator is not None:
            _ROLE.coordinator.close()
        if _ROLE.dist_backend is not None:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
    _ROLE = None
