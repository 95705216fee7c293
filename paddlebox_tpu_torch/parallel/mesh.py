"""The device mesh of the port (counterpart of
``paddlebox_tpu/parallel/mesh.py``): the axis constants, ``Mesh`` and
``make_mesh``, and the collectives of the mesh engines.

The reference is single-controller: one process holds a ``jax.sharding.
Mesh`` of ``ndev`` devices and XLA compiles the collectives. The port keeps
that shape. A ``Mesh`` is an ordered list of ``torch.device``s, one a shard,
under the reference's axis names; one process drives every shard, and each
shard's tensors (its arena, its state, its mirror) live on its own device.
Several shards may share one device: ``make_mesh(4, device="cpu")`` is four
CPU shards in one process, as the reference's tests emulate eight devices in
one (``tests/conftest.py``), and ``make_mesh(4, device="cuda:0")`` four
shards on one card.

The collectives are plain functions over per-shard lists, so that every
exchange of the engines goes through these methods (a process-group
backend, where the engines go multi-controller, belongs here too):

- ``Mesh.all_to_all(blocks)``: ``blocks[d]`` is shard ``d``'s
  ``[ndev, R, ...]`` tensor; block ``[d, s]`` goes to ``[s, d]``, copied to
  shard ``s``'s device. The reference's ``lax.all_to_all(x, axis, 0, 0)``.
- ``Mesh.psum(xs)``: the shards' tensors added in shard order 0..ndev-1, on
  shard 0's device. The fixed order keeps a cross-shard sum deterministic.
- ``Mesh.pmean(xs)``: ``psum`` divided by ``ndev``, a copy on every
  shard's device (LocalSGD's sync, ``lax.pmean``).
- ``Mesh.all_gather(xs)``: the shards' tensors concatenated along dim 0 in
  shard order, a copy on every shard's device (ZeRO's parameter gather,
  ``lax.all_gather(x, axis, tiled=True)``).
- ``Mesh.reduce_scatter(xs)``: ``xs[d]`` is shard ``d``'s ``[ndev * c,
  ...]`` tensor; shard ``s`` gets chunk ``s`` of every shard's, added in
  shard order, on its device (``lax.psum_scatter(x, axis, tiled=True)``).
- ``Mesh.ppermute(xs, perm)``: ``(src, dst)`` pairs; shard ``dst`` gets
  ``xs[src]`` on its device, a shard no pair names gets zeros (None stays
  None): the pipeline's and the ring's neighbour hop (``lax.ppermute``).

At ``ndev == 1`` each is the identity (``ppermute`` of the pair (0, 0)),
as in the reference (``parallel/fused_dp_step.py:298, :309``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from paddlebox_tpu_torch._device import DeviceLike, resolve_device

# the reference's axis names, one source for every module of the port
AXIS_DP = "dp"
AXIS_MP = "mp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_PP = "pp"
MESH_AXES = (AXIS_DP, AXIS_MP, AXIS_SP, AXIS_EP, AXIS_PP)


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` -> ``cuda:<current>``), the
    form a tensor's ``.device`` takes, so that devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """``devices``, one a shard, in shard order, along one named axis."""

    def __init__(self, devices: Sequence[DeviceLike],
                 axis_names: Tuple[str, ...] = (AXIS_DP,)):
        if len(axis_names) != 1:
            raise ValueError("the port's mesh has one axis (got "
                             f"{tuple(axis_names)})")
        for ax in axis_names:
            if ax not in MESH_AXES:
                raise ValueError(f"axis {ax!r} is not one of {MESH_AXES}")
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: List[torch.device] = [_indexed(resolve_device(d))
                                            for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = {axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")

    def all_to_all(self, blocks: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """``out[s][d] = blocks[d][s]``, on shard ``s``'s device."""
        n = self.size
        if len(blocks) != n or any(b.shape[0] != n for b in blocks):
            raise ValueError(f"all_to_all takes {n} blocks of [{n}, ...]")
        if n == 1:
            return list(blocks)
        return [torch.stack([blocks[d][s].to(self.devices[s])
                             for d in range(n)])
                for s in range(n)]

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """``xs[0] + xs[1] + ... + xs[ndev - 1]``, added in that order, on
        shard 0's device."""
        if len(xs) != self.size:
            raise ValueError(f"psum takes {self.size} tensors")
        out = xs[0]
        for x in xs[1:]:
            out = out + x.to(out.device)
        return out

    def pmean(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``psum(xs) / ndev``, a copy on each shard's device."""
        mean = self.psum(xs) / self.size
        return [mean.to(dev) for dev in self.devices]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``cat(xs)`` along dim 0 in shard order, a copy on each shard's
        device."""
        if len(xs) != self.size:
            raise ValueError(f"all_gather takes {self.size} tensors")
        return [torch.cat([x.to(dev) for x in xs]) for dev in self.devices]

    def reduce_scatter(self, xs: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Shard ``s`` gets ``sum over d of chunk s of xs[d]`` (dim 0 split
        into ``ndev`` equal chunks), added in shard order, on its
        device."""
        n = self.size
        if len(xs) != n or any(x.shape[0] % n for x in xs):
            raise ValueError(f"reduce_scatter takes {n} tensors whose dim "
                             f"0 divides by {n}")
        c = xs[0].shape[0] // n
        out = []
        for s, dev in enumerate(self.devices):
            acc = xs[0][s * c:(s + 1) * c].to(dev)
            for x in xs[1:]:
                acc = acc + x[s * c:(s + 1) * c].to(dev)
            out.append(acc)
        return out

    def ppermute(self, xs: Sequence[Optional[torch.Tensor]],
                 perm: Sequence[Tuple[int, int]]
                 ) -> List[Optional[torch.Tensor]]:
        """``out[dst] = xs[src]`` on shard ``dst``'s device for each
        ``(src, dst)`` pair; zeros where no pair sends (None where
        ``xs`` holds None)."""
        if len(xs) != self.size:
            raise ValueError(f"ppermute takes {self.size} tensors")
        dsts = [d for _, d in perm]
        if len(set(dsts)) != len(dsts) or \
                len({s for s, _ in perm}) != len(perm):
            raise ValueError(f"ppermute: {list(perm)} is not a permutation")
        out: List[Optional[torch.Tensor]] = [
            None if x is None else torch.zeros_like(x).to(dev)
            for x, dev in zip(xs, self.devices)]
        for src, dst in perm:
            x = xs[src]
            out[dst] = None if x is None else x.to(self.devices[dst])
        return out


def make_mesh(num_devices: int = 0, device: Optional[DeviceLike] = None,
              axis_names: Tuple[str, ...] = (AXIS_DP,)) -> Mesh:
    """A mesh of ``num_devices`` shards. ``device`` None: over the visible
    CUDA devices (``num_devices`` 0 = all of them; raises without CUDA).
    ``device`` given: ``num_devices`` shards (0 = 1), all on it."""
    if device is None:
        resolve_device(None)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if num_devices:
            if num_devices > len(devs):
                raise ValueError(f"{num_devices} devices asked, "
                                 f"{len(devs)} visible")
            devs = devs[:num_devices]
    else:
        devs = [resolve_device(device)] * max(int(num_devices), 1)
    return Mesh(devs, axis_names)
