"""A single-process device mesh and its collectives
(``hyperres/parallel/mesh.py``).

The reference runs one controller over a ``jax.sharding.Mesh``: every
sharded op takes global arrays, ``shard_map`` runs its body once per
shard, and XLA's collectives move data between the shards. The port
keeps that form. A :class:`Mesh` is an ndarray of ``torch.device`` with
axis names, and a device may repeat, so n logical shards can share one
card (the real n-shard decomposition, halo exchange included, on one
GPU) or sit on n cards. An op splits its global inputs into per-shard
tensors (:func:`shard`, :func:`replicate`), runs each shard's body on
its device, and moves data between shards with the collectives below,
which are explicit copies between the shards' tensors.

Placing a tensor on the device it is already on is a no-op, not a copy:
a shard of a tensor that already lies on the shard's device is a view
of it, and a replicated input costs one copy per distinct device, not
one per shard. Collective results placed on one device are one tensor
shared by the shards on that device; treat them as read-only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


@dataclass(frozen=True)
class Mesh:
    """``devices``: an ndarray of ``torch.device`` (object dtype), one
    entry per shard; ``axis_names``: one name per array axis."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str, **at: int) -> List[torch.device]:
        """The devices along ``axis``, the other axes held at the indices
        given by name (default 0)."""
        idx = tuple(slice(None) if name == axis else at.get(name, 0)
                    for name in self.axis_names)
        return list(self.devices[idx])


def _as_device(d: DeviceLike) -> torch.device:
    """An explicit device: a bare ``"cuda"`` becomes the current card."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Mesh over ``devices`` (repeats allowed; default every CUDA device,
    and a CUDA device must be present). Default ``shape``: 1-D over all
    the devices given; ``shape=(dp, bp)`` with ``axis_names=("data",
    "band")`` for 2-D. Takes the first ``prod(shape)`` devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices="
                               "['cpu'] * n for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_as_device(d) for d in devices]
    if shape is None:
        shape = (len(devs),)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axis_names {tuple(axis_names)} "
                         f"differ in length")
    need = int(np.prod(shape))
    if need > len(devs):
        raise ValueError(f"mesh {shape} needs {need} devices, got "
                         f"{len(devs)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return Mesh(arr.reshape(shape), tuple(axis_names))


def replicate(x, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` on each of ``devices``: one copy per distinct device (none
    where ``x`` already lies), shared by the shards on it."""
    t = torch.as_tensor(x)
    placed: Dict[torch.device, torch.Tensor] = {}
    out = []
    for d in devices:
        if d not in placed:
            placed[d] = t.to(d)
        out.append(placed[d])
    return out


def shard(x, devices: Sequence[torch.device], dim: int = 0
          ) -> List[torch.Tensor]:
    """``x`` split into ``len(devices)`` equal blocks along ``dim``, block
    i on ``devices[i]`` (a view where ``x`` already lies there). The
    length along ``dim`` must be a multiple of the shard count."""
    t = torch.as_tensor(x)
    n = len(devices)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of length {t.shape[dim]} does not "
                         f"divide into {n} shards")
    size = t.shape[dim] // n
    return [t.narrow(dim, i * size, size).to(d)
            for i, d in enumerate(devices)]


def shard_batch(x, mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """``x`` with its leading dim split over ``axis``: the list of blocks,
    block i on the device at index i of ``axis`` (the other axes at 0)."""
    return shard(x, mesh.axis_devices(axis))


def _reduce(parts: Sequence[torch.Tensor], devices: Sequence[torch.device],
            op) -> List[torch.Tensor]:
    acc = parts[0].to(devices[0])
    for p in parts[1:]:
        acc = op(acc, p.to(devices[0]))
    return replicate(acc, devices)


def psum(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]
         ) -> List[torch.Tensor]:
    """Sum of the per-shard tensors (in shard order, on the first
    shard's device), placed back on every shard's device."""
    return _reduce(parts, devices, torch.add)


def pmin(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]
         ) -> List[torch.Tensor]:
    """Elementwise minimum over the shards, on every shard's device."""
    return _reduce(parts, devices, torch.minimum)


def pmax(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]
         ) -> List[torch.Tensor]:
    """Elementwise maximum over the shards, on every shard's device."""
    return _reduce(parts, devices, torch.maximum)


def ppermute(parts: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]],
             devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``jax.lax.ppermute``: for each (source, destination) pair in
    ``perm`` shard ``destination`` receives shard ``source``'s tensor on
    its own device; a shard no pair sends to receives zeros."""
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for src, dst in perm:
        out[dst] = parts[src].to(devices[dst])
    return [torch.zeros_like(parts[i], device=devices[i]) if t is None else t
            for i, t in enumerate(out)]


def all_gather(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device], dim: int = 0
               ) -> List[torch.Tensor]:
    """The shards concatenated along ``dim`` (in shard order), placed on
    every shard's device."""
    return replicate(torch.cat([p.to(devices[0]) for p in parts], dim=dim),
                     devices)
