"""Device meshes for the batched codec's data parallelism.

Counterpart of the JAX package's parallel/mesh.py.  The codec's batch
shards over the mesh's data axes, whole images per shard (see
parallel/batch.py); there is no parameter state, so a mesh is just an
array of devices with named axes.  A mesh may name one device more than
once (["cpu"] * 8, or ["cuda:0"] * 2 on a single card): each entry is one
shard, run on that device.
"""

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device


class Mesh:
    """An array of torch.device with named axes; `shape` maps each axis
    name to its size, in axis order, as jax.sharding.Mesh.shape does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.ravel()]})")


def _normalize(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Sequence[str] = ("data", "block"),
              devices=None) -> Mesh:
    """A (data, block) mesh over `devices` (default: every visible CUDA
    device; raises without CUDA).

    Default shape: all devices on 'data' if <= 4, else (n // 2, 2), as the
    JAX package chooses."""
    if devices is None:
        resolve_device(None)
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devs = [_normalize(d) for d in devices]
    n = len(devs)
    if shape is None:
        shape = (n, 1) if n <= 4 else (n // 2, 2)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


def shard_devices(mesh: Mesh, data_axes=None) -> List[torch.device]:
    """One device per data shard, in shard order: the data axes' index
    combinations, row-major in the order of `data_axes` (default: every
    axis), each at index 0 of the other axes (a shard runs once, on the
    first device of its group, not replicated)."""
    axes = mesh.axis_names if data_axes is None else tuple(data_axes)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"no axis {a!r} in mesh axes {mesh.axis_names}")
    dims = [mesh.axis_names.index(a) for a in axes]
    out = []
    for idx in np.ndindex(*(mesh.shape[a] for a in axes)):
        full = [0] * mesh.devices.ndim
        for d, i in zip(dims, idx):
            full[d] = i
        out.append(mesh.devices[tuple(full)])
    return out
