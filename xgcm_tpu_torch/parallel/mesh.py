"""Device meshes and placing gridded arrays on them.

The port's distribution model is single-controller, as JAX's is: one
process holds a :class:`Mesh`, an array of ``torch.device`` with named
axes, and every sharded array is a
:class:`~.sharded_tensor.ShardedTensor` with one block per mesh
coordinate.  A device may appear in a mesh more than once ("logical
shards": four blocks on ``cuda:0``), which is how one card, or the CPU in
the tests (``make_mesh(axes, devices=[torch.device("cpu")] * 8)``), runs
the same programs a mesh of several cards does.  A collective is a copy
between blocks (:mod:`.collectives`).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..core.dataarray import GriddedArray, as_tensor
from .sharded_tensor import ShardedTensor, distribute

__all__ = [
    "Mesh",
    "PartitionSpec",
    "make_mesh",
    "partition_spec",
    "replicate",
    "shard_gridded",
    "to_sharded",
]


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as the card it means (the current one), so that a block's
    device compares equal to its mesh coordinate's."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available()
                            else 0)
    return d


class Mesh:
    """An n-d array of ``torch.device`` with one name per axis, like
    ``jax.sharding.Mesh``: ``mesh.shape`` maps each axis name to its
    size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        self.devices = np.empty(devices.shape, dtype=object)
        for c in np.ndindex(devices.shape):
            self.devices[c] = _indexed(torch.device(devices[c]))
        self.axis_names = axis_names

    @property
    def shape(self) -> Mapping[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat, other.devices.flat)))

    def __hash__(self):
        return hash((self.axis_names, tuple(str(d) for d in self.devices.flat)))

    def axis_index(self, name: str) -> int:
        return self.axis_names.index(name)

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, devices={sorted({str(d) for d in self.devices.flat})})"


def make_mesh(axes: Mapping[str, int], devices=None) -> Mesh:
    """A Mesh with named axes, e.g. ``make_mesh({"x": 4, "batch": 2})``.

    Without ``devices`` it takes every visible CUDA card and raises when
    there are fewer than the mesh needs; it never falls back to the CPU.
    An explicit ``devices`` list (``torch.device`` or strings) may repeat a
    device: ``make_mesh({"x": 4}, devices=["cuda:0"] * 4)`` makes four
    logical shards on one card.  Trailing devices beyond the mesh's size
    are dropped.
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    size = int(np.prod(list(axes.values())))
    if size > len(devices):
        raise ValueError(
            f"mesh {dict(axes)} needs {size} devices but only {len(devices)} available"
        )
    grid = np.empty(size, dtype=object)
    for i, d in enumerate(devices[:size]):
        grid[i] = d
    return Mesh(grid.reshape(tuple(axes.values())), tuple(axes.keys()))


class PartitionSpec(tuple):
    """One mesh-axis name or ``None`` per dim, like
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)}"


def partition_spec(dims: Sequence[str], dim_to_mesh_axis: Mapping[str, str]) -> PartitionSpec:
    """PartitionSpec for an array with named dims, given a dim->mesh-axis map."""
    return PartitionSpec(*(dim_to_mesh_axis.get(d) for d in dims))


def to_sharded(data, mesh: Mesh, spec: Sequence) -> ShardedTensor:
    """``data`` as a ShardedTensor of ``spec`` on ``mesh``: kept as it is
    when it already is one, re-split (one assembly) when its mesh or spec
    differ, split when it is a plain tensor or host data (host data goes
    straight to each block's device)."""
    spec = tuple(spec)
    if isinstance(data, ShardedTensor):
        if data.mesh == mesh and tuple(data.spec) == spec:
            return data
        data = data.full_tensor()
    elif not isinstance(data, torch.Tensor):
        data = as_tensor(data, mesh.devices.flat[0])
    return distribute(data, mesh, spec)


def shard_gridded(
    garr: GriddedArray,
    mesh: Mesh,
    dim_to_mesh_axis: Mapping[str, str],
    uneven_ok: tuple = (),
) -> GriddedArray:
    """Place a GriddedArray onto the mesh, sharding the named dims.

    Dims whose size does not divide their mesh axis stay replicated and
    WARN — silent replication would hide a misconfigured mesh.  Name dims
    where uneven replication is intended in ``uneven_ok`` to suppress the
    warning."""
    import warnings

    sizes = mesh.shape
    mapping = {}
    for d, ax in dim_to_mesh_axis.items():
        if ax is None or d not in garr.dims:
            continue
        if garr.sizes[d] % sizes[ax] == 0:
            mapping[d] = ax
        elif d not in uneven_ok:
            warnings.warn(
                f"dim {d!r} (size {garr.sizes[d]}) does not divide mesh "
                f"axis {ax!r} (size {sizes[ax]}); replicating instead of "
                f"sharding (pass uneven_ok=({d!r},) if intended)",
                UserWarning,
            )
    spec = partition_spec(garr.dims, mapping)
    return GriddedArray(to_sharded(garr.data, mesh, spec), garr.dims, name=garr.name,
                        attrs=garr.attrs)


def replicate(garr: GriddedArray, mesh: Mesh) -> GriddedArray:
    """Fully replicate a GriddedArray over the mesh: a copy on every
    coordinate."""
    spec = PartitionSpec(*([None] * garr.ndim))
    return GriddedArray(to_sharded(garr.data, mesh, spec), garr.dims, name=garr.name,
                        attrs=garr.attrs)
