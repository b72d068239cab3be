"""Collectives and ``shard_map`` for one controller.

JAX's ``shard_map`` runs a local function once per device, and
``lax.ppermute``/``all_gather``/``psum`` move data between the devices.
Here one process holds every block, so the local function takes the
blocks of every shard at once: each operand is an object array of the
mesh's shape, and a collective is an operation over the blocks along one
mesh axis.  A block is always copied, never handed over as a view, so that
an op on one block cannot change another: within a device by ``copy_``,
between devices by ``.to(device, non_blocking=True)``, which PyTorch orders
after the producer's work on the source device.

Each collective adds one to :data:`COLLECTIVES` under its name, which
:func:`xgcm_tpu_torch.utils.inspection.count_collectives` reads: the count
of one run of a program equals the number of collectives in the jaxpr of
its JAX counterpart.  Splitting operands onto the mesh and assembling
results are placements, not collectives, as they are outside a jaxpr.
"""

from __future__ import annotations

import collections
import functools
import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from .mesh import Mesh, PartitionSpec, to_sharded
from .sharded_tensor import ShardedTensor

__all__ = [
    "COLLECTIVES",
    "all_gather",
    "coords",
    "map_blocks",
    "ppermute",
    "psum",
    "shard_map",
    "unzip",
]

# collectives made since the last reset, by name
COLLECTIVES: collections.Counter = collections.Counter()


def coords(mesh: Mesh):
    """Every mesh coordinate, in row-major order (``np.ndindex``'s, without
    the cost of building one on every call)."""
    return itertools.product(*(range(n) for n in mesh.devices.shape))


def map_blocks(fn: Callable, *block_arrays: np.ndarray, mesh: Mesh) -> np.ndarray:
    """``fn(*blocks_at_c)`` for each coordinate c: the per-shard part of a
    local function.  ``fn`` may return a tuple; the result is then an
    object array of tuples."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for c in coords(mesh):
        out[c] = fn(*(b[c] for b in block_arrays))
    return out


def unzip(results: np.ndarray, n: int):
    """An object array of n-tuples as n object arrays."""
    outs = [np.empty(results.shape, dtype=object) for _ in range(n)]
    for c in np.ndindex(results.shape):
        for i in range(n):
            outs[i][c] = results[c][i]
    return outs


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.device == device:
        return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)
    return t.to(device, non_blocking=True)


def _along(c, ax: int, k: int):
    return c[:ax] + (k,) + c[ax + 1:]


def ppermute(blocks: np.ndarray, mesh: Mesh, axis_name: str, perm) -> np.ndarray:
    """``lax.ppermute``: for each (src, dst) pair of indices along
    ``axis_name`` the block at dst receives a copy of the one at src; a
    block that receives nothing is zeros."""
    COLLECTIVES["ppermute"] += 1
    ax = mesh.axis_index(axis_name)
    src_of = {dst: src for src, dst in perm}
    out = np.empty(blocks.shape, dtype=object)
    for c in coords(mesh):
        dev = mesh.devices[c]
        src = src_of.get(c[ax])
        out[c] = (torch.zeros_like(blocks[c], device=dev) if src is None
                  else _copy_to(blocks[_along(c, ax, src)], dev))
    return out


def all_gather(blocks: np.ndarray, mesh: Mesh, axis_name: str, axis: int = 0,
               tiled: bool = False) -> np.ndarray:
    """``lax.all_gather``: every block receives the blocks along
    ``axis_name`` in index order, stacked on a new ``axis`` (or joined
    along it with ``tiled=True``)."""
    COLLECTIVES["all_gather"] += 1
    ax = mesh.axis_index(axis_name)
    n = mesh.devices.shape[ax]
    join = torch.cat if tiled else torch.stack
    out = np.empty(blocks.shape, dtype=object)
    for c in coords(mesh):
        dev = mesh.devices[c]
        out[c] = join([blocks[_along(c, ax, k)].to(dev) for k in range(n)], dim=axis)
    return out


def psum(blocks: np.ndarray, mesh: Mesh, axis_name) -> np.ndarray:
    """``lax.psum``: every block receives the sum of the blocks along
    ``axis_name`` (one mesh axis, or a tuple of them: one collective over
    their product), added in row-major index order.  uint16/32/64 add as
    the signed integers of their width, which wrap as they do."""
    from ..ops.stencils import wrapping

    COLLECTIVES["psum"] += 1
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    axes = [mesh.axis_index(a) for a in names]
    sizes = [mesh.devices.shape[a] for a in axes]
    out = np.empty(blocks.shape, dtype=object)
    for c in coords(mesh):
        dev = mesh.devices[c]
        parts = []
        for ks in np.ndindex(*sizes):
            src = list(c)
            for a, k in zip(axes, ks):
                src[a] = k
            parts.append(wrapping(blocks[tuple(src)].to(dev)))
        dtype = blocks[c].dtype
        out[c] = functools.reduce(torch.add, parts[1:], parts[0].clone()).view(dtype)
    return out


def shard_map(local: Callable, mesh: Mesh, in_specs: Sequence[PartitionSpec],
              out_specs) -> Callable:
    """The counterpart of ``jax.shard_map`` for one controller.

    ``shard_map(local, mesh, in_specs, out_specs)(*arrays)`` places each
    array on the mesh by its spec (a ShardedTensor already so placed is
    taken as it is), calls ``local`` once with one object array of blocks
    per operand, and wraps the object array(s) it returns as
    ShardedTensors of ``out_specs`` (one PartitionSpec, or a tuple of
    them for a tuple of outputs)."""
    single = isinstance(out_specs, PartitionSpec)

    def run(*arrays):
        if len(arrays) != len(in_specs):
            raise ValueError(f"{len(arrays)} operands for {len(in_specs)} in_specs")
        blocks = [to_sharded(a, mesh, spec).blocks for a, spec in zip(arrays, in_specs)]
        out = local(*blocks)
        if single:
            return ShardedTensor(out, mesh, out_specs)
        return tuple(ShardedTensor(o, mesh, s) for o, s in zip(out, out_specs))

    return run
