"""Collectives and ``shard_map``, for one process or several.

JAX's ``shard_map`` runs a local function once per device, and
``lax.ppermute``/``all_gather``/``psum`` move data between the devices.
Here the local function takes the blocks of every shard the process holds
at once: each operand is an object array of the mesh's shape (``None`` at
the coordinates of other processes), and a collective is an operation over
the blocks along one mesh axis.  A block is always copied, never handed
over as a view, so that an op on one block cannot change another: within a
device by ``copy_``, between devices of one process by ``.to(device,
non_blocking=True)``, which PyTorch orders after the producer's work on the
source device.

On a mesh over several processes (:func:`~.mesh.make_multihost_mesh`) the
blocks that cross a process boundary go through ``torch.distributed``:
:func:`fetch` posts one batch of point-to-point messages a collective
(``batch_isend_irecv``), its (source, destination) pairs in the same order
on every process, so that NCCL's order and gloo's tags match; a block goes
once to each process that needs it, however many of its coordinates do.
The receiver takes a block's shape and dtype from its own blocks: the
blocks of one operand all share them, as the shards of a ``shard_map``
do.  Under the gloo backend, which the caller chose, CUDA blocks are
staged through host memory (gloo moves no CUDA tensor).
:data:`TRANSPORT` counts the bytes that crossed, and under ``peer_bytes``
the bytes a collective copies from one of the process's own coordinates to
another (between its cards where the mesh spans several; within a card
for logical shards).

Each collective adds one to :data:`COLLECTIVES` under its name, in every
process, which :func:`xgcm_tpu_torch.utils.inspection.count_collectives`
reads: the count of one run of a program equals the number of collectives
in the jaxpr of its JAX counterpart.  Splitting operands onto the mesh and
assembling results are placements, not collectives, as they are outside a
jaxpr.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, PartitionSpec, to_sharded
from .sharded_tensor import ShardedTensor, first_local

__all__ = [
    "COLLECTIVES",
    "TRANSPORT",
    "all_gather",
    "coords",
    "fetch",
    "first_local",
    "map_blocks",
    "ppermute",
    "psum",
    "shard_map",
    "unzip",
]

# collectives made since the last reset, by name
COLLECTIVES: collections.Counter = collections.Counter()
# bytes and messages this process sent to and received from others
TRANSPORT: collections.Counter = collections.Counter()


def coords(mesh: Mesh):
    """The mesh coordinates this process holds (every one in a single
    process), in row-major order."""
    return mesh.local_coords


def map_blocks(fn: Callable, *block_arrays: np.ndarray, mesh: Mesh) -> np.ndarray:
    """``fn(*blocks_at_c)`` for each coordinate c this process holds: the
    per-shard part of a local function.  ``fn`` may return a tuple; the
    result is then an object array of tuples."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for c in mesh.local_coords:
        out[c] = fn(*(b[c] for b in block_arrays))
    return out


def unzip(results: np.ndarray, n: int):
    """An object array of n-tuples as n object arrays."""
    outs = [np.empty(results.shape, dtype=object) for _ in range(n)]
    for c in np.ndindex(results.shape):
        if results[c] is not None:
            for i in range(n):
                outs[i][c] = results[c][i]
    return outs


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.device == device:
        return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)
    return t.to(device, non_blocking=True)


def fetch(blocks: np.ndarray, mesh: Mesh, needs) -> dict:
    """The blocks of other processes that this one needs, by source
    coordinate: ``needs`` is a sequence of (source, destination)
    coordinate pairs, the same on every process; each pair whose ends lie
    on two processes moves the source block to the destination's process
    once, onto the destination's device.  Empty on a single-process
    mesh."""
    if not mesh.multiprocess:
        return {}
    me = mesh.rank
    sent = set()
    moves = []  # (source, source process, destination process, destination device)
    for src, dst in needs:
        ps, pd = int(mesh.process_ids[src]), int(mesh.process_ids[dst])
        if ps != pd and (src, pd) not in sent:
            sent.add((src, pd))
            moves.append((src, ps, pd, mesh.devices[dst]))
    if not any(me in (ps, pd) for _, ps, pd, _ in moves):
        return {}
    like = first_local(blocks)
    if any(blocks[c].shape != like.shape or blocks[c].dtype != like.dtype
           for c in mesh.local_coords):
        raise ValueError("a collective's blocks must share their shape and dtype")
    nbytes = like.numel() * like.element_size()
    stage = dist.get_backend() == "gloo"
    ops, received = [], {}
    for tag, (src, ps, pd, dev) in enumerate(moves):
        if me not in (ps, pd):
            continue
        if ps == me:
            t = blocks[src].contiguous().reshape(-1).view(torch.uint8)
            if stage:
                t = t.cpu()
            ops.append(dist.P2POp(dist.isend, t, pd, tag=tag))
            TRANSPORT["bytes_sent"] += nbytes
        else:
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              device="cpu" if stage else dev)
            ops.append(dist.P2POp(dist.irecv, buf, ps, tag=tag))
            received[src] = (buf, dev)
            TRANSPORT["bytes_received"] += nbytes
    TRANSPORT["messages"] += len(ops)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return {src: buf.view(like.dtype).reshape(like.shape).to(dev)
            for src, (buf, dev) in received.items()}


def _block(blocks, mesh, got, src, dst=None):
    """The block at ``src``: this process's own, or the one fetched; a
    block of this process going to another coordinate ``dst`` counts its
    bytes under ``TRANSPORT["peer_bytes"]``."""
    if not mesh.is_local(src):
        return got[src]
    b = blocks[src]
    if dst is not None and dst != src:
        TRANSPORT["peer_bytes"] += b.numel() * b.element_size()
    return b


def _along(c, ax: int, k: int):
    return c[:ax] + (k,) + c[ax + 1:]


def ppermute(blocks: np.ndarray, mesh: Mesh, axis_name: str, perm) -> np.ndarray:
    """``lax.ppermute``: for each (src, dst) pair of indices along
    ``axis_name`` the block at dst receives a copy of the one at src; a
    block that receives nothing is zeros."""
    COLLECTIVES["ppermute"] += 1
    ax = mesh.axis_index(axis_name)
    src_of = {dst: src for src, dst in perm}
    got = fetch(blocks, mesh, [(_along(c, ax, src_of[c[ax]]), c) for c in mesh.all_coords
                               if c[ax] in src_of] if mesh.multiprocess else ())
    out = np.empty(blocks.shape, dtype=object)
    for c in mesh.local_coords:
        dev = mesh.devices[c]
        src = src_of.get(c[ax])
        if src is None:
            out[c] = torch.zeros_like(blocks[c], device=dev)
        elif mesh.is_local(s := _along(c, ax, src)):
            out[c] = _copy_to(_block(blocks, mesh, got, s, c), dev)
        else:
            out[c] = got[s]  # a new tensor, on dev
    return out


def _along_pairs(mesh: Mesh, axes: Sequence[int]):
    """(source, destination) for every destination and every source along
    ``axes`` from it, in row-major order: what an all_gather or psum
    moves."""
    if not mesh.multiprocess:
        return ()
    sizes = [mesh.devices.shape[a] for a in axes]
    pairs = []
    for c in mesh.all_coords:
        for ks in np.ndindex(*sizes):
            src = list(c)
            for a, k in zip(axes, ks):
                src[a] = k
            pairs.append((tuple(src), c))
    return pairs


def all_gather(blocks: np.ndarray, mesh: Mesh, axis_name: str, axis: int = 0,
               tiled: bool = False) -> np.ndarray:
    """``lax.all_gather``: every block receives the blocks along
    ``axis_name`` in index order, stacked on a new ``axis`` (or joined
    along it with ``tiled=True``)."""
    COLLECTIVES["all_gather"] += 1
    ax = mesh.axis_index(axis_name)
    n = mesh.devices.shape[ax]
    got = fetch(blocks, mesh, _along_pairs(mesh, [ax]))
    join = torch.cat if tiled else torch.stack
    out = np.empty(blocks.shape, dtype=object)
    for c in mesh.local_coords:
        dev = mesh.devices[c]
        out[c] = join([_block(blocks, mesh, got, _along(c, ax, k), c).to(dev)
                       for k in range(n)], dim=axis)
    return out


def psum(blocks: np.ndarray, mesh: Mesh, axis_name) -> np.ndarray:
    """``lax.psum``: every block receives the sum of the blocks along
    ``axis_name`` (one mesh axis, or a tuple of them: one collective over
    their product), added in row-major index order on every process, so
    that the sum is the same bit for bit wherever its operands lie.
    uint16/32/64 add as the signed integers of their width, which wrap as
    they do."""
    from ..ops.stencils import wrapping

    COLLECTIVES["psum"] += 1
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    axes = [mesh.axis_index(a) for a in names]
    sizes = [mesh.devices.shape[a] for a in axes]
    got = fetch(blocks, mesh, _along_pairs(mesh, axes))
    out = np.empty(blocks.shape, dtype=object)
    for c in mesh.local_coords:
        dev = mesh.devices[c]
        parts = []
        for ks in np.ndindex(*sizes):
            src = list(c)
            for a, k in zip(axes, ks):
                src[a] = k
            parts.append(wrapping(_block(blocks, mesh, got, tuple(src), c).to(dev)))
        dtype = blocks[c].dtype
        out[c] = functools.reduce(torch.add, parts[1:], parts[0].clone()).view(dtype)
    return out


def shard_map(local: Callable, mesh: Mesh, in_specs: Sequence[PartitionSpec],
              out_specs) -> Callable:
    """The counterpart of ``jax.shard_map``.

    ``shard_map(local, mesh, in_specs, out_specs)(*arrays)`` places each
    array on the mesh by its spec (a ShardedTensor already so placed is
    taken as it is), calls ``local`` once with one object array of the
    process's blocks per operand, and wraps the object array(s) it returns as
    ShardedTensors of ``out_specs`` (one PartitionSpec, or a tuple of
    them for a tuple of outputs)."""
    single = isinstance(out_specs, PartitionSpec)

    def run(*arrays):
        if len(arrays) != len(in_specs):
            raise ValueError(f"{len(arrays)} operands for {len(in_specs)} in_specs")
        placed = [to_sharded(a, mesh, spec) for a, spec in zip(arrays, in_specs)]
        # (block length, global length) of the padded dims, by mesh axis:
        # an output dim of that block length on that axis keeps the padding
        padded = {ax: (b, n) for p in placed if p.padded
                  for ax, b, n in zip(p.spec, first_local(p.blocks).shape, p.shape)
                  if ax is not None and n % mesh.shape[ax]}
        out = local(*(p.blocks for p in placed))

        def wrap(o, spec):
            shape = []
            for n, ax in zip(first_local(o).shape, spec):
                if ax is None:
                    shape.append(n)
                elif ax in padded and padded[ax][0] == n:
                    shape.append(padded[ax][1])
                else:
                    shape.append(n * mesh.shape[ax])
            return ShardedTensor(o, mesh, spec, shape=shape)

        if single:
            return wrap(out, out_specs)
        return tuple(wrap(o, s) for o, s in zip(out, out_specs))

    return run
