"""The sharded array: one ``torch.Tensor`` made of blocks on a mesh.

:class:`ShardedTensor` is a wrapper subclass (``_make_wrapper_subclass``
and ``__torch_dispatch__``, the pattern of PyTorch's own ``DTensor``) that
holds no storage of its own.  It keeps

* the global shape and dtype, as any tensor does;
* the mesh and a spec, one mesh-axis name or ``None`` per dim;
* one block per mesh coordinate, on that coordinate's device: a dim mapped
  to a mesh axis is split evenly along it, and a mesh axis that maps no dim
  holds copies.  Blocks are distinct tensors, never views of one another.
  On a mesh over several processes a process holds the blocks of its own
  coordinates and ``None`` at the others'.

It is a tensor so that a :class:`~xgcm_tpu_torch.GriddedArray` keeps it as
its data: ``as_tensor`` leaves a tensor as it is, where anything else would
go through ``np.asarray`` to the host.  Aten ops on it run as follows:

* pointwise ops (``torch.Tag.pointwise``) and the view ops that keep the
  sharded dims (permute, transpose, unsqueeze, squeeze, reshapes that only
  add or drop dims of size 1, expand, slices and selects of other dims,
  flips, detach, clone, dtype casts) run block by block; a plain operand is
  sliced to each block along the sharded dims, a sharded one replicated
  along a dim is sliced likewise;
* any other op assembles the global tensor on the process's first device
  (the blocks of other processes come through the transport of
  :mod:`.collectives`), runs there, and gives back a result sharded by its
  input's spec where its dims allow (else a plain tensor on that device):
  the gather a GSPMD partitioner makes around an op it cannot split.  An in-place op writes
  its result back into the blocks.

Every assembly adds one to :data:`ASSEMBLIES`, never a copy to the host by
itself: ``np.asarray``, ``.cpu()``, ``.to(device)``, ``.numpy()`` and
:meth:`ShardedTensor.full_tensor` assemble on purpose.  Autograd records
nothing inside ``__torch_dispatch__``; the sharded routes work on blocks
directly, so a gradient flows from the blocks to what they were cut from.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

__all__ = [
    "ASSEMBLIES",
    "ShardedTensor",
    "assembly_count",
    "distribute",
    "first_local",
    "reset_assembly_count",
]

aten = torch.ops.aten

# assemblies of a global tensor from its blocks since the last reset
ASSEMBLIES = {"count": 0}


def assembly_count() -> int:
    return ASSEMBLIES["count"]


def reset_assembly_count() -> None:
    ASSEMBLIES["count"] = 0


def first_local(blocks: np.ndarray):
    """The first block this process holds (row-major): the one that
    stands for every block's shape and dtype."""
    return next(b for b in blocks.flat if b is not None)


def _block_index(spec, mesh, shape, coord) -> Tuple[slice, ...]:
    """The slices of the global tensor that the block at ``coord`` holds."""
    index = []
    for d, ax in enumerate(spec):
        if ax is None:
            index.append(slice(None))
            continue
        n = mesh.shape[ax]
        size = shape[d] // n
        k = coord[mesh.axis_index(ax)]
        index.append(slice(k * size, (k + 1) * size))
    return tuple(index)


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A new contiguous tensor with t's values on ``device``."""
    return t.to(device=device, copy=True, memory_format=torch.contiguous_format)


def distribute(tensor: torch.Tensor, mesh, spec: Sequence[Optional[str]]) -> "ShardedTensor":
    """Split a plain tensor into a :class:`ShardedTensor` of ``spec`` on
    ``mesh``: each block this process holds a new tensor on its
    coordinate's device (a copy, even where the device is the tensor's
    own).  In a multi-process job every process passes the same global
    tensor and cuts its own blocks."""
    spec = tuple(spec)
    if len(spec) != tensor.ndim:
        raise ValueError(f"spec {spec} does not match a {tensor.ndim}-d tensor")
    _check_spec(spec, mesh, tuple(tensor.shape))
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for c in mesh.local_coords:
        blocks[c] = _copy_to(tensor[_block_index(spec, mesh, tensor.shape, c)], mesh.devices[c])
    return ShardedTensor(blocks, mesh, spec)


def _check_spec(spec, mesh, shape) -> None:
    used = [ax for ax in spec if ax is not None]
    if len(set(used)) != len(used):
        raise ValueError(f"a mesh axis shards more than one dim in {spec}")
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        if ax not in mesh.axis_names:
            raise ValueError(f"mesh axis {ax!r} not in mesh {tuple(mesh.axis_names)}")
        if shape[d] % mesh.shape[ax]:
            raise ValueError(
                f"dim {d} (size {shape[d]}) does not divide evenly over mesh axis "
                f"{ax!r} (size {mesh.shape[ax]})"
            )


class ShardedTensor(torch.Tensor):
    """A global tensor held as blocks on a :class:`~.mesh.Mesh` (see the
    module docstring).  Build one with :func:`distribute`, or from blocks
    with ``ShardedTensor(blocks, mesh, spec)``: ``blocks`` an object array
    of the mesh's shape (``None`` at the coordinates of other
    processes)."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def __new__(cls, blocks: np.ndarray, mesh, spec: Sequence[Optional[str]]):
        spec = tuple(spec)
        if blocks.shape != mesh.devices.shape:
            raise ValueError(f"blocks {blocks.shape} do not match the mesh {mesh.devices.shape}")
        first = blocks[mesh.local_coords[0]]
        if len(spec) != first.ndim:
            raise ValueError(f"spec {spec} does not match {first.ndim}-d blocks")
        shape = list(first.shape)
        for d, ax in enumerate(spec):
            if ax is not None:
                shape[d] *= mesh.shape[ax]
        for c in mesh.local_coords:
            b = blocks[c]
            if b.shape != first.shape or b.dtype != first.dtype:
                raise ValueError(f"block {c} is {tuple(b.shape)} {b.dtype}, the first is "
                                 f"{tuple(first.shape)} {first.dtype}")
        r = torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=first.dtype, device=mesh.local_device, requires_grad=False
        )
        r._xt_blocks = blocks
        r._xt_mesh = mesh
        r._xt_spec = spec
        return r

    @property
    def blocks(self) -> np.ndarray:
        """The blocks, an object array of the mesh's shape (``None`` at
        other processes' coordinates)."""
        return self._xt_blocks

    @property
    def mesh(self):
        return self._xt_mesh

    @property
    def spec(self) -> Tuple[Optional[str], ...]:
        return self._xt_spec

    def block_index(self, coord) -> Tuple[slice, ...]:
        """The slices of the global tensor that the block at ``coord``
        holds."""
        return _block_index(self.spec, self.mesh, self.shape, coord)

    def full_tensor(self) -> torch.Tensor:
        """The global tensor on the process's first device (one assembly;
        in a multi-process job every process makes it)."""
        ASSEMBLIES["count"] += 1
        return _assemble(self)

    def __repr__(self, *, tensor_contents=None):
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, spec={self.spec}, "
                f"mesh={dict(self.mesh.shape)}, device={self.device})")

    def cpu(self, memory_format=torch.preserve_format):
        return self.full_tensor().cpu(memory_format=memory_format)

    def to(self, *args, **kwargs):
        """A move to a device assembles (even to the device the blocks are
        on); a dtype cast runs block by block."""
        device = torch._C._nn._parse_to(*args, **kwargs)[0]
        if device is not None:
            return self.full_tensor().to(*args, **kwargs)
        return super().to(*args, **kwargs)

    def numpy(self, *, force=False):
        return self.full_tensor().detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        handler = _VIEW_HANDLERS.get(func)
        if handler is not None:
            out = handler(func, args, kwargs)
            if out is not NotImplemented:
                return out
        elif (torch.Tag.pointwise in func.tags or func in _EXTRA_POINTWISE) \
                and "out" not in kwargs:
            out = _pointwise(func, args, kwargs)
            if out is not NotImplemented:
                return out
        return _gathered(func, args, kwargs)


def _assemble(x: ShardedTensor) -> torch.Tensor:
    """Concatenate the blocks on the process's first device: of the copies
    along replicated mesh axes its own where it holds one, else the first,
    brought from the process that holds it."""
    from .collectives import fetch

    mesh, spec = x.mesh, x.spec
    dev = mesh.local_device
    dim_of = {ax: d for d, ax in enumerate(spec) if ax is not None}
    used = [mesh.axis_index(a) for a in mesh.axis_names if a in dim_of]
    # the copies of each part, by its index along the used axes
    copies = {}
    for c in mesh.all_coords:
        copies.setdefault(tuple(c[i] for i in used), []).append(c)
    source = {k: next((c for c in cs if mesh.is_local(c)), cs[0]) for k, cs in copies.items()}
    # every process needs every part it holds no copy of: (first copy, its
    # first coordinate), in the same order on every process
    needs = [(cs[0], mesh.first_coord_of(p)) for cs in copies.values()
             for p in mesh.processes if p not in {int(mesh.process_ids[c]) for c in cs}]
    got = fetch(x.blocks, mesh, needs)
    parts = np.empty(tuple(mesh.devices.shape[i] for i in used), dtype=object)
    for k, c in source.items():
        parts[k] = (x.blocks[c] if mesh.is_local(c) else got[c]).to(dev)
    if not used:
        # replicated along every mesh axis: one block is the tensor
        return parts[()].to(dev, copy=True)
    for ax in reversed([a for a in mesh.axis_names if a in dim_of]):
        joined = np.empty(parts.shape[:-1], dtype=object)
        for c in np.ndindex(joined.shape):
            joined[c] = torch.cat([parts[c + (k,)] for k in range(parts.shape[-1])], dim=dim_of[ax])
        parts = joined
    return parts[()]


# ---------------------------------------------------------------- pointwise
def _is_inplace(func) -> bool:
    return func._schema.name.endswith("_")


# pointwise ops that carry no pointwise tag
_EXTRA_POINTWISE = {
    aten.where.ScalarSelf, aten.where.ScalarOther, aten.where.Scalar,
    aten.floor_divide.default,
}


def _local_operand(x, coord, out_spec, out_shape, mesh):
    """Operand ``x`` cut to the block of ``coord`` for an op whose result
    has ``out_spec``: a sharded operand's block, sliced along the dims it
    holds whole; a plain tensor sliced along the sharded dims it spans (a
    dim of size 1 broadcasts) and moved to the block's device."""
    if isinstance(x, ShardedTensor):
        t, own = x.blocks[coord], x.spec
    else:
        t, own = x, (None,) * x.ndim
    off = len(out_shape) - t.ndim
    for d, ax in enumerate(out_spec):
        xd = d - off
        if ax is None or xd < 0 or own[xd] is not None or t.shape[xd] == 1:
            continue
        n = mesh.shape[ax]
        size = out_shape[d] // n
        t = t.narrow(xd, coord[mesh.axis_index(ax)] * size, size)
    dev = mesh.devices[coord]
    # a 0-d tensor joins any device's op as a scalar
    return t.to(dev) if t.device != dev and t.ndim else t


def _pointwise(func, args, kwargs):
    if any(str(r.type) != "Tensor" for r in func._schema.returns):
        return NotImplemented  # e.g. aten.equal: a bool of the whole
    flat, tree = tree_flatten((args, kwargs))
    sharded = [x for x in flat if isinstance(x, ShardedTensor)]
    mesh = sharded[0].mesh
    if any(s.mesh != mesh for s in sharded):
        return NotImplemented
    try:
        out_shape = tuple(torch.broadcast_shapes(
            *(tuple(x.shape) for x in flat if isinstance(x, torch.Tensor))))
    except RuntimeError:
        return NotImplemented
    nd = len(out_shape)
    out_spec = [None] * nd
    for s in sharded:
        off = nd - s.ndim
        for d, ax in enumerate(s.spec):
            if ax is None:
                continue
            if s.shape[d] != out_shape[off + d] or out_spec[off + d] not in (None, ax):
                return NotImplemented
            out_spec[off + d] = ax
    used = [ax for ax in out_spec if ax is not None]
    if len(set(used)) != len(used):
        return NotImplemented
    inplace = _is_inplace(func)
    if inplace:
        target = args[0]
        if not isinstance(target, ShardedTensor) or tuple(target.spec) != tuple(out_spec) \
                or tuple(target.shape) != out_shape:
            return NotImplemented
    results = np.empty(mesh.devices.shape, dtype=object)
    for c in mesh.local_coords:
        local = [_local_operand(x, c, out_spec, out_shape, mesh)
                 if isinstance(x, torch.Tensor) else x for x in flat]
        a, k = tree_unflatten(local, tree)
        results[c] = func(*a, **k)
    if inplace:
        return args[0]
    return _wrap_results(results, mesh, tuple(out_spec))


def _wrap_results(results, mesh, spec):
    first = first_local(results)
    if isinstance(first, torch.Tensor):
        return ShardedTensor(results, mesh, spec)
    # a tuple of tensors, one ShardedTensor each
    outs = []
    for i in range(len(first)):
        part = np.empty(results.shape, dtype=object)
        for c in mesh.local_coords:
            part[c] = results[c][i]
        outs.append(ShardedTensor(part, mesh, spec))
    return tuple(outs)


# --------------------------------------------------------------- view ops
def _blockwise(x: ShardedTensor, spec, fn):
    blocks = np.empty(x.blocks.shape, dtype=object)
    for c in x.mesh.local_coords:
        blocks[c] = fn(x.blocks[c])
    return ShardedTensor(blocks, x.mesh, spec)


def _same_spec(func, args, kwargs):
    x = args[0]
    if not isinstance(x, ShardedTensor):
        return NotImplemented
    return _blockwise(x, x.spec, lambda b: func(b, *args[1:], **kwargs))


def _to_copy(func, args, kwargs):
    x = args[0]
    if not isinstance(x, ShardedTensor) or kwargs.get("device") is not None:
        return NotImplemented  # a move off the mesh assembles
    return _blockwise(x, x.spec, lambda b: func(b, *args[1:], **kwargs))


def _permute(func, args, kwargs):
    x, dims = args[0], [d % args[0].ndim for d in args[1]]
    return _blockwise(x, [x.spec[d] for d in dims], lambda b: func(b, dims))


def _transpose(func, args, kwargs):
    x = args[0]
    d0, d1 = (args[1] % x.ndim, args[2] % x.ndim) if len(args) > 1 else (0, 1)
    spec = list(x.spec)
    spec[d0], spec[d1] = spec[d1], spec[d0]
    return _blockwise(x, spec, lambda b: func(b, *args[1:]))


def _unsqueeze(func, args, kwargs):
    x, d = args[0], args[1] % (args[0].ndim + 1)
    spec = list(x.spec)
    spec.insert(d, None)
    return _blockwise(x, spec, lambda b: func(b, d))


def _squeeze(func, args, kwargs):
    x = args[0]
    if len(args) == 1:
        dims = [d for d in range(x.ndim) if x.shape[d] == 1]
    else:
        dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        dims = [d % max(x.ndim, 1) for d in dims if x.shape[d % max(x.ndim, 1)] == 1]
    if any(x.spec[d] is not None and x.mesh.shape[x.spec[d]] != 1 for d in dims):
        return NotImplemented
    spec = [ax for d, ax in enumerate(x.spec) if d not in dims]
    return _blockwise(x, spec, lambda b: b.squeeze(tuple(dims)) if dims else b.view(b.shape))


def _reshape(func, args, kwargs):
    """A reshape that only adds or drops dims of size 1 keeps the sharded
    dims; any other assembles."""
    x, shape = args[0], list(args[1])
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape[shape.index(-1)] = x.numel() // known if known else 0
    old = [(d, s) for d, s in enumerate(x.shape) if s != 1]
    new = [(d, s) for d, s in enumerate(shape) if s != 1]
    if [s for _, s in old] != [s for _, s in new]:
        return NotImplemented
    if any(x.spec[d] is not None and x.mesh.shape[x.spec[d]] != 1
           for d, s in enumerate(x.shape) if s == 1):
        return NotImplemented
    spec = [None] * len(shape)
    local = list(shape)
    for (od, _), (nd, s) in zip(old, new):
        ax = x.spec[od]
        spec[nd] = ax
        if ax is not None:
            local[nd] = s // x.mesh.shape[ax]
    return _blockwise(x, spec, lambda b: b.reshape(local))


def _expand(func, args, kwargs):
    x, size = args[0], list(args[1])
    lead = len(size) - x.ndim
    spec = [None] * lead + list(x.spec)
    local = list(size)
    for d, ax in enumerate(x.spec):
        if ax is None:
            continue
        if size[lead + d] not in (-1, x.shape[d]):
            return NotImplemented
        local[lead + d] = -1
    return _blockwise(x, spec, lambda b: b.expand(local))


def _slice(func, args, kwargs):
    x = args[0]
    dim = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % x.ndim
    if x.spec[dim] is not None:
        start = args[2] if len(args) > 2 else kwargs.get("start")
        end = args[3] if len(args) > 3 else kwargs.get("end")
        step = args[4] if len(args) > 4 else kwargs.get("step", 1)
        whole = (start in (None, 0) and (end is None or end >= x.shape[dim]) and step == 1)
        if not whole:
            return NotImplemented
        return _blockwise(x, x.spec, lambda b: b)
    return _blockwise(x, x.spec, lambda b: func(b, *args[1:], **kwargs))


def _select(func, args, kwargs):
    x, dim = args[0], args[1] % args[0].ndim
    if x.spec[dim] is not None:
        return NotImplemented
    spec = [ax for d, ax in enumerate(x.spec) if d != dim]
    return _blockwise(x, spec, lambda b: func(b, *args[1:]))


def _flip(func, args, kwargs):
    x = args[0]
    dims = [d % x.ndim for d in args[1]]
    if any(x.spec[d] is not None for d in dims):
        return NotImplemented
    return _blockwise(x, x.spec, lambda b: func(b, dims))


_VIEW_HANDLERS = {
    aten.detach.default: _same_spec,
    aten.alias.default: _same_spec,
    aten.clone.default: _same_spec,
    aten._to_copy.default: _to_copy,
    aten.permute.default: _permute,
    aten.transpose.int: _transpose,
    aten.t.default: _transpose,
    aten.unsqueeze.default: _unsqueeze,
    aten.squeeze.default: _squeeze,
    aten.squeeze.dim: _squeeze,
    aten.squeeze.dims: _squeeze,
    aten.view.default: _reshape,
    aten._unsafe_view.default: _reshape,
    aten.expand.default: _expand,
    aten.slice.Tensor: _slice,
    aten.select.int: _select,
    aten.flip.default: _flip,
}


# ------------------------------------------------------------------ gather
def _gathered(func, args, kwargs):
    """Assemble every sharded operand, run ``func`` on the process's first
    device, and shard the result by the first sharded operand's spec where
    its shape allows.  An in-place op on a sharded tensor is written back
    into its blocks."""
    flat, tree = tree_flatten((args, kwargs))
    ref = next(x for x in flat if isinstance(x, ShardedTensor))
    full = {id(x): x.full_tensor() for x in flat if isinstance(x, ShardedTensor)}
    local = [full[id(x)] if isinstance(x, ShardedTensor) else x for x in flat]
    a, k = tree_unflatten(local, tree)
    out = func(*a, **k)
    target = args[0] if args and isinstance(args[0], ShardedTensor) else None
    if target is not None and _is_inplace(func):
        whole = full[id(target)]
        for c in target.mesh.local_coords:
            target.blocks[c].copy_(whole[_block_index(target.spec, target.mesh, target.shape, c)])
        return target

    if "out" in kwargs:
        return out

    def reshard(t):
        # a result moved off the mesh's device (.cpu()) stays where it went
        if not isinstance(t, torch.Tensor) or t.ndim != ref.ndim or t.device != ref.device:
            return t
        if any(ax is not None and t.shape[d] != ref.shape[d] for d, ax in enumerate(ref.spec)):
            return t
        return distribute(t, ref.mesh, ref.spec)

    return tree_map(reshard, out)
