"""Device meshes, the multi-process runtime, and placing gridded arrays on
them.

The port's distribution model is JAX's.  In one process the model is
single-controller: the process holds a :class:`Mesh`, an array of
``torch.device`` with named axes, and every sharded array is a
:class:`~.sharded_tensor.ShardedTensor` with one block per mesh
coordinate.  A device may appear in a mesh more than once ("logical
shards": four blocks on ``cuda:0``), which is how one card, or the CPU in
the tests (``make_mesh(axes, devices=[torch.device("cpu")] * 8)``), runs
the same programs a mesh of several cards does.  A collective is a copy
between blocks (:mod:`.collectives`).

Across processes the model is multi-controller, as JAX's runtime is after
``jax.distributed.initialize``: every process runs the same program, calls
:func:`init_distributed` once and builds the same mesh with
:func:`make_multihost_mesh`.  The mesh records which process holds each
coordinate (:attr:`Mesh.process_ids`); a process holds only the blocks at
its own coordinates (``None`` elsewhere), and a collective moves the blocks
that cross a process boundary through ``torch.distributed``.  Every branch
taken before a collective depends only on what all processes share
(shapes, dtypes, specs, the mesh, the boundary conditions), never on block
values, so that every process posts the same collectives.
"""

from __future__ import annotations

import datetime
import os
import socket
import warnings
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.dataarray import GriddedArray, as_tensor
from .sharded_tensor import ShardedTensor, distribute

__all__ = [
    "Mesh",
    "PartitionSpec",
    "init_distributed",
    "make_mesh",
    "make_multihost_mesh",
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
    size.

    ``process_ids`` (an int array of the devices' shape, all 0 by default)
    names the process that holds each coordinate.  A mesh whose
    coordinates all belong to one process is held whole by the process
    that builds it; a mesh over several processes needs
    :func:`init_distributed` first, and each process then holds the
    coordinates of its own rank (:meth:`is_local`, :attr:`local_coords`)."""

    def __init__(self, devices, axis_names: Sequence[str], process_ids=None):
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
        if process_ids is None:
            process_ids = np.zeros(devices.shape, dtype=np.int64)
        self.process_ids = np.asarray(process_ids, dtype=np.int64)
        if self.process_ids.shape != devices.shape:
            raise ValueError(f"process ids {self.process_ids.shape} for devices {devices.shape}")
        self.multiprocess = len(np.unique(self.process_ids)) > 1
        if self.multiprocess and not dist.is_initialized():
            raise RuntimeError("a mesh over several processes needs init_distributed() first")
        # this process's rank, or the one process's of a mesh it holds whole
        self.rank = dist.get_rank() if self.multiprocess else int(self.process_ids.flat[0])
        # every coordinate, and this process's, in row-major order
        self.all_coords = tuple(np.ndindex(devices.shape))
        self.local_coords = tuple(c for c in self.all_coords if self.process_ids[c] == self.rank)
        if not self.local_coords:
            raise ValueError(f"process {self.rank} holds no coordinate of the mesh")
        self.processes = tuple(sorted({int(p) for p in self.process_ids.flat}))

    def first_coord_of(self, process: int):
        """The first coordinate (row-major) that ``process`` holds."""
        return next(c for c in self.all_coords if self.process_ids[c] == process)

    def is_local(self, coord) -> bool:
        """True when this process holds the block at ``coord``."""
        return int(self.process_ids[coord]) == self.rank

    @property
    def local_device(self) -> torch.device:
        """The device of this process's first coordinate."""
        return self.devices[self.local_coords[0]]

    @property
    def shape(self) -> Mapping[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat, other.devices.flat))
                and np.array_equal(self.process_ids, other.process_ids))

    def __hash__(self):
        return hash((self.axis_names, tuple(str(d) for d in self.devices.flat),
                     self.process_ids.tobytes()))

    def axis_index(self, name: str) -> int:
        return self.axis_names.index(name)

    def __repr__(self):
        procs = f", processes={list(self.processes)}" if self.multiprocess else ""
        return (f"Mesh({dict(self.shape)}, devices={sorted({str(d) for d in self.devices.flat})}"
                f"{procs})")


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


# torchrun's variables: what names a multi-process job when no keyword does
_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, backend: str = "nccl",
                     timeout=None) -> bool:
    """Start the multi-process runtime (``torch.distributed``), the
    counterpart of ``xgcm_tpu.parallel.init_distributed``.

    JAX's keywords map onto ``init_process_group``: ``coordinator_address``
    ("host:port", or a URL such as ``file:///path``) is the ``init_method``
    (``tcp://host:port``), ``num_processes`` the world size, ``process_id``
    the rank.  Without a coordinator the torchrun environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``) names the job, a keyword given standing in for its
    variable, so under ``torchrun`` ``init_distributed()`` is the whole
    setup.

    Returns True when this call started the runtime, False when it already
    was started or when nothing names a coordinator (a single process, for
    which the runtime is unnecessary).  A coordinator without a process id
    or a process count is a misconfiguration and raises before any
    connection is tried.  A no-keyword call in an environment that names a
    multi-process job it cannot start (``WORLD_SIZE`` > 1 without its
    coordinator or rank) warns ``RuntimeWarning`` and returns False: this
    process then runs alone.  Errors of the start itself propagate.

    ``backend`` "nccl" (the default) makes the process's card,
    ``cuda:(LOCAL_RANK % device_count)``, current, and raises when there is
    no CUDA card; "gloo" runs on the CPU, and stages CUDA blocks through
    host memory.  ``timeout`` (seconds or a ``timedelta``) bounds every
    collective; a process whose peer posts no matching one fails after it
    instead of waiting for ever."""
    if dist.is_initialized():
        return False
    env = {k: os.environ.get(k) for k in _TORCHRUN_VARS}
    if coordinator_address is not None:
        if process_id is None or num_processes is None:
            raise ValueError(
                f"coordinator_address {coordinator_address!r} needs num_processes and "
                "process_id as well: a coordinator alone does not say which process this is")
        address, world, rank = coordinator_address, int(num_processes), int(process_id)
    else:
        # torchrun's variables stand in for the keywords not given
        world = int(num_processes if num_processes is not None else env["WORLD_SIZE"] or 0)
        rank = process_id if process_id is not None else env["RANK"]
        if not (env["MASTER_ADDR"] and env["MASTER_PORT"] and rank is not None and world):
            if num_processes is None and process_id is None and world > 1:
                missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK") if not env[k]]
                warnings.warn(
                    f"init_distributed(): WORLD_SIZE={world} names a multi-process job, but "
                    f"{', '.join(missing)} are not set, so the runtime could NOT be started; "
                    "this process runs alone. Launch with torchrun, or pass "
                    "coordinator_address, num_processes and process_id.",
                    RuntimeWarning,
                )
            return False
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        rank = int(rank)
    if "://" not in address:
        address = f"tcp://{address}"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(backend='nccl') needs a CUDA card, and "
                               "torch.cuda.is_available() is false; pass backend='gloo' to run "
                               "the processes on the CPU")
        local_rank = int(env["LOCAL_RANK"]) if env["LOCAL_RANK"] else rank
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = (timeout if isinstance(timeout, datetime.timedelta)
                             else datetime.timedelta(seconds=timeout))
    dist.init_process_group(backend, init_method=address, world_size=world, rank=rank,
                            **kwargs)
    return True


def _process_devices(devices) -> list:
    """(device, rank) for every device of the job in (host, rank, local
    device) order: this process's ``devices`` (its current card by
    default) gathered from every process.  Two NCCL ranks on one card
    raise."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_multihost_mesh() without devices takes the CUDA cards, and "
                               "torch.cuda.is_available() is false")
        devices = ([torch.device("cuda", torch.cuda.current_device())] if dist.is_initialized()
                   else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    local = [_indexed(torch.device(d)) for d in devices]
    if not dist.is_initialized():
        return [(d, 0) for d in local]
    entries = [None] * dist.get_world_size()
    dist.all_gather_object(entries, (socket.gethostname(), dist.get_rank(),
                                     [str(d) for d in local]))
    first_rank = {}
    for host, rank, _ in entries:
        first_rank[host] = min(first_rank.get(host, rank), rank)
    entries.sort(key=lambda e: (first_rank[e[0]], e[1]))
    if dist.get_backend() == "nccl":
        holder = {}
        for host, rank, devs in entries:
            for d in devs:
                if torch.device(d).type == "cuda" and holder.setdefault((host, d), rank) != rank:
                    raise ValueError(
                        f"ranks {holder[(host, d)]} and {rank} both hold {d} on {host}: NCCL "
                        "takes one rank a card; start the processes with "
                        "init_distributed(backend='gloo') to share a card")
    return [(torch.device(d), rank) for _, rank, devs in entries for d in devs]


def make_multihost_mesh(axes: Mapping[str, int], devices=None,
                        dcn_axes: Optional[Mapping[str, int]] = None) -> Mesh:
    """A Mesh over every process's devices, the counterpart of
    ``xgcm_tpu.parallel.make_multihost_mesh``.

    Each process passes its own ``devices`` (by default its current CUDA
    card after :func:`init_distributed`, or every visible card in a single
    process; with no CUDA card and no ``devices`` it raises, never falling
    back to the CPU); the mesh spans their gather in (host, rank, local
    device) order, so coordinates that are neighbours along the inner axes
    share a process and a host, and must span exactly that many devices.
    Every process gets the same mesh and holds its own coordinates.

    ``dcn_axes`` maps mesh axes to a number of slices, groups of hosts
    joined by the data-centre network where the hosts' cards are joined by
    NVLink: those axes go outermost, and each slice, a contiguous group of
    the ordered devices, fills the inner (within-slice) part of the mesh.
    Keep the halo-exchange axes inside a slice."""
    flat = _process_devices(devices)
    size = int(np.prod(list(axes.values())))
    if dcn_axes:
        unknown = set(dcn_axes) - set(axes)
        if unknown:
            raise ValueError(f"dcn_axes {sorted(unknown)} are not mesh axes ({sorted(axes)})")
        for a, n_slices in dcn_axes.items():
            if axes[a] % n_slices:
                raise ValueError(
                    f"dcn axis {a!r}: size {axes[a]} does not divide into {n_slices} slices")
    if size != len(flat):
        raise ValueError(
            f"mesh {dict(axes)} needs exactly the global device count ({len(flat)}); got "
            f"{size} — make_multihost_mesh spans every device (use make_mesh for partial "
            "meshes)")
    ids = np.arange(size)
    if dcn_axes:
        names = list(dcn_axes) + [a for a in axes if a not in dcn_axes]
        dcn = [dcn_axes.get(a, 1) for a in names]
        ici = [axes[a] // d for a, d in zip(names, dcn)]
        # (dcn..., ici...) -> (dcn_0, ici_0, dcn_1, ici_1, ...) -> the mesh
        k = len(names)
        ids = ids.reshape(dcn + ici).transpose([i for j in range(k) for i in (j, k + j)])
        ids = ids.reshape([d * i for d, i in zip(dcn, ici)])
    else:
        names = list(axes)
        ids = ids.reshape(tuple(axes.values()))
    grid = np.empty(ids.shape, dtype=object)
    procs = np.empty(ids.shape, dtype=np.int64)
    for c in np.ndindex(ids.shape):
        grid[c], procs[c] = flat[ids[c]]
    return Mesh(grid, tuple(names), process_ids=procs)


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


def to_sharded(data, mesh: Mesh, spec: Sequence, padded: Sequence[int] = ()) -> ShardedTensor:
    """``data`` as a ShardedTensor of ``spec`` on ``mesh``: kept as it is
    when it already is one, re-split (one assembly) when its mesh or spec
    differ, split when it is a plain tensor or host data (host data goes
    straight to each block's device).  ``padded`` lists the dims that may
    take the padded layout where their mesh axis does not divide them (see
    :mod:`.sharded_tensor`)."""
    spec = tuple(spec)
    if isinstance(data, ShardedTensor):
        if data.mesh == mesh and tuple(data.spec) == spec:
            return data
        data = data.full_tensor()
    elif not isinstance(data, torch.Tensor):
        data = as_tensor(data, mesh.local_device)
    return distribute(data, mesh, spec, padded=padded)


def shard_gridded(
    garr: GriddedArray,
    mesh: Mesh,
    dim_to_mesh_axis: Mapping[str, str],
    uneven_ok: tuple = (),
    pad: tuple = (),
) -> GriddedArray:
    """Place a GriddedArray onto the mesh, sharding the named dims.

    Dims whose size does not divide their mesh axis stay replicated and
    WARN — silent replication would hide a misconfigured mesh.  Name dims
    where uneven replication is intended in ``uneven_ok`` to suppress the
    warning.  Dims named in ``pad`` are sharded all the same, in the padded
    layout (:class:`~.sharded_tensor.ShardedTensor`): ``ShardedGrid.shard``
    places the face dim of a face-connected grid so."""
    import warnings

    sizes = mesh.shape
    mapping = {}
    for d, ax in dim_to_mesh_axis.items():
        if ax is None or d not in garr.dims:
            continue
        if garr.sizes[d] % sizes[ax] == 0:
            mapping[d] = ax
        elif d in pad:
            mapping[d] = ax
        elif d not in uneven_ok:
            warnings.warn(
                f"dim {d!r} (size {garr.sizes[d]}) does not divide mesh "
                f"axis {ax!r} (size {sizes[ax]}); replicating instead of "
                f"sharding (pass uneven_ok=({d!r},) if intended)",
                UserWarning,
            )
    spec = partition_spec(garr.dims, mapping)
    padded = [i for i, d in enumerate(garr.dims) if d in pad]
    return GriddedArray(to_sharded(garr.data, mesh, spec, padded=padded), garr.dims,
                        name=garr.name, attrs=garr.attrs)


def replicate(garr: GriddedArray, mesh: Mesh) -> GriddedArray:
    """Fully replicate a GriddedArray over the mesh: a copy on every
    coordinate."""
    spec = PartitionSpec(*([None] * garr.ndim))
    return GriddedArray(to_sharded(garr.data, mesh, spec), garr.dims, name=garr.name,
                        attrs=garr.attrs)
