"""The sharded layer.  In one process a :class:`Mesh` of ``torch.device``
(a device may repeat: logical shards on one card) holds every sharded
array as a :class:`ShardedTensor` of blocks, and a collective is a copy
between blocks (:mod:`.collectives`).  Across processes
(:func:`init_distributed`, :func:`make_multihost_mesh`) every process runs
the same program on the blocks of its own coordinates, and the blocks that
cross a process boundary go through ``torch.distributed``.
:func:`sharded_apply_many` runs a batch of grid ufuncs with one halo
exchange per distinct input."""

from .apply_many import sharded_apply_many  # noqa: F401
from .collectives import all_gather, ppermute, psum, shard_map  # noqa: F401
from .diagnostics import sharded_cgrid_diagnostics  # noqa: F401
from .face_sharded import (  # noqa: F401
    FaceAxisRoles,
    FaceHaloPlan,
    compile_face_plan,
    face_axis_roles,
    face_halo_pad_widths,
    sharded_face_cumsum,
    sharded_face_op,
)
from .halo import ring_halo_pad, sharded_cumsum, sharded_op  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    PartitionSpec,
    init_distributed,
    make_mesh,
    make_multihost_mesh,
    partition_spec,
    replicate,
    shard_gridded,
)
from .sharded_grid import ShardedGrid  # noqa: F401
from .sharded_tensor import ShardedTensor, assembly_count, reset_assembly_count  # noqa: F401
from .sharded_ufunc import sharded_apply_as_grid_ufunc  # noqa: F401
