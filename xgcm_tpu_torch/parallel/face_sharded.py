"""Face-sharded topology: cross-face halo exchange between blocks.

The counterpart of :mod:`xgcm_tpu.parallel.face_sharded`.  The face dim of
a face-connected grid is split over one mesh axis (a contiguous block of
``fpd`` faces a shard, with unconnected dummy faces when the face count
does not divide the axis, so the 13-face LLC runs on 4 shards), optionally
with the within-face rows over a second mesh axis and the columns over a
third: the face x y x x decomposition.  The dummy faces are the padding of
:class:`~.sharded_tensor.ShardedTensor`'s padded layout: an input placed by
``ShardedGrid.shard`` is read block by block as it is, and every result
keeps that layout (13 faces in its shape, the dummy faces never shown), so
a chain of ops and the arithmetic between their results assemble nothing.
Each op step:

1. every shard cuts its segments of the four edge strips of each of its
   faces (X-left, X-right, Y-left, Y-right, each ``(w, L)``, offsets
   increasing inward, tangential in increasing coordinate), placed at its
   tangential offset; a ``psum`` over the interior mesh axes completes each
   face's strips and one ``all_gather`` over the face axis builds the
   face-global strip pool;
2. every block is pre-padded with the basic boundary condition: the
   within-face halos of a sharded in-face dim ride the ring
   (:func:`~.halo.ring_halo_pad` with the face as the global domain), the
   rest is a local pad;
3. each shard overwrites the connected-edge halo segments it owns from the
   compiled plan (:func:`compile_face_plan`): source face and side,
   tangential flip, and the sign rules of a vector component.

Every process reads the plan on the host, and each edge of the blocks it
holds is a plain slice chosen in Python; a block's edge columns are plain
strided slices (no lane window, which was a TPU layout workaround).

The built-in ops (diff/interp/min/max) read a halo one wide on one side.
On the dtypes kernel E takes and the basic boundary conditions, the route
builds each block's one halo line per face by the single-device fused
path's rule (:func:`~xgcm_tpu_torch.core.topology.face_halo_lines` on the
Grid's device plan, its rows the block's faces): from the strip pool where
the block edge is a face edge, and from the ring neighbour or the local
boundary condition elsewhere.  It launches E once per block
(:func:`~xgcm_tpu_torch.ops.kernels.face_shift.face_shift`): one read and
one write of the block.  It makes the collectives of the JAX program (the
pool, and the ring exchange of both in-face axes that JAX's uniform
pre-pad does), so ``utils.count_collectives`` counts the same budget.
Wider halos, custom ufuncs, corners and other dtypes take
:func:`face_halo_pad_widths` and the sharded engine, as JAX's route does.

The slice/flip/sign rules reproduce ``core/padding._pad_face_connections``
at any halo width, corner cells included:

* halo at outward offset k = source strip at inward offset k, the source
  side being the right edge iff ``connection.reverse == is_right_edge``;
* the tangential direction flips iff the connection swaps axes and is not
  reversed;
* vector sign: the component parallel to the padded axis is negated on
  reverse, the other one on swap-without-reverse.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.dataarray import GriddedArray
from ..core.grid import Grid
from ..core.padding import BOUNDARY_TO_PAD_MODE, _pad_axis
from ..core.topology import FaceHaloPlan, basic_edge_line, compile_face_plan, face_halo_lines
from ..ops.kernels.face_shift import face_shift
from ..ops.stencils import cumsum, wrapping
from ..utils.profiling import span
from .collectives import all_gather, coords, first_local, map_blocks, psum
from .halo import _SHARDABLE_WIDTHS, ring_halos, ring_kernel_ok
from .mesh import Mesh, partition_spec, to_sharded
from .sharded_tensor import ShardedTensor

__all__ = [
    "FaceHaloPlan",
    "FaceAxisRoles",
    "compile_face_plan",
    "face_axis_roles",
    "face_halo_pad_widths",
    "sharded_face_op",
    "sharded_face_cumsum",
]

# side codes: 0 = X-left, 1 = X-right, 2 = Y-left, 3 = Y-right


class FaceAxisRoles(NamedTuple):
    """Resolved axis roles for a face decomposition: which grid axis plays
    x (side codes 0/1) and which y (2/3), and which mesh axes (if any)
    shard the face dim and each in-face axis."""

    face_mesh_axis: str
    x_axis: str
    y_axis: str
    interior_mesh_axis: Optional[str]  # mesh axis sharding the y (rows) role
    interior_mesh_axis_x: Optional[str]  # mesh axis sharding the x role


def face_axis_roles(grid: Grid, dim_to_mesh_axis, data_dims, *, strict: bool = True):
    """The face/interior axis roles, shared by the sharded engine's
    :class:`FaceSetup` (``strict=True``: inference failures raise) and the
    ``ShardedGrid`` dispatch (``strict=False``: they return None, so
    dispatch takes another route).  A grid axis whose dims map to several
    mesh axes raises in both modes.

    When one in-face axis is mesh-mapped it takes the y (rows) role, the
    face x interior 2-D decomposition; when both are, the face x y x x
    decomposition applies with the connection table's first axis as x."""
    facedim = grid._facedim
    face_mesh_axis = dim_to_mesh_axis.get(facedim)
    if face_mesh_axis is None:
        if strict:
            raise NotImplementedError(
                "sharded grid ufuncs on a face-connected grid need the face "
                f"dim {facedim!r} mapped to a mesh axis (interior-only "
                "decomposition of face grids is not supported)"
            )
        return None
    conn_axes = sorted({a for links in grid._face_connections[facedim].values() for a in links})
    if len(conn_axes) == 1:
        # ring topologies connect along one axis only; the other in-face
        # axis is whichever remaining grid axis the data spans
        others = [
            n for n, ax in grid.axes.items()
            if n != conn_axes[0] and any(d in data_dims for d in ax.coords.values())
        ]
        if len(others) != 1:
            if strict:
                raise NotImplementedError(
                    "cannot infer the second in-face axis for a single-axis "
                    f"face connection (candidates: {others})"
                )
            return None
        conn_axes = [conn_axes[0], others[0]]
    elif len(conn_axes) != 2:
        if strict:
            raise NotImplementedError(
                f"face-connected grids with {len(conn_axes)} connection axes are "
                "not supported (need exactly 2)"
            )
        return None

    def axis_mesh(axname):
        s = {dim_to_mesh_axis.get(d) for d in grid.axes[axname].coords.values()} - {None}
        if len(s) > 1:
            raise ValueError(f"dims of axis {axname!r} map to multiple mesh axes")
        return s.pop() if s else None

    m0, m1 = axis_mesh(conn_axes[0]), axis_mesh(conn_axes[1])
    if m0 is not None and m1 is not None:
        return FaceAxisRoles(face_mesh_axis, conn_axes[0], conn_axes[1], m1, m0)
    if m0 is not None:
        return FaceAxisRoles(face_mesh_axis, conn_axes[1], conn_axes[0], m0, None)
    return FaceAxisRoles(face_mesh_axis, conn_axes[0], conn_axes[1], m1, None)


class FaceSetup:
    """The static face decomposition of one sharded application: axis
    roles, faces per shard, and the plan padded with dummy faces to
    ``fpd * mesh.shape[face axis]`` (JAX's ``sharded_ufunc._FaceSetup``).
    :meth:`infer` finds the roles from the dim mapping."""

    @classmethod
    def infer(cls, grid: Grid, mesh: Mesh, dim_to_mesh_axis, first_arg_dims=()) -> "FaceSetup":
        """The setup for ``dim_to_mesh_axis``; ``first_arg_dims`` names the
        second in-face axis when the connection table names only one (ring
        topologies).  Axis-swapping connections need square faces."""
        setup = cls(grid, mesh, face_axis_roles(grid, dim_to_mesh_axis, first_arg_dims))
        if np.any(setup.plan.swap):
            ny = grid._ds.dims[next(iter(grid.axes[setup.y_axis].coords.values()))]
            nx = grid._ds.dims[next(iter(grid.axes[setup.x_axis].coords.values()))]
            if ny != nx:
                raise ValueError("cross-axis face connections require square faces")
        return setup

    def __init__(self, grid: Grid, mesh: Mesh, roles: FaceAxisRoles):
        self.grid, self.mesh = grid, mesh
        self.x_axis, self.y_axis = roles.x_axis, roles.y_axis
        self.face_mesh_axis = roles.face_mesh_axis
        self.interior_mesh_axis = roles.interior_mesh_axis
        self.interior_mesh_axis_x = roles.interior_mesh_axis_x
        self.facedim = grid._facedim
        self.n_faces = grid._ds.dims[self.facedim]
        self.fpd = -(-self.n_faces // mesh.shape[self.face_mesh_axis])
        self.n_padded = self.fpd * mesh.shape[self.face_mesh_axis]
        self.plan = compile_face_plan(grid, self.x_axis, self.y_axis,
                                      n_faces_total=self.n_padded)

    def arranged(self, da: GriddedArray) -> GriddedArray:
        """``da`` with its dims in the (..., face, y, x) layout."""
        ydim = self.grid.axes[self.y_axis]._get_position_name(da)[1]
        xdim = self.grid.axes[self.x_axis]._get_position_name(da)[1]
        rest = [d for d in da.dims if d not in (self.facedim, ydim, xdim)]
        return da.transpose(*rest, self.facedim, ydim, xdim)

    def blocks(self, da: GriddedArray, spec) -> np.ndarray:
        """The blocks of ``da`` on the mesh by ``spec``, its face dim
        rounded up to ``n_padded`` with dummy faces: the padded layout of
        :class:`~.sharded_tensor.ShardedTensor`.  An input already placed so
        (``ShardedGrid.shard``, or a result of this route) gives its blocks
        as they are; anything else is placed once, the dummy faces zeros."""
        padded = [da.get_axis_num(self.facedim)] if self.facedim in da.dims else []
        return to_sharded(da.data, self.mesh, spec, padded=padded).blocks

    def result(self, blocks: np.ndarray, dims, spec) -> ShardedTensor:
        """The data of a result from its output blocks: a ShardedTensor of
        the real faces, its dummy faces kept as the padding of the last
        blocks (no assembly)."""
        shape = [n * (1 if ax is None else self.mesh.shape[ax])
                 for n, ax in zip(first_local(blocks).shape, spec)]
        if self.facedim in dims:
            shape[list(dims).index(self.facedim)] = self.n_faces
        return ShardedTensor(blocks, self.mesh, spec, shape=shape)


class _Layout(NamedTuple):
    """Where a block sits in the face x y x x decomposition."""

    mesh: Mesh
    face_axis: str
    row_axis: Optional[str]
    col_axis: Optional[str]
    fpd: int
    ny_loc: int
    nx_loc: int

    @property
    def P(self) -> int:
        return 1 if self.row_axis is None else self.mesh.shape[self.row_axis]

    @property
    def Q(self) -> int:
        return 1 if self.col_axis is None else self.mesh.shape[self.col_axis]

    @property
    def ny(self) -> int:
        return self.ny_loc * self.P

    @property
    def nx(self) -> int:
        return self.nx_loc * self.Q

    def face0(self, c) -> int:
        """Global index of the block's first face."""
        return c[self.mesh.axis_index(self.face_axis)] * self.fpd

    def p(self, c) -> int:
        return 0 if self.row_axis is None else c[self.mesh.axis_index(self.row_axis)]

    def q(self, c) -> int:
        return 0 if self.col_axis is None else c[self.mesh.axis_index(self.col_axis)]


def _layout(blocks, mesh, face_mesh_axis, interior_mesh_axis, interior_mesh_axis_x) -> _Layout:
    fpd, ny_loc, nx_loc = first_local(blocks).shape[-3:]
    return _Layout(mesh, face_mesh_axis, interior_mesh_axis, interior_mesh_axis_x,
                   fpd, ny_loc, nx_loc)


@span("xtt.sharded.strip_pool")
def _strip_pool(blocks: np.ndarray, lay: _Layout, w: int) -> np.ndarray:
    """The face-global (..., F, 4, w, L) strip pool on every shard: each
    shard's segments of its faces' four edge strips at their tangential
    offsets (zeros where it owns none), completed by one psum over the
    interior mesh axes and pooled by one all_gather over the face axis."""
    L = max(lay.ny, lay.nx)

    def local(b, c):
        dtype = b.dtype
        b = wrapping(b)  # uint16/32/64 flip as the signed ints of their width
        p, q = lay.p(c), lay.q(c)
        stack = b.new_zeros(b.shape[:-2] + (4, w, L))
        ys, xs = slice(p * lay.ny_loc, (p + 1) * lay.ny_loc), slice(q * lay.nx_loc,
                                                                    (q + 1) * lay.nx_loc)
        if q == 0:
            stack[..., 0, :, ys] = b[..., :, :w].transpose(-1, -2)
        if q == lay.Q - 1:
            stack[..., 1, :, ys] = b[..., :, lay.nx_loc - w:].flip(-1).transpose(-1, -2)
        if p == 0:
            stack[..., 2, :, xs] = b[..., :w, :]
        if p == lay.P - 1:
            stack[..., 3, :, xs] = b[..., lay.ny_loc - w:, :].flip(-2)
        return stack.view(dtype)

    stacks = np.empty(blocks.shape, dtype=object)
    for c in coords(lay.mesh):
        stacks[c] = local(blocks[c], c)  # the block's coordinate places its strips
    interior = tuple(a for a in (lay.row_axis, lay.col_axis) if a is not None)
    if interior:
        stacks = psum(stacks, lay.mesh, interior)
    # tiled along the faces-per-shard dim: global face = shard * fpd + local
    return all_gather(stacks, lay.mesh, lay.face_axis, axis=-4, tiled=True)


class _Halos:
    """The connected-edge halo strips of one face application: the plan
    read on the host, the strips cut from the pools."""

    def __init__(self, plan: FaceHaloPlan, lay: _Layout, w: int, bc: Dict[str, Tuple[str, float]],
                 vector_axis_code: Optional[int]):
        self.plan, self.lay, self.w, self.bc = plan, lay, w, bc
        self.vector_axis_code = vector_axis_code
        self._extended = {}

    def _extended_pool(self, pool: torch.Tensor, L_t: int, along_x: bool) -> torch.Tensor:
        """The strips of ``pool``'s x edges (sides 0, 1) or y edges (2, 3)
        cut to ``L_t`` and extended tangentially by ``w`` on both sides,
        every face at once: (..., F, 2, w, L_t + 2w).  The extension takes
        the basic BC of the source side's tangential axis."""
        key = (id(pool), L_t, along_x)
        if key not in self._extended:
            part = pool[..., :, 2:4, :, :L_t] if along_x else pool[..., :, 0:2, :, :L_t]
            mode, fv = self.bc["x" if along_x else "y"]
            # the pool rides along so that its id stays its own
            self._extended[key] = (pool, _pad_axis(part, part.ndim - 1, (self.w, self.w), mode,
                                                   fv))
        return self._extended[key][1]

    def strip(self, pool_self, pool_partner, g: int, side: int):
        """The canonical (..., w, L_t + 2w) halo strip of global face g's
        side: inward-offset rows, tangential from -w to L_t + w."""
        plan = self.plan
        sf, ss = int(plan.src_face[g, side]), int(plan.src_side[g, side])
        pool = pool_partner if pool_partner is not None and plan.swap[g, side] else pool_self
        L_t = self.lay.ny if side < 2 else self.lay.nx
        strip = self._extended_pool(pool, L_t, ss >= 2)[..., sf, ss % 2, :, :]
        dtype = strip.dtype
        if plan.tang_flip[g, side]:
            strip = wrapping(strip).flip(-1).view(dtype)
        if self.vector_axis_code is not None:
            sign = plan.sign_ortho if self.vector_axis_code == side // 2 else plan.sign_tang
            if sign[g, side] < 0:
                strip = torch.neg(wrapping(strip)).view(dtype)
        return strip


def _pad_lines(src: torch.Tensor, axis: int, w: int, mode: str, fv: float):
    """(before, after): the ``w``-wide local pads of ``src`` along
    ``axis`` in ``mode``, as :func:`~xgcm_tpu_torch.core.padding._pad_axis`
    gives them, computed from the edge lines they depend on (views of
    ``src`` for a wrap no wider than the axis)."""
    n = src.shape[axis]
    if mode == "constant":
        shape = list(src.shape)
        shape[axis] = w
        line = torch.full(shape, fv, dtype=src.dtype, device=src.device)
        return line, line
    if mode == "wrap" and w <= n:
        return src.narrow(axis, n - w, w), src.narrow(axis, 0, w)
    if mode == "wrap":
        padded = _pad_axis(src, axis, (w, w), mode, fv)
        return padded.narrow(axis, 0, w), padded.narrow(axis, w + n, w)
    k = min(2, n)
    before = _pad_axis(src.narrow(axis, 0, k), axis, (w, 0), mode, fv).narrow(axis, 0, w)
    after = _pad_axis(src.narrow(axis, n - k, k), axis, (0, w), mode, fv).narrow(axis, k, w)
    return before, after


def _prepad(blocks: np.ndarray, w: int, mesh: Mesh, steps) -> np.ndarray:
    """Every (..., ny, nx) block padded ``w`` wide on both sides of its last
    two axes into one new tensor, one axis after the other as ``steps``
    (axis, mesh axis or None, boundary, fill value) order them: the
    second axis's pad reads the first's, corners included, as two
    successive pads would.  A mesh-mapped axis takes ring halos, a local
    one its boundary condition.  The values equal two successive
    :func:`~.halo.pad_axis_local_or_ring` calls; the block is copied once
    where those concatenate twice."""
    ny, nx = first_local(blocks).shape[-2:]
    out = np.empty(blocks.shape, dtype=object)
    for c in coords(mesh):
        b = blocks[c]
        o = b.new_empty(b.shape[:-2] + (ny + 2 * w, nx + 2 * w))
        wrapping(o)[..., w:w + ny, w:w + nx] = wrapping(b)
        out[c] = o
    extent = {-2: (w, ny), -1: (w, nx)}  # (start, length) of each axis's filled part
    for axis, mesh_axis, boundary, fv in steps:
        other = -1 if axis == -2 else -2
        start, n = extent[axis]
        o0, on = extent[other]
        src = map_blocks(lambda o: o.narrow(axis, start, n).narrow(other, o0, on), out,
                         mesh=mesh)
        if mesh_axis is not None:
            before, after = ring_halos(src, axis, (w, w), mesh, mesh_axis, boundary, fv)
        else:
            mode = BOUNDARY_TO_PAD_MODE[boundary]
            lines = map_blocks(lambda b: _pad_lines(b, axis, w, mode,
                                                    fv if mode == "constant" else 0.0),
                               src, mesh=mesh)
            before = map_blocks(lambda t: t[0], lines, mesh=mesh)
            after = map_blocks(lambda t: t[1], lines, mesh=mesh)
        for c in coords(mesh):
            o = out[c]
            for pos, halo in ((0, before[c]), (start + n, after[c])):
                wrapping(o).narrow(axis, pos, w).narrow(other, o0, on).copy_(wrapping(halo))
        extent[axis] = (0, n + 2 * w)
    return out


def _bc(boundary, fill_value) -> Tuple[str, float]:
    mode = BOUNDARY_TO_PAD_MODE[boundary]
    return mode, (float(fill_value) if mode == "constant" else 0.0)


def face_halo_pad_widths(
    blocks: np.ndarray,
    mesh: Mesh,
    plan: FaceHaloPlan,
    widths_x: Tuple[int, int],
    widths_y: Tuple[int, int],
    face_mesh_axis: str,
    boundary_x: Optional[str],
    boundary_y: Optional[str],
    fill_value_x: float,
    fill_value_y: float,
    x_name: str,
    y_name: str,
    interior_mesh_axis: Optional[str] = None,
    partner_blocks: Optional[np.ndarray] = None,
    vector_axis_code: Optional[int] = None,
    interior_mesh_axis_x: Optional[str] = None,
) -> np.ndarray:
    """Pad every (..., fpd, ny_loc, nx_loc) block of local faces with
    cross-face halos at per-axis widths, as an object array of padded
    blocks.

    ``blocks`` holds ``fpd`` contiguous faces a shard along
    ``face_mesh_axis``, each face's rows split along
    ``interior_mesh_axis`` and its columns along ``interior_mesh_axis_x``
    when given.  ``plan`` covers every global face, dummy ones included.
    ``vector_axis_code`` is 0 for the x-axis component of a vector, 1 for
    the y-axis one (its partner's blocks in ``partner_blocks``), None for
    scalars.  ``x_name``/``y_name`` are the grid-axis names: they fix the
    replacement and mixed-mode pre-pad order, which the single-device
    assembly runs in sorted-name order.  The result equals
    ``core.padding._pad_face_connections`` on every cell, corners included,
    at any widths up to the rows (columns) of an interior shard.
    """
    lay = _layout(blocks, mesh, face_mesh_axis, interior_mesh_axis, interior_mesh_axis_x)
    w = max(tuple(widths_x) + tuple(widths_y))
    if w == 0:
        return blocks
    if lay.P > 1 and w > lay.ny_loc:
        raise ValueError(f"halo width {w} exceeds the {lay.ny_loc} rows per interior shard")
    if lay.Q > 1 and w > lay.nx_loc:
        raise ValueError(f"halo width {w} exceeds the {lay.nx_loc} columns per interior shard")

    pool_self = _strip_pool(blocks, lay, w)
    pool_partner = _strip_pool(partner_blocks, lay, w) if partner_blocks is not None else None

    # basic-BC pre-pad at the uniform width w: one mode for both axes pads y
    # then x (as jnp.pad does the array's axes), mixed modes go in
    # sorted-axis-name order (as core/padding._pad_basic)
    bc = {"x": _bc(boundary_x, fill_value_x), "y": _bc(boundary_y, fill_value_y)}
    if bc["x"] == bc["y"]:
        prepad_order = ("y", "x")
    else:
        prepad_order = ("x", "y") if x_name < y_name else ("y", "x")
    steps = {"y": (-2, interior_mesh_axis, boundary_y, float(fill_value_y)),
             "x": (-1, interior_mesh_axis_x, boundary_x, float(fill_value_x))}
    out = _prepad(blocks, w, mesh, [steps[which] for which in prepad_order])

    halos = _Halos(plan, lay, w, bc, vector_axis_code)
    replace_order = ("x", "y") if x_name < y_name else ("y", "x")
    ny_loc, nx_loc = lay.ny_loc, lay.nx_loc
    lwx, rwx = widths_x
    lwy, rwy = widths_y
    result = np.empty(blocks.shape, dtype=object)
    for c in coords(mesh):
        padded = out[c]  # a new tensor (the pre-pad's): written in place
        dtype = padded.dtype
        target = wrapping(padded)
        p, q = lay.p(c), lay.q(c)
        ps, pp = pool_self[c], None if pool_partner is None else pool_partner[c]
        face0 = lay.face0(c)
        # a side of zero width lies outside the result: its halo is not cut
        sides = {"x": ((0, q == 0 and lwx > 0), (1, q == lay.Q - 1 and rwx > 0)),
                 "y": ((2, p == 0 and lwy > 0), (3, p == lay.P - 1 and rwy > 0))}
        for which in replace_order:
            # faces are disjoint: every face's x sides before every face's
            # y sides is the single-device assembly's order face by face
            for side, owner in sides[which]:
                fls = [fl for fl in range(lay.fpd) if owner and plan.connected[face0 + fl, side]]
                if not fls:
                    continue
                # the faces' strips stacked on the face dim: (..., k, w, L + 2w)
                segs = torch.stack([wrapping(halos.strip(ps, pp, face0 + fl, side))
                                    for fl in fls], dim=-3)
                if which == "x":
                    segs = segs[..., p * ny_loc: p * ny_loc + ny_loc + 2 * w]
                    segs = (segs.flip(-2) if side == 0 else segs).transpose(-1, -2)
                    cols = slice(0, w) if side == 0 else slice(w + nx_loc, 2 * w + nx_loc)
                    dest = target[..., :, cols]
                else:
                    segs = segs[..., q * nx_loc: q * nx_loc + nx_loc + 2 * w]
                    segs = segs.flip(-2) if side == 2 else segs
                    rows = slice(0, w) if side == 2 else slice(w + ny_loc, 2 * w + ny_loc)
                    dest = target[..., rows, :]
                if fls == list(range(fls[0], fls[0] + len(fls))):
                    dest.narrow(-3, fls[0], len(fls)).copy_(segs)
                else:
                    for i, fl in enumerate(fls):
                        dest.select(-3, fl).copy_(segs.select(-3, i))
        result[c] = target.view(dtype)[..., w - lwy: w + ny_loc + rwy,
                                       w - lwx: w + nx_loc + rwx]
    return result


def _face_shift_blocks(setup: FaceSetup, blocks, partner_blocks, funcname, direction, axis_is_x,
                       bc_x, bc_y, fv_x, fv_y, vector_axis_code) -> np.ndarray:
    """``funcname`` along the x or y axis of every (..., fpd, ny_loc,
    nx_loc) block through kernel E, with the one halo line per face built
    by the plan's rule (:func:`~xgcm_tpu_torch.core.topology.face_halo_lines`)
    from the strip pool where the block edge is a face edge, and from the
    ring or the local boundary condition elsewhere."""
    mesh = setup.mesh
    lay = _layout(blocks, mesh, setup.face_mesh_axis, setup.interior_mesh_axis,
                  setup.interior_mesh_axis_x)
    pool_self = _strip_pool(blocks, lay, 1)
    pool_partner = _strip_pool(partner_blocks, lay, 1) if partner_blocks is not None else None
    # JAX's program pre-pads both in-face axes one wide on both sides: the
    # ring axes among them exchange their edge lines, which E reads on the
    # op axis (the other axis's lines feed only corner cells, which no
    # one-wide op reads, and are exchanged for the same budget)
    rings = {}
    for axis, mesh_axis, bnd, fv in ((-2, lay.row_axis, bc_y, fv_y),
                                     (-1, lay.col_axis, bc_x, fv_x)):
        if mesh_axis is not None:
            rings[axis] = ring_halos(blocks, axis, (1, 1), mesh, mesh_axis, bnd, float(fv))
    axis = -1 if axis_is_x else -2
    side = (0 if direction == "left" else 1) + (0 if axis_is_x else 2)
    boundary, fill_value = (bc_x, fv_x) if axis_is_x else (bc_y, fv_y)
    ring_lines = rings[axis][0 if direction == "left" else 1] if axis in rings else None
    out = np.empty(blocks.shape, dtype=object)
    for c in coords(mesh):
        b = blocks[c].contiguous()
        with span("xtt.sharded.halo_lines"):
            def basic():
                if ring_lines is not None:
                    return ring_lines[c].squeeze(axis)
                return basic_edge_line(b, side, boundary, float(fill_value))

            p, q = lay.p(c), lay.q(c)
            if axis_is_x:
                owner = q == (0 if direction == "left" else lay.Q - 1)
                seg = slice(p * lay.ny_loc, (p + 1) * lay.ny_loc)
            else:
                owner = p == (0 if direction == "left" else lay.P - 1)
                seg = slice(q * lay.nx_loc, (q + 1) * lay.nx_loc)
            if owner:
                plan = setup.grid._face_plan(setup.x_axis, setup.y_axis, b.device, setup.n_padded)
                face0 = lay.face0(c)
                halo = face_halo_lines(
                    pool_self[c].squeeze(-2), plan, slice(face0, face0 + lay.fpd), side,
                    lay.ny if axis_is_x else lay.nx, basic,
                    partner=None if pool_partner is None else pool_partner[c].squeeze(-2),
                    vector_axis_code=vector_axis_code, seg=seg,
                )
            else:
                halo = basic().contiguous()
        out[c] = face_shift(b, halo, funcname, direction, axis_is_x)
    return out


def sharded_face_op(
    grid: Grid,
    funcname: str,
    da,
    axis_name: str,
    mesh: Mesh,
    facedim_mesh_axis: str,
    x_axis: str,
    y_axis: str,
    to: Optional[str] = None,
    boundary: Optional[str] = None,
    fill_value: Optional[float] = None,
    other_component: Optional[Dict[str, GriddedArray]] = None,
    interior_mesh_axis: Optional[str] = None,
    interior_mesh_axis_x: Optional[str] = None,
) -> GriddedArray:
    """Apply a 1D built-in stencil op on a face-sharded field.

    ``da`` has dims (..., facedim, ydim, xdim) with the face dim split
    over ``facedim_mesh_axis`` (one or more faces a shard) and, optionally,
    the rows over ``interior_mesh_axis`` and/or the columns over
    ``interior_mesh_axis_x``.  A vector component is a single-entry dict
    ``{vector_axis: array}`` with its partner in ``other_component``.  The
    result equals the single-device ``grid.<funcname>`` everywhere.

    Kernel E per block where :func:`~.halo.ring_kernel_ok` allows it on
    both in-face axes; otherwise the sharded engine with the gridops ufunc the single-device dispatch
    selects (the stencil body lives in ``ops/stencils.PAIR_OPS``).
    """
    from ..core import gridops
    from ..core.grid import _select_grid_ufunc
    from ..core.signature import GridUFuncSignature
    from .sharded_ufunc import sharded_apply_as_grid_ufunc

    arr = da if not isinstance(da, dict) else next(iter(da.values()))
    ax = grid.axes[axis_name]
    from_pos, dim = ax._get_position_name(arr)
    to_pos = to or ax.default_shifts[from_pos]
    if (from_pos, to_pos) not in _SHARDABLE_WIDTHS:
        raise NotImplementedError(
            f"face-sharded ops support only length-preserving shifts, got {from_pos}->{to_pos}"
        )
    dim_to_mesh_axis = {grid._facedim: facedim_mesh_axis}
    if interior_mesh_axis is not None:
        for d in grid.axes[y_axis].coords.values():
            dim_to_mesh_axis[d] = interior_mesh_axis
    if interior_mesh_axis_x is not None:
        for d in grid.axes[x_axis].coords.values():
            dim_to_mesh_axis[d] = interior_mesh_axis_x
    bcs = grid._complete_user_kwargs_using_axis_defaults(boundary, "boundary")
    fvs = grid._complete_user_kwargs_using_axis_defaults(fill_value, "fill_value")
    partner = None if other_component is None else next(iter(other_component.values()))
    if isinstance(da, dict) and partner is None:
        raise ValueError("Padding vector components requires `other_component` input.")
    # kernel E a block where both in-face axes' boundaries are the ring's
    if (all(ring_kernel_ok(funcname, arr.dtype, bcs[a]) for a in (x_axis, y_axis))
            and (partner is None or partner.dtype == arr.dtype)):
        setup = FaceSetup.infer(grid, mesh, dim_to_mesh_axis, first_arg_dims=arr.dims)
        if {setup.x_axis, setup.y_axis} == {x_axis, y_axis} and axis_name in (x_axis, y_axis):
            return _face_op_through_e(setup, funcname, da, partner, axis_name, dim,
                                      ax.coords[to_pos], _SHARDABLE_WIDTHS[(from_pos, to_pos)],
                                      bcs, fvs, dim_to_mesh_axis)

    sig = GridUFuncSignature.from_string(f"({axis_name}:{from_pos})->({axis_name}:{to_pos})")
    grid_ufunc, remaining = _select_grid_ufunc(
        funcname, sig, module=gridops, boundary=boundary, fill_value=fill_value
    )
    return sharded_apply_as_grid_ufunc(
        grid_ufunc.ufunc,
        da,
        axis=[(axis_name,)],
        grid=grid,
        signature=grid_ufunc.signature,
        mesh=mesh,
        dim_to_mesh_axis=dim_to_mesh_axis,
        boundary_width=grid_ufunc.boundary_width,
        boundary=remaining.get("boundary"),
        fill_value=remaining.get("fill_value"),
        other_component=other_component,
    )


def _face_op_through_e(setup, funcname, da, partner, axis_name, dim, out_dim, widths, bcs, fvs,
                       dim_to_mesh_axis) -> GriddedArray:
    vector_axis_code = None
    if isinstance(da, dict):
        ((vec_axis, da),) = da.items()
        vector_axis_code = 0 if vec_axis == setup.x_axis else 1
    ordered = setup.arranged(da)
    spec = partition_spec(ordered.dims, dim_to_mesh_axis)
    blocks = setup.blocks(ordered, spec)
    partner_blocks = None
    if partner is not None:
        p_ordered = setup.arranged(partner)
        partner_blocks = setup.blocks(p_ordered, partition_spec(p_ordered.dims, dim_to_mesh_axis))
    out = _face_shift_blocks(
        setup, blocks, partner_blocks, funcname, "left" if widths == (1, 0) else "right",
        axis_name == setup.x_axis, bcs[setup.x_axis], bcs[setup.y_axis],
        fvs[setup.x_axis], fvs[setup.y_axis], vector_axis_code,
    )
    out_dims = tuple(out_dim if d == dim else d for d in ordered.dims)
    out_spec = partition_spec(out_dims, {**dim_to_mesh_axis, out_dim: dim_to_mesh_axis.get(dim)})
    res = GriddedArray(setup.result(out, out_dims, out_spec), out_dims, name=da.name)
    return res.transpose(*(out_dim if d == dim else d for d in da.dims))


def sharded_face_cumsum(
    grid: Grid,
    da: GriddedArray,
    axis_name: str,
    mesh: Mesh,
    facedim_mesh_axis: str,
    x_axis: str,
    y_axis: str,
    to: Optional[str] = None,
    boundary: Optional[str] = None,
    fill_value: Optional[float] = None,
    interior_mesh_axis: Optional[str] = None,
    interior_mesh_axis_x: Optional[str] = None,
) -> GriddedArray:
    """Position-shifting cumsum on a face-sharded field.

    The single-device ``Grid.cumsum`` is a per-face prefix sum, a
    one-element trim for the shifting pairs, and a width-1 face pad of the
    trimmed array.  Here the prefix sum runs per shard (``ops/stencils.cumsum``,
    so float sums keep XLA's blocked order), plus an ``all_gather`` of
    block totals along the interior axis when the summed dim is sharded;
    the trim is emulated by overwriting the last global element with its
    predecessor (selected with ``torch.where``, width-1 halos only read
    edge lines, and the element itself is sliced away after); and the
    shift element comes from one strip exchange.  Equals ``grid.cumsum``
    for the length-preserving position pairs.

    Axis-swapping face connections raise NotImplementedError for the
    shifting pairs: the trim makes faces non-square along the summed axis,
    and the single-device assembly fails on them too.
    """
    ax = grid.axes[axis_name]
    from_pos, dim = ax._get_position_name(da)
    to_pos = to or ax.default_shifts[from_pos]
    pairs_shift = {("center", "left"), ("right", "center")}
    pairs_noshift = {("center", "right"), ("left", "center")}
    if (from_pos, to_pos) not in pairs_shift | pairs_noshift:
        raise NotImplementedError(
            f"face-sharded cumsum supports only length-preserving shifts, "
            f"got {from_pos}->{to_pos}"
        )
    shift = (from_pos, to_pos) in pairs_shift
    bc = grid._complete_user_kwargs_using_axis_defaults(boundary, "boundary")
    fv = grid._complete_user_kwargs_using_axis_defaults(fill_value, "fill_value")

    facedim = grid._facedim
    d2m = {facedim: facedim_mesh_axis}
    for name, mesh_axis in ((y_axis, interior_mesh_axis), (x_axis, interior_mesh_axis_x)):
        if mesh_axis is not None:
            for d in grid.axes[name].coords.values():
                d2m[d] = mesh_axis
    setup = FaceSetup(grid, mesh, FaceAxisRoles(facedim_mesh_axis, x_axis, y_axis,
                                                interior_mesh_axis, interior_mesh_axis_x))
    if shift and np.any(setup.plan.swap):
        raise NotImplementedError(
            "cumsum on grids with axis-swapping face connections is not supported "
            "(the trim makes faces non-square; the single-device assembly fails on "
            "them too)"
        )
    ordered = setup.arranged(da)
    spec = partition_spec(ordered.dims, d2m)
    blocks = setup.blocks(ordered, spec)
    lay = _layout(blocks, mesh, facedim_mesh_axis, interior_mesh_axis, interior_mesh_axis_x)
    axis_is_x = axis_name == x_axis
    opax = -1 if axis_is_x else -2
    op_mesh_axis = interior_mesh_axis_x if axis_is_x else interior_mesh_axis
    n_loc = first_local(blocks).shape[opax]

    cs = map_blocks(lambda b: cumsum(b, opax), blocks, mesh=mesh)
    if op_mesh_axis is not None:
        # distributed prefix sum: add the totals of the preceding shards
        nsh = mesh.shape[op_mesh_axis]
        ax_i = mesh.axis_index(op_mesh_axis)
        totals = all_gather(map_blocks(lambda t: t.narrow(opax, n_loc - 1, 1), cs, mesh=mesh),
                            mesh, op_mesh_axis)
        for c in coords(mesh):
            tot = totals[c]
            # SELECT earlier shards' totals (0 * NaN in a mask multiply would
            # carry a later shard's NaN backward); the cumsum's dtype, not
            # the block's (bool blocks cumsum to int64)
            mask = (torch.arange(nsh, device=tot.device) < c[ax_i]).reshape(
                (nsh,) + (1,) * (tot.ndim - 1))
            offset = torch.sum(torch.where(mask, wrapping(tot), 0), dim=0).to(wrapping(tot).dtype)
            cs[c] = (wrapping(cs[c]) + offset).view(tot.dtype)
    out_dim = ax.coords[to_pos]
    out_dims = tuple(out_dim if d == dim else d for d in ordered.dims)
    out_spec = partition_spec(out_dims, {**d2m, out_dim: d2m.get(dim)})
    if shift:
        # the trim of the single-device cumsum: the last GLOBAL element
        # becomes its predecessor, so every width-1 edge line equals the
        # trimmed array's; the element itself is sliced away below
        for c in coords(mesh):
            if op_mesh_axis is None or c[mesh.axis_index(op_mesh_axis)] == mesh.shape[op_mesh_axis] - 1:
                t = cs[c]
                is_last = torch.arange(n_loc, device=t.device) == n_loc - 1
                is_last = is_last.reshape((n_loc, 1) if opax == -2 else (n_loc,))
                cs[c] = torch.where(is_last, t.narrow(opax, n_loc - 2, 1), t)
        wx = (1, 0) if axis_is_x else (0, 0)
        wy = (0, 0) if axis_is_x else (1, 0)
        padded = face_halo_pad_widths(
            cs, mesh, setup.plan, wx, wy, facedim_mesh_axis, bc[x_axis], bc[y_axis],
            float(fv[x_axis]), float(fv[y_axis]), x_axis, y_axis,
            interior_mesh_axis=interior_mesh_axis, interior_mesh_axis_x=interior_mesh_axis_x,
        )
        for c in coords(mesh):
            cs[c] = padded[c].narrow(opax, 0, n_loc).contiguous()
    res = GriddedArray(setup.result(cs, out_dims, out_spec), out_dims, name=da.name)
    return res.transpose(*(out_dim if d == dim else d for d in da.dims))
