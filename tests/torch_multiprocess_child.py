"""The programs of tests/test_torch_multiprocess.py, and the child process
that runs them on a mesh over two processes.

Each case builds its grid and inputs with the package it is given (the
port, or ``xgcm_tpu`` for the JAX reference) and runs one sharded route on
a mesh that :func:`mesh_of` makes, so that the same program runs

* in each of two gloo processes on the CPU, on ``make_multihost_mesh``
  (``python -m tests.torch_multiprocess_child --init URL --rank R --out
  DIR``, from the repo root): the mesh's coordinates split between the
  processes, each process holding its own blocks;
* in one process on ``make_mesh(..., devices=[cpu] * n)``;
* through JAX's ``ShardedGrid`` on conftest's CPU devices.

The child imports torch, numpy, the port and ``chip_smoke`` (which imports
torch and numpy only), never JAX.  It writes, per case, the blocks it holds
(or the whole of a result that every process assembles), the collectives
it counted and the bytes that crossed to the other process, to
``DIR/rank<R>.pt``.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys

import numpy as np

NZ, NY, NX = 4, 8, 16  # theta (zc, yc, xc); X over {"x": 4}: 4 columns a block
NZD = 6  # levels of the density columns
N_FACE = 8  # llc_grid(n=8)
BCS = ("periodic", "fill", "extend")
OPS = ("diff", "interp", "min", "max")
# mesh axes of each route, every one split between the two processes
RING, BATCH, MESH2, FACES = {"x": 4}, {"z": 2}, {"y": 2, "x": 2}, {"f": 4}
TIMEOUT_S = 60  # gloo's: a collective with no matching peer fails after it


def inputs(seed: int = 0) -> dict:
    """The numpy inputs of every case, the same in every process."""
    rng = np.random.default_rng(seed)
    theta = rng.random((NZ, NY, NX)) + 20.0
    # NaN and infinities either side of the process boundary (columns 7 | 8)
    # and of a shard boundary within a process (3 | 4)
    theta[1, 2, 7] = np.nan
    theta[2, 5, 8] = np.inf
    theta[0, 0, 3] = -np.inf
    theta[3, 7, 4] = np.nan
    sc = np.cumsum(rng.random((NY, NX, NZD)) * 0.2 + 0.05, axis=-1) + 24.0
    sb = np.concatenate([sc[..., :1] - 0.1, sc + 0.05], axis=-1)
    face = [rng.standard_normal((13, N_FACE, N_FACE)) for _ in range(3)]
    for a in face:  # the halo sources of four face edges (chip_smoke.edge_nonfinite's)
        a[0, 5, 0], a[6, N_FACE - 1, 3] = np.nan, np.inf
        a[9, 3, N_FACE - 1], a[12, 0, N_FACE - 3] = -np.inf, np.nan
    return {
        "theta": theta,
        "u": rng.standard_normal((NY, NX)),
        "v": rng.standard_normal((NY, NX)),
        "T": rng.standard_normal((NY, NX, NZD)),
        "sc": sc,
        "sb": sb,
        "levels": np.linspace(24.1, 25.0, 5),
        "edges": np.linspace(24.0, 25.2, 7),
        "face_theta": face[0],
        "face_u": face[1],
        "face_v": face[2],
        # near 2**32: a psum over 4 blocks wraps
        "words": (rng.integers(2**31, 2**32, size=(8, 3), dtype=np.uint64)).astype(np.uint32),
        # magnitudes 1e-8 to 1e16: a float sum's rounding depends on its order
        "floats": rng.standard_normal((8, 3)) * 10.0 ** rng.integers(-8, 17, size=(8, 3)),
    }


def _grid(pkg):
    import chip_smoke

    return chip_smoke.budget_grid(pkg, NX, NY, NZ, dtype=np.float64)


def _theta(pkg, sg, A):
    return sg.shard(pkg.GriddedArray(A["theta"], ("zc", "yc", "xc"), name="theta"))


def _ring(op, bc):
    def run(pkg, par, mesh_of, A):
        sg = par.ShardedGrid(_grid(pkg), mesh_of(RING), {"X": "x"})
        return {"out": getattr(sg, op)(_theta(pkg, sg, A), "X", boundary=bc, fill_value=1.5)}
    return run


def _cumsum(bc):
    def run(pkg, par, mesh_of, A):
        sg = par.ShardedGrid(_grid(pkg), mesh_of(RING), {"X": "x"})
        return {"out": sg.cumsum(_theta(pkg, sg, A), "X", to="left", boundary=bc)}
    return run


def _derivative(pkg, par, mesh_of, A):
    sg = par.ShardedGrid(_grid(pkg), mesh_of(RING), {"X": "x"})
    return {"out": sg.derivative(_theta(pkg, sg, A), "X")}


def _integrate(pkg, par, mesh_of, A):
    """The fall-through: the sum along the sharded dim assembles the
    product across the processes."""
    sg = par.ShardedGrid(_grid(pkg), mesh_of(RING), {"X": "x"})
    return {"out": sg.integrate(_theta(pkg, sg, A), "X")}


def _batch(pkg, par, mesh_of, A):
    sg = par.ShardedGrid(_grid(pkg), mesh_of(BATCH), {"zc": "z"})
    return {"out": sg.diff(sg.shard(pkg.GriddedArray(A["theta"], ("zc", "yc", "xc"))), "X")}


def _transform(method):
    def run(pkg, par, mesh_of, A):
        import chip_smoke

        sg = par.ShardedGrid(chip_smoke.density_grid(pkg, nz=NZD), mesh_of(RING), {"x": "x"})
        T = sg.shard(pkg.GriddedArray(A["T"], ("y", "x", "zc"), name="T"))
        if method == "linear":
            sc = sg.shard(pkg.GriddedArray(A["sc"], ("y", "x", "zc"), name="sigma"))
            return {"out": sg.transform(T, "Z", A["levels"], target_data=sc)}
        sb = sg.shard(pkg.GriddedArray(A["sb"], ("y", "x", "zo"), name="sigma"))
        return {"out": sg.transform(T, "Z", A["edges"], target_data=sb, method="conservative")}
    return run


def _diagnostics(pkg, par, mesh_of, A):
    grid = _grid(pkg)
    u = pkg.GriddedArray(A["u"], ("yc", "xg"), name="u")
    v = pkg.GriddedArray(A["v"], ("yg", "xc"), name="v")
    zeta, div, ke = par.sharded_cgrid_diagnostics(
        grid, u, v, mesh_of(MESH2), {"xc": "x", "xg": "x", "yc": "y", "yg": "y"})
    return {"zeta": zeta, "div": div, "ke": ke}


def _face(batch):
    def run(pkg, par, mesh_of, A):
        import chip_smoke

        _, grid = pkg.grids.llc_grid(n=N_FACE)
        sg = par.ShardedGrid(grid, mesh_of(FACES), {"face": "f"})
        fn = chip_smoke.face_analysis_batch if batch else chip_smoke.face_analysis_2d
        return fn(sg, pkg, A["face_theta"], A["face_u"], A["face_v"])
    return run


CASES = {
    **{f"ring {op} {bc}": _ring(op, bc) for bc in BCS for op in OPS},
    **{f"cumsum {bc}": _cumsum(bc) for bc in ("fill", "periodic")},
    "derivative": _derivative,
    "batch": _batch,
    "transform linear": _transform("linear"),
    "transform conservative": _transform("conservative"),
    "diagnostics": _diagnostics,
    "face analysis": _face(batch=False),
    "face analysis apply_many": _face(batch=True),
    "integrate (fall-through)": _integrate,
}


def collectives_case(par, mesh_of, A):
    """ppermute, all_gather and psum of uint32 blocks on {"x": 4}, their
    pairs local and remote mixed: block 1 receives from 0 (the same
    process), 2 from 1 and 0 from 3 (the other), 3 from none (zeros); the
    psum of four words near 2**32 wraps; a psum of float64 blocks whose
    sum depends on the order of addition."""
    import torch

    P = par.PartitionSpec
    mesh = mesh_of(RING)
    words = torch.as_tensor(A["words"].astype(np.int64)).to(torch.uint32)
    floats = torch.as_tensor(A["floats"])

    def local(blocks, fblocks):
        c = par.collectives
        return (c.ppermute(blocks, mesh, "x", [(0, 1), (1, 2), (3, 0)]),
                c.all_gather(blocks, mesh, "x"),
                c.psum(blocks, mesh, "x"),
                c.psum(fblocks, mesh, "x"))

    row = P("x", None)
    shifted, gathered, summed, fsummed = par.shard_map(
        local, mesh, (row, row), (row, P("x", None, None), row, row))(words, floats)
    return {"ppermute": shifted, "all_gather": gathered, "psum": summed, "psum f64": fsummed}


def mesh_of(par, processes: int, cpu):
    """``mesh_of(axes)`` for ``processes`` processes on the CPU: the
    multi-process mesh, each process passing its share of the devices,
    or (1) the one-process mesh of ``make_mesh``."""
    def make(axes):
        n = math.prod(axes.values())
        if processes == 1:
            return par.make_mesh(axes, devices=[cpu] * n)
        return par.make_multihost_mesh(axes, devices=[cpu] * (n // processes))
    return make


def _record(result) -> dict:
    """What one result holds in this process: its blocks by coordinate
    (without the padding of a padded layout), or the whole tensor where it
    is a plain one."""
    data = result.data if hasattr(result, "dims") else result
    from xgcm_tpu_torch.parallel import ShardedTensor

    if isinstance(data, ShardedTensor):
        return {"dims": tuple(getattr(result, "dims", ())), "shape": tuple(data.shape),
                "blocks": {repr(c): data.real_block(c).clone() for c in data.mesh.local_coords},
                "where": {repr(c): [(s.start or 0, n if s.stop is None else s.stop)
                                    for s, n in zip(data.block_index(c), data.shape)]
                          for c in data.mesh.local_coords}}
    return {"dims": tuple(getattr(result, "dims", ())), "full": data.clone()}


def run(processes: int, A: dict, counted=None) -> dict:
    """Every case (and the collectives case) in this process: per case its
    records, collectives and bytes."""
    import torch

    import xgcm_tpu_torch as xtt
    from xgcm_tpu_torch import parallel as par
    from xgcm_tpu_torch.parallel import collectives
    from xgcm_tpu_torch.utils import count_collectives

    make = mesh_of(par, processes, torch.device("cpu"))
    out = {}
    programs = {name: (lambda f=f: f(xtt, par, make, A)) for name, f in CASES.items()}
    programs["collectives"] = lambda: collectives_case(par, make, A)
    for name, program in programs.items():
        box = {}
        collectives.TRANSPORT.clear()
        counts = count_collectives(lambda: box.setdefault("out", program()))
        out[name] = {"results": {k: _record(r) for k, r in box["out"].items()},
                     "counts": counts, "bytes": dict(collectives.TRANSPORT)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one process of the two-process tests")
    parser.add_argument("--init", required=True, help="init_method URL of the job")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    import torch

    import xgcm_tpu_torch as xtt
    from xgcm_tpu_torch import parallel as par

    xtt.set_default_device("cpu")
    torch.set_num_threads(1)
    started = par.init_distributed(args.init, args.world, args.rank, backend="gloo",
                                   timeout=TIMEOUT_S)
    again = par.init_distributed(args.init, args.world, args.rank, backend="gloo")
    mesh = par.make_multihost_mesh(RING, devices=[torch.device("cpu")] * 2)
    payload = {
        "started": started, "again": again,
        "process_ids": mesh.process_ids.tolist(), "local_coords": list(mesh.local_coords),
        "cases": run(args.world, inputs()),
        "jax_loaded": "jax" in sys.modules or "xgcm_tpu" in sys.modules,
    }
    torch.save(payload, pathlib.Path(args.out) / f"rank{args.rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
