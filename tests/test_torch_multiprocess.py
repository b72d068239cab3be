"""The port's sharded layer on a mesh over two real processes.

A module fixture starts two gloo processes on the CPU
(``tests/torch_multiprocess_child.py``, joined by a ``file://`` init in a
temporary directory, so that test workers cannot collide) and waits at
most ``JOIN_S`` seconds for both, killing both and failing if either is
late or fails.  Each child runs every route of the sharded layer on small
grids, on meshes whose coordinates are split between the two processes:
the ring route (diff, interp, min and max under periodic, fill and extend
on ``{"x": 4}``), the sharded cumsum, the metric route, the batch route
(``{"z": 2}``), the per-shard transforms, the C-grid diagnostics
(``{"y": 2, "x": 2}``), the face analysis of ``llc_grid(n=8)`` on
``{"f": 4}`` as eight ops and as one ``apply_many``, a fall-through that
assembles across the processes, and ppermute, all_gather and psum with
local and remote pairs mixed.

Each case is held to the port's one-process run on ``make_mesh(...,
devices=[cpu] * n)`` bit for bit, block by block; to JAX (``ShardedGrid``
on conftest's CPU devices, or the single-device face analysis, since eager
``shard_map`` on a face grid takes minutes a call) at the JAX tests'
tolerances; and each process's collectives to the count of the JAX
program's jaxpr.
"""

import math
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as JP

import chip_smoke
import xgcm_tpu
import xgcm_tpu.grids  # noqa: F401  (xgcm_tpu.grids.llc_grid)
import xgcm_tpu.parallel as jpar
import tests.torch_parity  # noqa: F401  (the port's host data on the CPU)
from tests import torch_multiprocess_child as child
from tests.torch_parity import to_numpy
from xgcm_tpu.utils import count_collectives as jcount

REPO = pathlib.Path(__file__).resolve().parents[1]
JOIN_S = 120
RTOL_SHIFT = 1e-7  # numpy.testing.assert_allclose's default, the JAX tests'
RTOL_SUM = 1e-12  # the JAX tests' for cumsums and transforms
CASES = [*child.CASES, "collectives"]
RTOL = {**{n: RTOL_SHIFT for n in child.CASES}, "collectives": 0.0,
        "cumsum fill": RTOL_SUM, "cumsum periodic": RTOL_SUM,
        "transform linear": RTOL_SUM, "transform conservative": RTOL_SUM}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The payloads of the two children (see the module docstring)."""
    d = tmp_path_factory.mktemp("multiprocess")
    logs = [open(d / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_multiprocess_child", "--init", f"file://{d}/init",
         "--rank", str(r), "--out", str(d)], cwd=REPO, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + JOIN_S
    try:
        # until both end, one fails (its peer would wait for its messages)
        # or the time is up
        while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
            if time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        late = [p for p in procs if p.poll() is None]
        for p in late:
            p.kill()
        for p in procs:
            p.wait()
        for f in logs:
            f.close()
    report = "\n".join(f"rank {r} (exit {p.returncode}):\n{(d / f'rank{r}.log').read_text()}"
                       for r, p in enumerate(procs))
    if late and not any(p.returncode for p in procs if p not in late):
        pytest.fail(f"{len(late)} process(es) did not finish in {JOIN_S} s and were killed\n"
                    + report)
    if any(p.returncode for p in procs):
        pytest.fail("a process failed\n" + report)
    return [torch.load(d / f"rank{r}.pt") for r in range(2)]


@pytest.fixture(scope="module")
def one_process():
    """Every case in this process, on make_mesh's one-process meshes."""
    return child.run(1, child.inputs())


def _jax_mesh(axes):
    return jpar.make_mesh(axes, devices=jax.devices()[:math.prod(axes.values())])


def _jax_collectives(A):
    """The collectives case as a jax.shard_map of lax collectives."""
    mesh = _jax_mesh(child.RING)

    def local(b, fb):
        return (jax.lax.ppermute(b, "x", [(0, 1), (1, 2), (3, 0)]),
                jax.lax.all_gather(b, "x"), jax.lax.psum(b, "x"), jax.lax.psum(fb, "x"))

    row = JP("x", None)
    f = shard_map(local, mesh=mesh, in_specs=(row, row),
                  out_specs=(row, JP("x", None, None), row, row))
    args = jnp.asarray(A["words"]), jnp.asarray(A["floats"])
    names = ("ppermute", "all_gather", "psum", "psum f64")
    return (lambda: dict(zip(names, f(*args)))), lambda: jcount(lambda: f(*args))


def _jax_program(name, A):
    """(values, counts) of a case's JAX program: its results (single-device
    for the face analysis) and the collectives of the sharded program's
    jaxpr."""
    if name == "collectives":
        values, counts = _jax_collectives(A)
        return values(), counts()
    sharded = lambda: child.CASES[name](xgcm_tpu, jpar, _jax_mesh, A)  # noqa: E731
    counts = jcount(sharded)
    if not name.startswith("face"):
        return sharded(), counts
    _, grid = xgcm_tpu.grids.llc_grid(n=child.N_FACE)
    single = chip_smoke.face_analysis(grid, xgcm_tpu, A["face_theta"], A["face_u"],
                                      A["face_v"])
    return single, counts


def _global(records) -> np.ndarray:
    """A result of the two processes as one array: its blocks placed by
    their coordinates (each process's own), or the whole that every
    process assembled (equal on both)."""
    first = records[0]
    if "full" in first:
        for r in records[1:]:
            np.testing.assert_array_equal(to_numpy(r["full"]), to_numpy(first["full"]))
        return to_numpy(first["full"])
    out = None
    for rec in records:
        for key, block in rec["blocks"].items():
            b = to_numpy(block)
            if out is None:
                out = np.empty(rec["shape"], dtype=b.dtype)
            out[tuple(slice(*span) for span in rec["where"][key])] = b
    return out


def test_children_started_the_runtime(ranks):
    """Each child: init_distributed started the runtime once (False the
    second time), the multi-process mesh put coordinates 0, 1 on rank 0
    and 2, 3 on rank 1, and neither imported JAX or xgcm_tpu."""
    for r, payload in enumerate(ranks):
        assert payload["started"] is True and payload["again"] is False
        assert payload["process_ids"] == [0, 0, 1, 1]
        assert payload["local_coords"] == [(2 * r,), (2 * r + 1,)]
        assert payload["jax_loaded"] is False


@pytest.mark.parametrize("name", CASES)
def test_matches_one_process(ranks, one_process, name):
    """Every block a process holds equals the one-process run's block at
    that coordinate bit for bit (dtype included), and the two processes
    together hold every coordinate once; a result every process assembles
    equals the one-process result."""
    for key, want in one_process[name]["results"].items():
        got = [p["cases"][name]["results"][key] for p in ranks]
        assert all(g["dims"] == want["dims"] for g in got)
        if "full" in want:
            for g in got:
                assert g["full"].dtype == want["full"].dtype
                np.testing.assert_array_equal(to_numpy(g["full"]), to_numpy(want["full"]))
            continue
        held = [k for g in got for k in g["blocks"]]
        assert sorted(held) == sorted(want["blocks"]), (held, list(want["blocks"]))
        for g in got:
            for coord, block in g["blocks"].items():
                assert block.dtype == want["blocks"][coord].dtype
                np.testing.assert_array_equal(to_numpy(block), to_numpy(want["blocks"][coord]))


@pytest.fixture(scope="module")
def jax_programs():
    """The JAX programs' (values, counts), computed once each."""
    cache = {}
    A = child.inputs()

    def get(name):
        if name not in cache:
            cache[name] = _jax_program(name, A)
        return cache[name]

    return get


@pytest.mark.parametrize("name", CASES)
def test_matches_jax(ranks, jax_programs, name):
    """The two processes' result equals JAX's at the JAX tests'
    tolerances: 1e-7 for the shifts, diagnostics, metrics and sums, 1e-12
    for cumsums and transforms, value for value for the face analysis
    (against JAX's single-device ops) and the collectives."""
    values, _ = jax_programs(name)
    for key, want in values.items():
        got = _global([p["cases"][name]["results"][key] for p in ranks])
        want = to_numpy(want)
        assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
        if name.startswith("face") or RTOL[name] == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, rtol=RTOL[name])


@pytest.mark.parametrize("name", CASES)
def test_collective_counts_match_jax(ranks, jax_programs, name):
    """Each process counts the collectives of the JAX program's jaxpr
    (which names a psum ``psum_invariant``)."""
    _, counts = jax_programs(name)
    counts = {("psum" if "psum" in k else k): v for k, v in counts.items()}
    for payload in ranks:
        assert payload["cases"][name]["counts"] == counts, name


@pytest.mark.parametrize("name, lines", [
    ("ring diff periodic", 1), ("ring max fill", 1), ("derivative", 1),
    # the ppermute's line, and two all_gathers of the two edge lines of
    # the other process's two blocks
    ("ring diff extend", 1 + 2 * 2 * 2),
    ("batch", 0), ("transform linear", 0),
])
def test_bytes_crossed_once_a_process(ranks, name, lines):
    """The bytes that crossed are the halo lines of theta (NZ x NY float64
    each) that the other process's blocks supply, each sent once to the
    process, however many of its blocks take it; the batch route and the
    per-shard transforms move nothing."""
    line = child.NZ * child.NY * 8
    for payload in ranks:
        moved = payload["cases"][name]["bytes"]
        assert moved.get("bytes_sent", 0) == lines * line, moved
        assert moved.get("bytes_received", 0) == lines * line, moved
