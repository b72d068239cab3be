"""The port's multi-process runtime in one process: ``init_distributed`` and
``make_multihost_mesh`` against tests/test_multihost_mesh.py.

Its eleven tests are here: the single-process no-op (torchrun's variables
cleared), the 1-d and 2-d meshes (on ``devices=[cpu] * 8``, since this
machine has no card), the spanning and ``dcn_axes`` checks with JAX's
messages, a sharded diff on a multihost mesh against the single-device op
and against JAX's ``make_multihost_mesh`` + ``ShardedGrid`` on conftest's 8
CPU devices (at the JAX test's tolerance, ``assert_allclose``'s default),
the misconfiguration that must raise before any connection, the two
no-deprecation tests and the counterpart of the pod-marker warning.  The
runs over two real processes are tests/test_torch_multiprocess.py.
"""

import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import xgcm_tpu
import xgcm_tpu.parallel as jpar
import xgcm_tpu_torch as xtt
import tests.torch_parity  # noqa: F401  (the port's host data on the CPU)
from tests.torch_parity import assert_bitwise, to_numpy
from xgcm_tpu_torch.parallel import (
    ShardedGrid,
    init_distributed,
    make_mesh,
    make_multihost_mesh,
    shard_gridded,
)
from xgcm_tpu_torch.parallel import mesh as mesh_mod

CPU8 = [torch.device("cpu")] * 8
TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def no_job(monkeypatch):
    """An environment that names no multi-process job."""
    for var in TORCHRUN:
        monkeypatch.delenv(var, raising=False)


def test_init_distributed_single_process_noop(no_job):
    # nothing names a coordinator: False instead of raising, so library
    # code can call it unconditionally
    assert init_distributed() is False
    assert not dist.is_initialized()


def test_make_multihost_mesh_1d():
    mesh = make_multihost_mesh({"x": 8}, devices=CPU8)
    assert mesh.axis_names == ("x",)
    assert mesh.devices.shape == (8,)
    assert set(mesh.devices.flat) == {torch.device("cpu")}
    assert mesh.process_ids.tolist() == [0] * 8 and not mesh.multiprocess


def test_make_multihost_mesh_2d():
    mesh = make_multihost_mesh({"b": 2, "x": 4}, devices=CPU8)
    assert mesh.axis_names == ("b", "x")
    assert mesh.devices.shape == (2, 4)
    assert mesh == make_mesh({"b": 2, "x": 4}, devices=CPU8)


def test_make_multihost_mesh_must_span_all_devices():
    with pytest.raises(ValueError, match="exactly the global device count"):
        make_multihost_mesh({"x": 4}, devices=CPU8)


def test_dcn_axes_must_be_mesh_axes():
    with pytest.raises(ValueError, match="not mesh axes"):
        make_multihost_mesh({"x": 8}, devices=CPU8, dcn_axes={"y": 2})


def test_sharded_op_on_multihost_mesh_matches_single_device():
    nx, ny = 32, 16

    def grid_of(pkg):
        ds = pkg.Dataset(coords={
            "xc": ("xc", np.arange(nx) + 0.5, {"axis": "X"}),
            "xg": ("xg", np.arange(nx) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
            "yc": ("yc", np.arange(ny) + 0.5, {"axis": "Y"}),
        })
        return pkg.Grid(ds)

    data = np.random.default_rng(0).random((ny, nx))
    grid = grid_of(xtt)
    da = xtt.GriddedArray(data, ("yc", "xc"))
    expected = grid.diff(da, "X")
    mesh = make_multihost_mesh({"x": 8}, devices=CPU8)
    sgrid = ShardedGrid(grid, mesh, {"xc": "x", "xg": "x"})
    out = sgrid.diff(shard_gridded(da, mesh, {"xc": "x"}), "X")
    assert_bitwise(out.data, expected.data)

    jgrid = grid_of(xgcm_tpu)
    jmesh = jpar.make_multihost_mesh({"x": 8})
    jout = jpar.ShardedGrid(jgrid, jmesh, {"xc": "x", "xg": "x"}).diff(
        jpar.shard_gridded(xgcm_tpu.GriddedArray(data, ("yc", "xc")), jmesh, {"xc": "x"}), "X")
    np.testing.assert_allclose(to_numpy(out.data), np.asarray(jnp.asarray(jout.data)))


def test_init_distributed_misconfiguration_not_swallowed():
    """A coordinator WITHOUT a process id is a misconfiguration, not a
    single-process run: it raises before any connection is tried (an
    address nothing listens on would otherwise wait for its timeout)."""
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="process_id"):
        init_distributed(coordinator_address="127.0.0.1:65534", num_processes=2)
    assert time.monotonic() - t0 < 5.0
    assert not dist.is_initialized()


def test_dcn_axes_divisibility_checked():
    with pytest.raises(ValueError, match="does not divide into"):
        make_multihost_mesh({"face": 6, "x": 2}, devices=CPU8[:6] * 2, dcn_axes={"face": 4})


def test_internal_sharded_grid_reconstruction_emits_no_deprecations():
    """The per-shard Grid reconstruction passes boundary/fill_value dicts
    internally; the constructor's forward-compat DeprecationWarnings must
    not reach users of sharded ops."""
    ds = xtt.Dataset(coords={
        "xc": ("xc", np.arange(16) + 0.5, {"axis": "X"}),
        "xg": ("xg", np.arange(16) * 1.0, {"axis": "X", "c_grid_axis_shift": -0.5}),
    })
    grid = xtt.Grid(ds)
    mesh = make_multihost_mesh({"x": 8}, devices=CPU8)
    sgrid = ShardedGrid(grid, mesh, {"xc": "x", "xg": "x"})
    da = shard_gridded(xtt.GriddedArray(np.arange(16.0), ("xc",)), mesh, {"xc": "x"})
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        sgrid.diff(da, "X")


def test_grid_factories_emit_no_deprecations():
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        xtt.grids.mitgcm_c_grid()
        xtt.grids.llc_grid(n=4)


def test_init_distributed_pod_marker_warns(monkeypatch, no_job):
    """The no-keyword call where the environment names a multi-process job
    it cannot start (WORLD_SIZE > 1 with no coordinator) warns instead of
    silently running the job's processes alone; without such a marker it
    returns False quietly; a caller who PASSED a coordinator wanted
    multi-process, and the start's error propagates."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.warns(RuntimeWarning, match="multi-process"):
        assert init_distributed() is False

    monkeypatch.delenv("WORLD_SIZE")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert init_distributed() is False

    def refused(*args, **kwargs):
        raise RuntimeError("the store at 10.0.0.1:8476 refused the connection")

    monkeypatch.setattr(dist, "init_process_group", refused)
    with pytest.raises(RuntimeError, match="refused"):
        init_distributed(coordinator_address="10.0.0.1:8476", num_processes=2, process_id=0,
                         backend="gloo")
    assert not dist.is_initialized()


def test_no_card_raises_rather_than_falling_back(monkeypatch, no_job):
    """Without CUDA the NCCL default and the card lookup raise; neither
    runs the job on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        init_distributed(coordinator_address="127.0.0.1:65534", num_processes=2, process_id=0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_multihost_mesh({"x": 1})


def _fake_job(monkeypatch, entries, backend):
    """A started runtime of len(entries) processes whose gather gives
    ``entries`` (host, rank, devices), seen from rank 0."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: len(entries))
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_backend", lambda: backend)

    def gather(out, obj):
        out[:] = entries

    monkeypatch.setattr(dist, "all_gather_object", gather)


def test_two_nccl_ranks_on_one_card_raise(monkeypatch):
    """NCCL takes one rank a card: two ranks on one card raise a message
    that names the gloo backend; under gloo they make a mesh."""
    entries = [("h0", 0, ["cuda:0"]), ("h0", 1, ["cuda:0"])]
    _fake_job(monkeypatch, entries, "nccl")
    with pytest.raises(ValueError, match="backend='gloo'"):
        make_multihost_mesh({"x": 2}, devices=["cuda:0"])
    _fake_job(monkeypatch, entries, "gloo")
    mesh = make_multihost_mesh({"x": 2}, devices=["cuda:0"])
    assert mesh.process_ids.tolist() == [0, 1] and mesh.local_coords == ((0,),)


def test_dcn_axes_outermost_and_hosts_together(monkeypatch):
    """Devices go in (host, rank, device) order whatever the gather's; a
    dcn axis goes outermost, and each slice (a group of hosts) fills the
    within-slice part of the mesh, so its inner neighbours share a host."""
    entries = [("h1", 2, ["cuda:0", "cuda:1"]), ("h0", 0, ["cuda:0", "cuda:1"]),
               ("h1", 3, ["cuda:2", "cuda:3"]), ("h0", 1, ["cuda:2", "cuda:3"])]
    _fake_job(monkeypatch, entries, "nccl")
    plain = make_multihost_mesh({"y": 2, "x": 4}, devices=["cuda:0", "cuda:1"])
    assert plain.process_ids.tolist() == [[0, 0, 1, 1], [2, 2, 3, 3]]
    assert [d.index for d in plain.devices.flat] == [0, 1, 2, 3] * 2
    mesh = make_multihost_mesh({"y": 2, "x": 4}, devices=["cuda:0", "cuda:1"],
                               dcn_axes={"x": 2})
    assert mesh.axis_names == ("x", "y") and mesh.devices.shape == (4, 2)
    assert mesh.process_ids.tolist() == [[0, 0], [1, 1], [2, 2], [3, 3]]
    assert mesh.local_coords == ((0, 0), (0, 1))
    assert mesh_mod.Mesh(mesh.devices, mesh.axis_names, mesh.process_ids) == mesh


def test_init_distributed_reads_torchrun(monkeypatch, no_job):
    """With no keywords torchrun's variables name the job; a keyword given
    without a coordinator stands in for its variable; a coordinator URL is
    kept as it is and "host:port" becomes tcp://host:port."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert init_distributed(backend="gloo", timeout=60) is True
    assert init_distributed(process_id=1, num_processes=2, backend="gloo") is True
    assert init_distributed("file:///tmp/job/init", 2, 0, backend="gloo") is True
    assert init_distributed("10.0.0.2:1234", 2, 1, backend="gloo") is True
    kw = [c[1] for c in calls]
    assert [c[0] for c in calls] == ["gloo"] * 4
    assert [(k["init_method"], k["world_size"], k["rank"]) for k in kw] == [
        ("tcp://10.0.0.1:29500", 4, 3), ("tcp://10.0.0.1:29500", 2, 1),
        ("file:///tmp/job/init", 2, 0), ("tcp://10.0.0.2:1234", 2, 1)]
    assert kw[0]["timeout"].total_seconds() == 60 and "timeout" not in kw[1]
