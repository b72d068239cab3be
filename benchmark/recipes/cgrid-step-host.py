"""The C-grid analysis step of one face from host memory:
``xgcm_tpu_torch.entry.step`` on host numpy arrays, giving host numpy arrays.

A user walking snapshots: set-up copies the seed's inputs into two pageable
host snapshots, A and B, with the same values, and the steps take them in
turn, so that no step reads the buffers the step before it read.  The
port's bridge (``xgcm_tpu_torch.core.device``) copies the inputs to the card
and the results back, 9.70 GB a step at a 4320² face of 90 levels; the work
on the card is ``cgrid-step``'s.  The results reach the judge in
:class:`HostResult`, which copies each block it is asked for to the card.
"""

import importlib.util
import pathlib

import numpy as np
import torch

_path = pathlib.Path(__file__).with_name("cgrid-step.py")
_spec = importlib.util.spec_from_file_location("bench_recipes_cgrid_step_of_host", _path)
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)

LAUNCHES = _base.LAUNCHES
kernel_work = _base.kernel_work
INPUTS = ("u", "v", "theta", "targets")
OUTPUTS = ("zeta", "div", "ke_on_theta")
ITEMSIZE = 4  # float32, as the configuration states


class HostResult:
    """A result in host memory as the judge reads it: ``[index]`` is that
    block copied to ``device``.  A torch function of it (a test's planted
    fault) runs on its whole copy on ``device``."""

    def __init__(self, array: np.ndarray, device):
        self.array, self.device = array, device

    @property
    def ndim(self):
        return self.array.ndim

    def __getitem__(self, index):
        return torch.from_numpy(self.array[index]).to(self.device)

    def clone(self):
        return torch.from_numpy(self.array).to(self.device, copy=True)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        def card(x):
            return x.clone() if isinstance(x, cls) else x

        return func(*map(card, args), **{k: card(v) for k, v in (kwargs or {}).items()})


def setup(xtt, sizes, inputs, device):
    from xgcm_tpu_torch.entry import build_grid

    a = {k: inputs[k].to("cpu", copy=True).numpy() for k in INPUTS}
    b = {k: x.copy() for k, x in a.items()}
    return {"grid": build_grid(sizes["nx"], sizes["ny"]), "snapshots": (a, b), "next": 0,
            "device": device}


def step(xtt, s, span):
    from xgcm_tpu_torch.entry import step as entry_step

    snap = s["snapshots"][s["next"]]
    s["next"] = 1 - s["next"]
    with span("entry.step"):
        out = entry_step(*(snap[k] for k in INPUTS), grid=s["grid"])
    if not all(isinstance(r, np.ndarray) for r in out):
        raise TypeError("entry.step gave " + ", ".join(type(r).__name__ for r in out)
                        + " for host numpy inputs, not host numpy arrays")
    return {name: HostResult(r, s["device"]) for name, r in zip(OUTPUTS, out)}


def copy_work(shapes):
    """{"h2d": bytes, "d2h": bytes} a step, from the inputs' shapes: u, v,
    theta and the targets to the card; ζ, the divergence and the energy on
    the θ surfaces back."""
    ny, nx, nz = shapes["theta"]
    m = shapes["targets"][0]
    return {"h2d": (2 * ny * nx + ny * nx * nz + m) * ITEMSIZE,
            "d2h": (2 * ny * nx + ny * nx * m) * ITEMSIZE}
