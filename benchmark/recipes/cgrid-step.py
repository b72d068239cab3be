"""The C-grid analysis step of one face: ``xgcm_tpu_torch.entry.step``.

ζ, divergence and kinetic energy of (u, v) on a doubly periodic C-grid,
and the kinetic energy remapped onto the θ surfaces of each column: six
launches of the shift kernel (A) and one of the linear transform (C).
"""

from benchmark.roofline import linear_work, stencil_work

LAUNCHES = {"shift": 6, "interp_linear": 1}


def setup(xtt, sizes, inputs, device):
    from xgcm_tpu_torch.entry import build_grid

    return {"grid": build_grid(sizes["nx"], sizes["ny"]), **inputs}


def step(xtt, s, span):
    from xgcm_tpu_torch.entry import step as entry_step

    with span("entry.step"):
        zeta, div, ke_on_theta = entry_step(s["u"], s["v"], s["theta"], s["targets"],
                                            grid=s["grid"])
    return {"zeta": zeta, "div": div, "ke_on_theta": ke_on_theta}


def kernel_work(shapes):
    """{kernel: [(bytes, operations) per launch]} of one step, from the
    inputs' shapes."""
    ny, nx, nz = shapes["theta"]
    m = shapes["targets"][0]
    return {
        "shift": [stencil_work(ny * nx)] * 6,
        "interp_linear": [linear_work(ny * nx, 1, nz, m, broadcast_phi=True)],
    }
