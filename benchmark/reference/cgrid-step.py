"""Plain reference of the C-grid analysis step, in plain PyTorch.

On a doubly periodic C-grid with u on (yc, xg) and v on (yg, xc):

* ζ on the corners: (v[j, i] - v[j, i-1]) - (u[j, i] - u[j-1, i]);
* divergence on the centres: (u[j, i+1] - u[j, i]) + (v[j+1, i] - v[j, i]);
* kinetic energy on the centres: ½ (u_c² + v_c²), u_c = ½ (u[j, i] + u[j, i+1]),
  v_c = ½ (v[j, i] + v[j+1, i]);
* the kinetic energy remapped onto the θ surfaces of its column by linear
  interpolation with np.interp's clamps at the column's ends and no mask:
  the energy is the same at every knot of the column, so every surface
  takes it, and a column with no valid θ gives NaN.
"""

import torch

from benchmark.precision import give, take


def blocks(inputs, precision, rows=540):
    u, v = take(inputs["u"], precision), take(inputs["v"], precision)
    zeta = (v - torch.roll(v, 1, 1)) - (u - torch.roll(u, 1, 0))
    yield "zeta", (slice(None),), give(zeta, precision)
    del zeta
    div = (torch.roll(u, -1, 1) - u) + (torch.roll(v, -1, 0) - v)
    yield "div", (slice(None),), give(div, precision)
    del div
    u_c = 0.5 * (u + torch.roll(u, -1, 1))
    v_c = 0.5 * (v + torch.roll(v, -1, 0))
    ke = give(0.5 * (u_c * u_c + v_c * v_c), precision)
    del u_c, v_c
    theta = inputs["theta"]
    m = inputs["targets"].shape[0]
    for r in range(0, theta.shape[0], rows):
        has_valid = (~torch.isnan(theta[r:r + rows])).any(-1, keepdim=True)
        out = torch.where(has_valid, ke[r:r + rows, :, None], torch.nan)
        yield "ke_on_theta", (slice(r, r + rows),), out.expand(-1, -1, m)
