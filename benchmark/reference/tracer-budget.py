"""Plain reference of the tracer budget of one face, in plain PyTorch.

θ on the centres (zc, yc, xc), u on (zc, yc, xg), v on (zc, yg, xc), w on
(zg, yc, xc); 1-D metrics dx, dy, dz on the centres.  X and Y are periodic;
along Z the interpolation extends θ above the top level and the difference
takes 0 below the bottom face.

* θ on the X faces ½ (θ[i-1] + θ[i]), on the Y faces ½ (θ[j-1] + θ[j]), on
  the Z faces ½ (θ[k-1] + θ[k]) with θ[-1] = θ[0];
* fluxes: u θ_x dy dz, v θ_y dx dz, w θ_z dx dy;
* div = (fx[i+1] - fx[i]) + (fy[j+1] - fy[j]) + (fz[k+1] - fz[k]),
  fz[nz] = 0;
* vol = dx dy dz, tendency = -div / vol;
* scale = Σ |tendency| vol, the closure's second integral.  Its first,
  total = Σ tendency vol, is not compared: the flux form telescopes to
  round-off in any precision, so no control reads it higher than the
  program does.

It runs a few levels at a time.
"""

import torch

from benchmark.precision import give, take


def blocks(inputs, precision, levels=6):
    def t(a):
        return take(a, precision)

    theta, u, v, w = (inputs[k] for k in ("theta", "u", "v", "w"))
    dx, dy, dz = t(inputs["dx_c"]), t(inputs["dy_c"]), t(inputs["dz_c"])
    nz = theta.shape[0]
    area_xy = dy[:, None] * dx[None, :]
    scale = 0.0
    for k0 in range(0, nz, levels):
        k1 = min(nz, k0 + levels)
        th = t(theta[k0:k1])
        dzk = dz[k0:k1, None, None]
        fx = t(u[k0:k1]) * (0.5 * (torch.roll(th, 1, 2) + th)) * (dy[None, :, None] * dzk)
        div = torch.roll(fx, -1, 2) - fx
        del fx
        fy = t(v[k0:k1]) * (0.5 * (torch.roll(th, 1, 1) + th)) * (dx[None, None, :] * dzk)
        div = div + (torch.roll(fy, -1, 1) - fy)
        del fy
        # θ on the Z faces k0 .. k1 (the last only inside the column)
        top = min(k1 + 1, nz)
        below = t(theta[max(k0 - 1, 0):top - 1]) if k0 > 0 else torch.cat(
            [th[:1], t(theta[0:top - 1])], 0)
        th_z = 0.5 * (below + t(theta[k0:top]))
        fz = t(w[k0:top]) * th_z * area_xy
        del th_z, below
        if top == k1:  # the bottom face: nothing flows through it
            fz = torch.cat([fz, torch.zeros_like(fz[:1])], 0)
        div = div + (fz[1:] - fz[:-1])
        del fz
        vol = area_xy[None] * dzk
        tendency = -div / vol
        yield "div", (slice(k0, k1),), give(div, precision)
        yield "vol", (slice(k0, k1),), give(vol.expand_as(div), precision)
        yield "tendency", (slice(k0, k1),), give(tendency, precision)
        scale = scale + (tendency.abs() * vol).sum()
        del div, vol, tendency
    yield "scale", (), give(torch.as_tensor(scale), precision)
