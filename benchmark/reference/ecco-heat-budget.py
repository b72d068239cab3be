"""Plain reference of the ECCO v4r4 heat budget, in plain PyTorch.

The terms of the ECCOv4-py tutorial "ECCO v4 heat budget closure", on
fields laid out as the v4r4 native files, (time, k, tile, j, i): 13 tiles
of L x L columns, the horizontal fluxes on the tiles' left faces (i_g,
j_g), the vertical ones on the levels' top faces (k_l).

* G_total = (s[t + 1] - s[t]) / dt[t], s = THETA_snp (1 + ETAN_snp / Depth);
* G_advection = (-(x + y) + r) / (rA drF hFacC), where
  x = ADVx_TH[i + 1] - ADVx_TH[i], y = ADVy_TH[j + 1] - ADVy_TH[j] and
  r = ADVr_TH[k + 1] - ADVr_TH[k], with 0 below the bottom level;
* G_diffusion: the same on DFxE_TH, DFyE_TH, and r = the difference of
  DFrE_TH plus that of DFrI_TH (the tutorial's two diffs);
* G_forcing = forcH / (rho0 cp hFacC drF): below the surface
  forcH[k] = (q1[k] wet[k] - q2[k] wet[k + 1]) oceQsw, at it
  (TFLUX - (1 - (q1[0] - q2[0])) oceQsw) wet[0], where q1 and q2 are the
  shares of the surface shortwave at each level's top and bottom face,
  R exp(z / zeta1) + (1 - R) exp(z / zeta2), q1 cut to 0 from the first
  level whose centre lies below 200 m, q2 from the level above it.

Departure from the tutorial: GEOFLX, the geothermal flux into the bottom
cell, is left out, as the recipe leaves it out.

The halo of a tile, the line beyond its right edge along X or Y, is the
neighbour's edge line by the connections of ``llc_connections.json``, by
the rule that ``face-analysis.py``'s docstring states: across a connection
``[neighbour, axis, reverse]`` the neighbour's right edge when the
connection is reversed and its left edge when it is not, read in the
opposite tangential order where the two tiles' axes differ and the
connection is not reversed; a vector component parallel to the edge's axis
changes sign across a reversed connection, the other one where the axes
differ and the connection is not reversed, and there the halo is read from
the partner component.  An edge with no connection takes 0 (``boundary``
``fill``).

It runs a block of months at a time, in float64 (the reference) or as
``precision.py``'s control.
"""

import json
import pathlib

import torch

from benchmark.precision import give, take

CONNECTIONS = json.loads((pathlib.Path(__file__).with_name("llc_connections.json"))
                         .read_text())["face"]
RHO0, CP = 1029.0, 3994.0
R, ZETA1, ZETA2, Z_CUT = 0.62, 0.6, 20.0, -200.0


def _edge(face, axis, right):
    """The edge line of (..., L, L) tiles, in increasing tangential order."""
    if axis == "X":
        return face[..., :, -1] if right else face[..., :, 0]
    return face[..., -1, :] if right else face[..., 0, :]


def right_halo(arr, f, axis, component, partner):
    """The line beyond the right edge along ``axis`` of tile f of ``arr``
    (..., tiles, L, L), the vector component along ``component`` whose
    partner is ``partner``."""
    conn = CONNECTIONS[str(f)][axis][1]
    if conn is None:
        return torch.zeros_like(_edge(arr[..., f, :, :], axis, True))
    src, src_axis, reverse = conn
    swap = src_axis != axis
    source = partner if swap else arr
    line = _edge(source[..., src, :, :], src_axis, reverse)
    if swap and not reverse:
        line = line.flip(-1)
    if (reverse if component == axis else (swap and not reverse)):
        line = -line
    return line


def horizontal_diff(fx, fy):
    """(x, y): fx[i + 1] - fx[i] and fy[j + 1] - fy[j] on every tile, the
    halos from the neighbour tiles."""
    x = torch.empty_like(fx)
    y = torch.empty_like(fy)
    for f in range(fx.shape[-3]):
        hx = right_halo(fx, f, "X", "X", fy)
        hy = right_halo(fy, f, "Y", "Y", fx)
        tx, ty = fx[..., f, :, :], fy[..., f, :, :]
        x[..., f, :, :] = torch.cat([tx[..., :, 1:], hx[..., :, None]], -1) - tx
        y[..., f, :, :] = torch.cat([ty[..., 1:, :], hy[..., None, :]], -2) - ty
    return x, y


def vertical_diff(fr):
    """fr[k + 1] - fr[k] along the levels (dim 1), 0 below the bottom."""
    below = torch.cat([fr[:, 1:], torch.zeros_like(fr[:, :1])], 1)
    return below - fr


def shortwave_profile(drf):
    """(q1, q2) on the levels, float64, cut as the tutorial cuts them."""
    zp1 = torch.cat([torch.zeros(1, dtype=drf.dtype, device=drf.device), -torch.cumsum(drf, 0)])
    z = 0.5 * (zp1[:-1] + zp1[1:])
    q = R * torch.exp(zp1 / ZETA1) + (1.0 - R) * torch.exp(zp1 / ZETA2)
    q1, q2 = q[:-1].clone(), q[1:].clone()
    below = torch.nonzero(z < Z_CUT).flatten()
    cut = int(below[0]) if below.numel() else drf.numel()
    q1[cut:] = 0.0
    q2[cut - 1:] = 0.0
    return q1, q2


def blocks(inputs, precision, months=6):
    def t(a):
        return take(a, precision)

    hfacc, depth, ra, drf = (t(inputs[k]) for k in ("hFacC", "Depth", "rA", "drF"))
    dt = t(inputs["dt"])
    nt = inputs["ADVx_TH"].shape[0]
    col = (slice(None), None, None, None)
    vol = ra * drf[col] * hfacc
    heat = RHO0 * CP * hfacc * drf[col]
    wet = (hfacc > 0).to(hfacc.dtype)
    wet_below = torch.cat([wet[1:], torch.zeros_like(wet[:1])], 0)
    q1, q2 = (q.to(hfacc.dtype) for q in shortwave_profile(drf.to(torch.float64)))
    for t0 in range(0, nt, months):
        t1 = min(nt, t0 + months)
        index = (slice(t0, t1),)
        s = t(inputs["THETA_snp"][t0:t1 + 1]) * (
            1.0 + t(inputs["ETAN_snp"][t0:t1 + 1])[:, None] / depth)
        yield "G_total", index, give((s[1:] - s[:-1]) / dt[t0:t1, None, None, None, None],
                                     precision)
        del s
        for term, (fx, fy, frs) in {
            "G_advection": ("ADVx_TH", "ADVy_TH", ("ADVr_TH",)),
            "G_diffusion": ("DFxE_TH", "DFyE_TH", ("DFrE_TH", "DFrI_TH")),
        }.items():
            x, y = horizontal_diff(t(inputs[fx][t0:t1]), t(inputs[fy][t0:t1]))
            h = -(x + y)
            del x, y
            for fr in frs:
                h = h + vertical_diff(t(inputs[fr][t0:t1]))
            yield term, index, give(h / vol, precision)
            del h
        qsw = t(inputs["oceQsw"][t0:t1])[:, None]
        forc = (q1[col] * wet - q2[col] * wet_below) * qsw
        forc[:, 0] = (t(inputs["TFLUX"][t0:t1]) - (1.0 - (q1[0] - q2[0])) * qsw[:, 0]) * wet[0]
        yield "G_forcing", index, give(forc / heat, precision)
        del forc, qsw
