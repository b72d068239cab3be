"""The ECCO v4r4 heat budget of the ECCOv4-py tutorial "ECCO v4 heat budget
closure", on ``grids.ecco_llc_grid``: months of the record a step, every
tile, level and face connection.

* G_total: the tendency of THETA (1 + ETAN / Depth) between consecutive
  snapshots, ``grid.diff`` along T, over the months' lengths;
* G_advection: the horizontal convergence of (ADVx_TH, ADVy_TH) by
  ``grid.diff_2d_vector`` across the 13 tiles (kernel E, twice) plus the
  vertical convergence of ADVr_TH by ``grid.diff`` along Z (kernel A),
  over the cell volume rA drF hFacC;
* G_diffusion: the same on DFxE_TH, DFyE_TH and DFrE_TH + DFrI_TH (one Z
  diff of the sum: the diff is linear);
* G_forcing: TFLUX at the surface and the shortwave oceQsw spread down by
  the two-exponential profile, over rho0 cp hFacC drF.

The convergences are written ``(vertical - (x + y)) / vol``, the
tutorial's ``(-(x + y) + vertical) / vol`` with the negation folded into
the sum: the same IEEE results in one pass fewer.  Each intermediate is
dropped once it is used.  Departure from the tutorial: GEOFLX, the
geothermal flux into the bottom cell, is left out (a static file the
repository does not have).

Set-up derives the grid's static fields from the seed's draws (land, the
depth of each wet column, its partial bottom cell), zeroes every field on
land as the v4r4 files are, and hands the static fields to the reference
through ``inputs``.
"""

import calendar
import math
import warnings

import numpy as np
import torch

from benchmark.roofline import stencil_work

LAUNCHES = {"face_shift": 4, "shift": 2}

# ECCO v4's 50 level thicknesses (m), 6134.5 m in all
DRF = (10.0, 10.0, 10.0, 10.0, 10.0, 10.0, 10.0, 10.01, 10.03, 10.11, 10.32, 10.8, 11.76, 13.42,
       16.04, 19.82, 24.85, 31.1, 38.42, 46.5, 55.0, 63.5, 71.58, 78.9, 85.15, 90.18, 93.96, 96.58,
       98.25, 99.25, 100.01, 101.33, 104.56, 111.33, 122.83, 139.09, 158.94, 180.83, 203.55,
       226.5, 249.5, 272.5, 295.5, 318.5, 341.5, 364.5, 387.5, 410.5, 433.5, 456.5)
LAND = 0.3  # the share of land columns
MIN_LEVELS = 5  # the fewest levels of a wet column
RHO0, CP = 1029.0, 3994.0
R, ZETA1, ZETA2, Z_CUT = 0.62, 0.6, 20.0, -200.0  # the shortwave profile

FLUXES = {
    "ADVx_TH": ("time", "k", "tile", "j", "i_g"), "ADVy_TH": ("time", "k", "tile", "j_g", "i"),
    "ADVr_TH": ("time", "k_l", "tile", "j", "i"), "DFxE_TH": ("time", "k", "tile", "j", "i_g"),
    "DFyE_TH": ("time", "k", "tile", "j_g", "i"), "DFrE_TH": ("time", "k_l", "tile", "j", "i"),
    "DFrI_TH": ("time", "k_l", "tile", "j", "i"),
}
CENTRED = {
    "THETA_snp": ("time_snp", "k", "tile", "j", "i"), "ETAN_snp": ("time_snp", "tile", "j", "i"),
    "TFLUX": ("time", "tile", "j", "i"), "oceQsw": ("time", "tile", "j", "i"),
}


def month_seconds(nt):
    """The lengths in seconds of ``nt`` months from January 1992."""
    return [calendar.monthrange(1992 + m // 12, m % 12 + 1)[1] * 86400.0 for m in range(nt)]


def shortwave_profile(drf):
    """(q1, q2): the share of the surface shortwave that reaches the top
    and the bottom face of each level, float64, cut to 0 below 200 m as the
    tutorial cuts it (at the bottom where no level lies below 200 m)."""
    zp1 = np.concatenate([[0.0], -np.cumsum(drf)])
    z = 0.5 * (zp1[:-1] + zp1[1:])
    q = R * np.exp(zp1 / ZETA1) + (1.0 - R) * np.exp(zp1 / ZETA2)
    q1, q2 = q[:-1].copy(), q[1:].copy()
    below = np.flatnonzero(z < Z_CUT)
    cut = int(below[0]) if below.size else len(drf)
    q1[cut:] = 0.0
    q2[cut - 1:] = 0.0
    return q1, q2


def setup(xtt, sizes, inputs, device):
    n, nz, nt = sizes["nx"], sizes["nz"], sizes["nt"]
    faces = sizes["faces"]
    drf = torch.tensor(DRF[:nz], dtype=torch.float64, device=device)
    # the grid's static fields from the draws
    lo = min(MIN_LEVELS, nz)
    levels = lo + torch.floor(inputs["depth_draw"] * (nz - lo + 1)).clamp_(max=nz - lo)
    levels = torch.where(inputs["land_draw"] < LAND, 0.0, levels)  # (tile, j, i)
    k = torch.arange(nz, device=device, dtype=levels.dtype)[:, None, None, None]
    bottom = 0.2 + 0.8 * inputs["bottom_draw"]
    hfacc = torch.where(k < levels - 1, 1.0, torch.where(k == levels - 1, bottom, 0.0))
    hfacc = hfacc.to(torch.float32)
    depth = (hfacc.double() * drf[:, None, None, None]).sum(0).to(torch.float32)
    jj = (torch.arange(n, device=device, dtype=torch.float64) + 0.5) / n
    tile = torch.arange(faces, device=device, dtype=torch.float64)[:, None, None]
    s = 0.5 * (1.0 + torch.sin(math.pi * jj)[:, None] * torch.cos(2 * math.pi * jj[None, :] + tile))
    ra = (10.0 ** (8.0 + 2.0 * s)).to(torch.float32)
    dt = torch.tensor(month_seconds(nt), dtype=torch.float32, device=device)

    _, grid = xtt.grids.ecco_llc_grid(
        n=n, nz=nz, nt=nt, rA=ra.cpu().numpy(), drF=drf.float().cpu().numpy(),
        hFacC=hfacc.cpu().numpy(), Depth=depth.cpu().numpy())
    # zero every field on land, as the v4r4 files are: the tracer points
    # where hFacC is 0, a face flux where either cell beside it is dry, a
    # vertical flux at the sea surface (TFLUX carries it)
    wet = hfacc > 0
    h = xtt.GriddedArray(hfacc, ("k", "tile", "j", "i"))
    wet_w = grid.min(h, "X", boundary="fill", fill_value=0.0).data > 0
    wet_s = grid.min(h, "Y", boundary="fill", fill_value=0.0).data > 0
    wet_l = wet.clone()
    wet_l[1:] &= wet[:-1]
    wet_l[0] = False
    face_mask = {"i_g": wet_w, "j_g": wet_s, "k_l": wet_l}
    for name, dims in FLUXES.items():
        mask = next(face_mask[d] for d in dims if d in face_mask)
        inputs[name].mul_(mask)
    inputs["THETA_snp"].mul_(wet)
    for name in ("ETAN_snp", "TFLUX", "oceQsw"):
        inputs[name].mul_(wet[0])
    inputs.update(hFacC=hfacc, Depth=depth, rA=ra, drF=drf.to(torch.float32), dt=dt)

    # the static factors of the budget, once, as the tutorial computes them
    q1, q2 = (torch.tensor(q, device=device) for q in shortwave_profile(DRF[:nz]))
    wet_below = torch.zeros_like(wet)
    wet_below[:-1] = wet[1:]
    share = q1[:, None, None, None] * wet - q2[:, None, None, None] * wet_below
    share[0] = -(1.0 - (q1[0] - q2[0])) * wet[0]  # the surface keeps TFLUX less what sinks
    vol = ra * drf.float()[:, None, None, None] * hfacc
    heat = RHO0 * CP * hfacc * drf.float()[:, None, None, None]
    static = ("k", "tile", "j", "i")
    return {
        "grid": grid,
        **{name: xtt.GriddedArray(inputs[name], dims, name=name)
           for name, dims in {**FLUXES, **CENTRED}.items()},
        "Depth": xtt.GriddedArray(depth, ("tile", "j", "i")),
        "dt": xtt.GriddedArray(dt, ("time",)),
        "vol": xtt.GriddedArray(vol, static),
        "heat": xtt.GriddedArray(heat, static),
        "share": xtt.GriddedArray(share.to(torch.float32), static),
        "wet_top": xtt.GriddedArray(wet[0].to(torch.float32), ("tile", "j", "i")),
    }


def step(xtt, s, span):
    grid = s["grid"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        # total tendency between snapshots
        with span("arith"):
            s_theta = s["THETA_snp"] * (1.0 + s["ETAN_snp"] / s["Depth"])
        with span("grid.diff"):
            d = grid.diff(s_theta, "T", boundary="fill")
        del s_theta
        with span("arith"):
            g_total = d / s["dt"]
        del d
        # advection and diffusion: horizontal convergence across the tiles,
        # vertical convergence down the levels
        out = {}
        for term, (fx, fy, fr) in {
            "G_advection": ("ADVx_TH", "ADVy_TH", ("ADVr_TH",)),
            "G_diffusion": ("DFxE_TH", "DFyE_TH", ("DFrE_TH", "DFrI_TH")),
        }.items():
            with span("grid.diff_2d_vector"):
                h = grid.diff_2d_vector({"X": s[fx], "Y": s[fy]}, boundary="fill")
            with span("arith"):
                h_sum = h["X"] + h["Y"]
            del h
            flux_r = s[fr[0]]
            if len(fr) > 1:
                with span("arith"):
                    flux_r = flux_r + s[fr[1]]
            with span("grid.diff"):
                v = grid.diff(flux_r, "Z", boundary="fill")
            del flux_r
            with span("arith"):
                conv = v - h_sum
            del v, h_sum
            with span("arith"):
                out[term] = conv / s["vol"]
            del conv
        # forcing: the surface flux and the shortwave spread down the levels
        with span("arith"):
            forc = s["oceQsw"].expand_dims("k", axis=1) * s["share"]
            forc.data[:, 0] += (s["TFLUX"] * s["wet_top"]).data
            g_forcing = forc / s["heat"]
        del forc
    return {"G_total": g_total.data, "G_advection": out["G_advection"].data,
            "G_diffusion": out["G_diffusion"].data, "G_forcing": g_forcing.data}


def kernel_work(shapes):
    """{kernel: [(bytes, operations) per launch]} of one step: four launches
    of E over the months' horizontal fluxes, each with one halo line per
    tile, row and level, and two of A over their vertical ones."""
    nt, nz, faces, ny, nx = shapes["ADVx_TH"]
    points = nt * nz * faces * ny * nx
    return {"face_shift": [stencil_work(points, halo_points=nt * nz * faces * ny)] * 4,
            "shift": [stencil_work(points)] * 2}
