"""Plain reference of the density-space analysis of one face, in plain PyTorch.

Columns run along the last dim; σ on the bounds (n + 1) and on the centres
(n), the fields T, S, u, v on the centres.

Conservative (``G_T``, ``H_*``), into the bins between consecutive
``edges``: cell k spans [min, max] of its two bounds (one NaN bound makes
it a point at the other; two NaN bounds drop it).  A valid cell (kept, its
datum not NaN) puts into each bin its datum times the share of its span
inside the bin, the share of a point cell being 1 in each bin whose closed
interval holds it (lower edge excluded); a bin that no valid cell overlaps
is NaN.

Linear (``F_*``), onto the density ``levels``: each column is read in the
direction in which σ grows (upside-down columns turned over, by the first
and last valid σ), and each level takes the straight line between the two
knots whose half-open interval [σ_k, σ_k+1) holds it, NaN data at either
knot giving NaN; a level at the column's largest σ takes that knot's
datum, and a level outside [min σ, max σ], or in a column with no valid σ,
is NaN (the transform's ``mask_edges``).  Its domain is the columns the
traffic makes, whose σ is monotone with NaN only at the ends; it refuses
any other.

It runs a few rows of the face at a time.
"""

import torch

from benchmark.precision import give, take

FIELDS = ("T", "S", "u", "v")


def conservative(bounds, phis, edges):
    b1, b2 = bounds[:, :-1], bounds[:, 1:]
    n1, n2 = torch.isnan(b1), torch.isnan(b2)
    kept = ~(n1 & n2)
    tmin = torch.where(n1, b2, torch.where(n2, b1, torch.minimum(b1, b2)))
    tmax = torch.where(n1, b2, torch.where(n2, b1, torch.maximum(b1, b2)))
    tmin = torch.where(kept, tmin, 0.0)[:, None, :]
    tmax = torch.where(kept, tmax, 0.0)[:, None, :]
    thick = tmax - tmin
    point = thick == 0
    safe = torch.where(point, 1.0, thick)
    lo, hi = edges[:-1, None], edges[1:, None]  # (bins, 1) against cells (c, 1, n)
    share_hi = torch.where(point, (hi >= tmin).to(tmin.dtype), ((hi - tmin) / safe).clamp(0, 1))
    share_lo = torch.where(point, (lo > tmin).to(tmin.dtype), ((lo - tmin) / safe).clamp(0, 1))
    share = share_hi - share_lo
    del share_hi, share_lo
    overlap = ((tmin <= hi) & ~(tmax < lo)).to(tmin.dtype)
    valid = torch.stack([~torch.isnan(p) & kept for p in phis], -1)  # (c, n, fields)
    data = torch.where(valid, torch.stack(phis, -1), 0.0)
    mass = torch.bmm(share, data)  # (c, bins, fields)
    hits = torch.bmm(overlap, valid.to(tmin.dtype))
    out = torch.where(hits > 0, mass, torch.nan)
    return list(out.unbind(-1))


def linear(sigma, phis, levels):
    c, n = sigma.shape
    valid = ~torch.isnan(sigma)
    k = torch.arange(n, device=sigma.device)
    first = torch.where(valid, k, n).amin(-1, keepdim=True)
    last = torch.where(valid, k, -1).amax(-1, keepdim=True)
    anyv = last >= 0
    s0 = torch.nan_to_num(sigma)
    down = s0.gather(1, last.clamp(min=0)) < s0.gather(1, first.clamp(max=n - 1))
    sign = torch.where(down, -1.0, 1.0).to(sigma.dtype)
    s = torch.where(k < first, -torch.inf, torch.where(k > last, torch.inf, sigma * sign))
    if torch.isnan(s).any() or not bool((s[:, 1:] >= s[:, :-1]).all()):
        raise ValueError("density reference: a column outside its domain (NaN inside, or "
                         "not monotone)")
    t = levels[None, :] * sign  # (c, m) in the direction σ grows
    at = (torch.searchsorted(s.contiguous(), t.contiguous(), right=True) - 1).clamp(0, n - 1)
    nxt = (at + 1).clamp(max=n - 1)
    s_lo, s_hi = s.gather(1, at), s.gather(1, nxt)
    frac = torch.where(nxt > at, (t - s_lo) / (s_hi - s_lo), 0.0)
    frac = torch.where(torch.isfinite(frac), frac, 0.0)
    lo_raw = torch.where(valid, sigma, torch.inf).amin(-1, keepdim=True)
    hi_raw = torch.where(valid, sigma, -torch.inf).amax(-1, keepdim=True)
    top = torch.where(down, first, last)  # the knot of the largest σ
    lv = levels[None, :]
    outs = []
    for phi in phis:
        p_lo, p_hi = phi.gather(1, at), phi.gather(1, nxt)
        out = torch.where(at == last, p_lo, p_lo + frac * (p_hi - p_lo))
        out = torch.where(lv == hi_raw, phi.gather(1, top.clamp(0, n - 1)), out)
        out = torch.where((lv < lo_raw) | (lv > hi_raw) | ~anyv, torch.nan, out)
        outs.append(out)
    return outs


def blocks(inputs, precision, rows=8):
    def t(a):
        return take(a, precision)

    ny, nx, n = inputs["T"].shape
    edges, levels = t(inputs["edges"]), t(inputs["levels"])
    for r in range(0, ny, rows):
        sl = (slice(r, r + rows),)

        def cols(name):
            a = inputs[name][r:r + rows]
            return t(a.reshape(-1, a.shape[-1]))

        def back(out):
            return give(out.reshape(-1, nx, out.shape[-1]), precision)

        phis = [cols(f) for f in FIELDS]
        binned = conservative(cols("sigma_b"), phis, edges)
        yield "G_T", sl, back(binned[0])  # one field alone bins as it does among four
        for f, h in zip(FIELDS, binned):
            yield f"H_{f}", sl, back(h)
        del binned
        for f, lin in zip(FIELDS, linear(cols("sigma_c"), phis, levels)):
            yield f"F_{f}", sl, back(lin)
