"""The one generator of every cell's inputs.

A traffic file lists its inputs as ``{"name", "kind", ...}`` entries; each
kind is a function here that draws one input (or, for ``density``, a set)
from the run's ``torch.Generator`` on the device.  Shapes name the
configuration's sizes (``"ny"``, ``"nz"``, ...), so one traffic file serves
every configuration it is paired with.  Entries are drawn in the order the
file lists them: the same seed gives the same inputs.

The column recipes are those of ``chip_smoke.columns`` and
``chip_smoke.density_columns`` (the examples' own), with the bands of
special columns read from the traffic file instead of fixed.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_inputs", "shape_of"]


def shape_of(spec, sizes) -> tuple:
    """A list of size names or integers as a shape."""
    return tuple(int(sizes[d]) if isinstance(d, str) else int(d) for d in spec)


def _bands(e):
    """(lo, hi) of each band of special columns, laid end to end from 0
    in the order descending, NaN tail, NaN head, NaN datum; land is the top
    ``land`` share."""
    out, lo = {}, 0.0
    for key in ("descending", "nan_tail", "nan_head", "nan_datum"):
        share = e.get(key, 0.0)
        share = share[0] if isinstance(share, list) else share
        out[key] = (lo, lo + share)
        lo += share
    out["land"] = (1.0 - e.get("land", 0.0), 2.0)
    return out


def _in(r, band):
    return (r >= band[0]) & (r < band[1])


def _normal(e, sizes, gen, dev):
    x = torch.randn(shape_of(e["shape"], sizes), generator=gen, device=dev)
    x.mul_(e.get("scale", 1.0)).add_(e.get("offset", 0.0))
    return _finish(e, x)


def _uniform(e, sizes, gen, dev):
    x = torch.rand(shape_of(e["shape"], sizes), generator=gen, device=dev)
    x.mul_(e.get("scale", 1.0)).add_(e.get("offset", 0.0))
    return _finish(e, x)


def _finish(e, x):
    if e.get("zero_first"):
        x[0] = 0.0  # w = 0 on the surface face
    if e.get("nonfinite_face_edges"):
        # NaN, +inf and -inf on the halo sources of the X-left, Y-right,
        # X-right and Y-left edges of faces 0, 6, 9 and 12 of (13, n, n)
        n = x.shape[-1]
        x[..., 0, 5, 0] = float("nan")
        x[..., 6, n - 1, 9] = float("inf")
        x[..., 9, 3, n - 1] = -float("inf")
        x[..., 12, 0, n - 3] = float("nan")
    return x


def _columns(e, sizes, gen, dev):
    """Monotone theta columns (cols..., n): increments U(0, 1) + 0.01 scaled
    so that a column spans what ``span_levels`` levels span, then the bands:
    stored upside down, a NaN tail of k levels, a NaN head of k levels, all
    NaN (land)."""
    lead = shape_of(e["cols"], sizes)
    n = int(sizes[e["levels"]])
    cols = math.prod(lead)
    scale = e.get("span_levels", n) / n
    th = torch.rand((cols, n), generator=gen, device=dev).add_(0.01).mul_(scale)
    th = torch.cumsum(th, -1)
    r = torch.rand((cols,), generator=gen, device=dev)
    b = _bands(e)
    k = torch.arange(n, device=dev)
    th = torch.where(_in(r, b["descending"])[:, None], th.flip(-1), th)
    if "nan_tail" in e:
        th.masked_fill_(_in(r, b["nan_tail"])[:, None] & (k >= n - e["nan_tail"][1]), math.nan)
    if "nan_head" in e:
        th.masked_fill_(_in(r, b["nan_head"])[:, None] & (k < e["nan_head"][1]), math.nan)
    th.masked_fill_(_in(r, b["land"])[:, None], math.nan)
    return th.reshape(lead + (n,))


def _density(e, sizes, gen, dev):
    """Potential density minus 1000 kg/m^3 on bounds (cols..., n + 1) and
    centres (cols..., n), rising with depth from ``start`` by steps of
    U(lo, hi) scaled so that a column spans what ``span_levels`` levels
    span; the bands as in ``_columns`` (on the bounds), one NaN datum of
    the first field at level n // 2 in its band; and the fields, each
    U(0, 1) * scale + offset (T, S, u, v)."""
    lead = shape_of(e["cols"], sizes)
    n = int(sizes[e["levels"]])
    cols = math.prod(lead)
    r = torch.rand((cols,), generator=gen, device=dev)
    scale = e.get("span_levels", n) / n
    lo, hi = e["step"]
    sig_b = torch.rand((cols, n + 1), generator=gen, device=dev).mul_((hi - lo) * scale)
    sig_b.add_(lo * scale)
    sig_b = torch.cumsum(sig_b, -1).add_(e["start"])
    b = _bands(e)
    desc = _in(r, b["descending"])
    sig_b[desc] = sig_b[desc].flip(-1)
    k = torch.arange(n + 1, device=dev)
    sig_b.masked_fill_(_in(r, b["nan_tail"])[:, None] & (k >= n + 1 - e["nan_tail"][1]),
                       math.nan)
    sig_b.masked_fill_(_in(r, b["nan_head"])[:, None] & (k < e["nan_head"][1]), math.nan)
    sig_b.masked_fill_(_in(r, b["land"])[:, None], math.nan)
    sig_c = (sig_b[:, :-1] + sig_b[:, 1:]).mul_(0.5)
    out = {e["bounds"]: sig_b.reshape(lead + (n + 1,)), e["centres"]: sig_c.reshape(lead + (n,))}
    for i, (name, (a, c)) in enumerate(e["fields"].items()):
        f = torch.rand((cols, n), generator=gen, device=dev).mul_(a).add_(c)
        if i == 0:
            f.masked_fill_(_in(r, b["nan_datum"])[:, None] & (k[:n] == n // 2), math.nan)
        out[name] = f.reshape(lead + (n,))
    return out


def _linspace(e, sizes, gen, dev):
    return torch.linspace(e["start"], e["stop"], int(e["num"]), device=dev)


KINDS = {
    "normal": _normal,
    "uniform": _uniform,
    "columns": _columns,
    "density": _density,
    "linspace": _linspace,
}


def make_inputs(entries, sizes, gen, dev) -> dict:
    """{name: tensor} of a traffic file's ``inputs``, drawn in order."""
    out = {}
    for e in entries:
        made = KINDS[e["kind"]](e, sizes, gen, dev)
        if isinstance(made, dict):
            out.update(made)
        else:
            out[e["name"]] = made
    return out
