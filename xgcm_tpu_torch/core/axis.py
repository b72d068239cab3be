"""Axis: one staggered grid direction.

Reimplements the behaviour of reference ``axis.py:17-209`` (position→dim
mapping, default-shift inference, per-axis boundary/fill-value defaults) for
the :class:`~xgcm_tpu_torch.core.dataset.Dataset` container.  An Axis is
pure static metadata.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

from .dataarray import GriddedArray
from .dataset import Dataset

__all__ = ["Axis", "VALID_POSITIONS", "FALLBACK_SHIFTS", "VALID_BOUNDARIES"]

VALID_POSITIONS = ("center", "left", "right", "inner", "outer")

# Order in which to search for a default shift target when the user supplies
# none (mirrors reference axis.py:8-14).
FALLBACK_SHIFTS = {
    "center": ("left", "right", "outer", "inner"),
    "left": ("center",),
    "right": ("center",),
    "outer": ("center",),
    "inner": ("center",),
}

# Allowed boundary-condition flags; None means "default" which resolves to
# periodic (reference padding.py:15-20 maps None -> wrap).  `extrapolate`
# (linear extrapolation from the two edge cells) goes beyond the reference's
# surface per the BASELINE.json north star.
VALID_BOUNDARIES = ("periodic", "fill", "extend", "extrapolate", None)


class Axis:
    """A single direction along a model grid, holding possibly several cell
    positions (center/left/right/inner/outer), each tied to a dimension name.
    """

    def __init__(
        self,
        ds: Dataset,
        name: str,
        coords: Mapping[str, str],
        default_shifts: Optional[Mapping[str, str]] = None,
        boundary: Optional[str] = None,
        fill_value: Optional[float] = None,
    ):
        if not isinstance(name, str):
            raise TypeError(
                f"name argument must be of type str, but is of type {type(name)}"
            )
        if not isinstance(ds, Dataset):
            raise TypeError(
                f"ds argument must be of type xgcm_tpu_torch.Dataset, "
                f"but is of type {type(ds)}"
            )
        self._name = name

        for pos, dim in coords.items():
            if pos not in VALID_POSITIONS:
                raise ValueError(
                    f"Axis position must be one of {list(VALID_POSITIONS)}, "
                    f"but got {pos}"
                )
            if dim not in ds.dims:
                raise ValueError(
                    f"Could not find dimension `{dim}` (for the `{pos}` position "
                    f"on axis `{name}`) in input dataset."
                )
        self._coords = dict(coords)

        # Infer default shifts position-by-position (reference axis.py:100-115).
        default_shifts = dict(default_shifts) if default_shifts else {}
        self._default_shifts = {}
        for pos in self._coords:
            if pos in default_shifts:
                self._default_shifts[pos] = default_shifts[pos]
            else:
                for candidate in FALLBACK_SHIFTS[pos]:
                    if candidate in self._coords:
                        self._default_shifts[pos] = candidate
                        break
            if pos in self._default_shifts and self._default_shifts[pos] == pos:
                raise ValueError(
                    f"Can't set the default shift for {pos} to be to {pos}"
                )

        if boundary is None:
            boundary = "periodic"
        if boundary not in VALID_BOUNDARIES:
            raise ValueError(
                f"boundary must be one of {VALID_BOUNDARIES}, but got {boundary}"
            )
        self._boundary = boundary

        if fill_value is None:
            fill_value = 0.0
        if not isinstance(fill_value, (int, float)):
            raise TypeError("fill value must be an integer or a float")
        self._fill_value = fill_value

        # face-connection info is attached by Grid._assign_face_connections
        self._facedim: Optional[str] = None
        self._face_connections = None

    # -- properties --------------------------------------------------------
    @property
    def name(self) -> str:
        return self._name

    @property
    def coords(self) -> Mapping[str, str]:
        return self._coords

    @property
    def default_shifts(self) -> Mapping[str, str]:
        return self._default_shifts

    @property
    def boundary(self) -> str:
        return self._boundary

    @property
    def fill_value(self) -> float:
        return self._fill_value

    @property
    def periodic(self) -> bool:
        return self._boundary == "periodic"

    # -- position lookup (reference axis.py:183-207) -----------------------
    def _get_position_name(self, da: GriddedArray) -> Tuple[str, str]:
        """Return (position, dim-name) of this axis within `da`."""
        axis_dims = set(self._coords.values())
        candidates = set(da.dims) & axis_dims
        if len(candidates) == 0:
            raise KeyError(
                f"None of the array's dims {da.dims} were found in axis coords."
            )
        if len(candidates) > 1:
            raise KeyError(
                f"Array cannot have more than 1 axis dimension, "
                f"but found {candidates}"
            )
        for position, dim in self._coords.items():
            if dim in da.dims:
                return position, dim
        raise AssertionError("unreachable")

    def _get_axis_dim_num(self, da: GriddedArray) -> int:
        _, dim = self._get_position_name(da)
        return da.get_axis_num(dim)

    def __repr__(self):
        state = "periodic" if self.periodic else "not periodic"
        lines = [f"<xgcm_tpu_torch.Axis '{self._name}' ({state}, boundary={self._boundary!r})>"]
        lines.append("Axis Coordinates:")
        lines += self._coord_desc()
        return "\n".join(lines)

    def _coord_desc(self):
        out = []
        for pos, dim in self._coords.items():
            info = "  * %-8s %s" % (pos, dim)
            if pos in self._default_shifts:
                info += " --> %s" % self._default_shifts[pos]
            out.append(info)
        return out
