"""The comparison that decides ``correct``.

A cell's reference module yields its answers block by block, ``(name,
index, values)``, computed from the same inputs the program was given; the
program's output ``name`` at ``index`` is held against each block.  Per
output, the number compared is the largest gap where both are finite over
the largest finite reference value of that output; over all outputs, the
count of elements whose NaN or infinity the program puts elsewhere than
the reference.

The reference runs in float64 (``"f64"``).  The control puts the reference
in the program's place in the precision below float32 (``"bf16"``: inputs
and results rounded to bfloat16, arithmetic in float32, as the port's
16-bit kernels do), and is held to the same float64 reference.
"""

from __future__ import annotations

import torch

NONFINITE = "nonfinite_mismatch"


class Tally:
    """Largest gap and largest reference value per output, and the count
    of non-finite mismatches."""

    def __init__(self):
        self.gap, self.ref, self.mismatch = {}, {}, 0

    def add(self, name, got, want):
        got = got.to(torch.float64)
        want = want.to(torch.float64)
        if got.shape != want.shape:
            raise ValueError(f"{name}: program gives {tuple(got.shape)}, reference "
                             f"{tuple(want.shape)}")
        both = torch.isfinite(got) & torch.isfinite(want)
        self.mismatch += int((~both & ~(got == want) & ~(got.isnan() & want.isnan())).sum())
        gap = torch.where(both, (got - want).abs(), 0.0)
        ref = torch.where(torch.isfinite(want), want.abs(), 0.0)
        self.gap[name] = max(self.gap.get(name, 0.0), float(gap.max()) if gap.numel() else 0.0)
        self.ref[name] = max(self.ref.get(name, 0.0), float(ref.max()) if ref.numel() else 0.0)

    def numbers(self) -> dict:
        out = {}
        for name, gap in self.gap.items():
            scale = self.ref[name]
            out[f"{name}_err"] = gap / scale if scale > 0 else gap
        out[NONFINITE] = float(self.mismatch)
        return out


def compare_outputs(outputs, inputs, reference) -> dict:
    """The numbers of the program's ``outputs`` against the reference."""
    tally = Tally()
    for name, index, want in reference.blocks(inputs, "f64"):
        tally.add(name, outputs[name][index], want)
    return tally.numbers()


def compare_control(inputs, reference) -> dict:
    """The numbers of the control: the reference in bfloat16, block by
    block, against the reference in float64."""
    tally = Tally()
    for (name, index, want), (name2, index2, got) in zip(
            reference.blocks(inputs, "f64"), reference.blocks(inputs, "bf16")):
        if (name, index) != (name2, index2):
            raise RuntimeError("the control's blocks do not follow the reference's")
        tally.add(name, got, want)
    return tally.numbers()


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}); a number with no limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            ok = False
    return ok, checks
