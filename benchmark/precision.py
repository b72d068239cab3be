"""The two precisions the plain references run in.

``"f64"``: the reference, float64 arithmetic on the inputs as given.
``"bf16"``: the correctness control, the precision below the configurations'
float32: every input rounded to bfloat16, arithmetic in float32, every
result rounded to bfloat16, as the port's own 16-bit kernels compute.
"""

import torch

PRECISIONS = ("f64", "bf16")


def take(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An input as the reference computes with it."""
    if precision == "f64":
        return x.to(torch.float64)
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def give(y: torch.Tensor, precision: str) -> torch.Tensor:
    """A result as the reference hands it over."""
    return y.to(torch.bfloat16).to(torch.float32) if precision == "bf16" else y
