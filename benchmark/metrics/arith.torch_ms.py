"""Device ms a step of every operation that is not one of the port's own
kernels: PyTorch's elementwise passes, reductions, copies, index and cat
(the metric calculus, the arithmetic on GriddedArrays, the face path's strip
gathers).

In the cells that report ``analysis_ms``; ``arith.torch_ms.noisy`` reads the
same in those that report ``analysis_ms.noisy``."""

from benchmark.readers import torch_ms as read  # noqa: F401
