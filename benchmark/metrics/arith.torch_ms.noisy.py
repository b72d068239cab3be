"""``arith.torch_ms`` in the cells that report ``analysis_ms.noisy``, whose
runs spread by several % between processes."""

from benchmark.readers import torch_ms as read  # noqa: F401
