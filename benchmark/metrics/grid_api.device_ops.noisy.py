"""``grid_api.device_ops`` in the cells that report ``analysis_ms.noisy``,
whose runs spread by several % between processes."""

from benchmark.readers import device_ops as read  # noqa: F401
