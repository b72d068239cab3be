"""Device operations (kernels, memcpy, memset) a step: what the Grid API's
dispatch of one analysis puts on the card; fusing passes lowers it.

In the cells that report ``analysis_ms``; ``grid_api.device_ops.noisy``
reads the same in those that report ``analysis_ms.noisy``."""

from benchmark.readers import device_ops as read  # noqa: F401
