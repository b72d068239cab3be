"""``device.idle_share`` in the cells that report ``analysis_ms.noisy``, whose
runs spread by several % between processes."""

from benchmark.readers import idle_share as read  # noqa: F401
