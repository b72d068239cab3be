"""The share of the traced window in which no operation ran on the device: the
window minus the union of every kernel's, memcpy's and memset's interval,
over the window, in %.

In the cells that report ``analysis_ms``; ``device.idle_share.noisy`` reads
the same in those that report ``analysis_ms.noisy``."""

from benchmark.readers import idle_share as read  # noqa: F401
