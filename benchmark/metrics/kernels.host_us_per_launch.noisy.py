"""``kernels.host_us_per_launch`` in the cells that report
``analysis_ms.noisy``, whose runs spread by several % between processes."""

from benchmark.program_spans import host_us_per_launch as read  # noqa: F401
