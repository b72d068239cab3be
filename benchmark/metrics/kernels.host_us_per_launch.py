"""Host self time of the program's kernel-wrapper spans (``xtt.kernels.*``)
over their calls, in us: a wrapper's checks, autograd's Function and the C
call that launches the kernel.

In the cells that report ``analysis_ms``;
``kernels.host_us_per_launch.noisy`` reads the same in those that report
``analysis_ms.noisy``."""

from benchmark.program_spans import host_us_per_launch as read  # noqa: F401
