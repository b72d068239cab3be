"""The host seconds of the first call of each C entry in the process
(``build.FIRST_LAUNCH_S``), summed: the kernels' module loads at their first
launch, paid in set-up.  Each entry's seconds are printed."""

from benchmark.program_spans import first_launch_s as read  # noqa: F401
