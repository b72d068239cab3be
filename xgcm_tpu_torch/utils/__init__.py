from .inspection import COLLECTIVE_PRIMITIVES, count_collectives  # noqa: F401
from .profiling import (  # noqa: F401
    device_time,
    reset_spans,
    span,
    span_totals,
    throughput,
    trace,
)
