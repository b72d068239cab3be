from .inspection import COLLECTIVE_PRIMITIVES, count_collectives  # noqa: F401
from .profiling import device_time, throughput, trace  # noqa: F401
