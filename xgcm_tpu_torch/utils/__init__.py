from .profiling import device_time, throughput, trace  # noqa: F401
