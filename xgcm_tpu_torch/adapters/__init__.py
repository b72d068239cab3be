from .xarray_adapter import HAS_XARRAY  # noqa: F401
