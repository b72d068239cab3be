from .axis import Axis  # noqa: F401
from .dataarray import GriddedArray  # noqa: F401
from .dataset import Dataset  # noqa: F401
from .grid import Grid  # noqa: F401
from .grid_ufunc import GridUFunc, apply_as_grid_ufunc, as_grid_ufunc  # noqa: F401
from .signature import GridUFuncSignature  # noqa: F401
