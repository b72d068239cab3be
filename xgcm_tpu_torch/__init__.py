"""xgcm_tpu_torch: the PyTorch and CUDA port of xgcm_tpu, for NVIDIA Hopper.

Finite-volume analysis of staggered (Arakawa) grid datasets: position-aware
``interp``/``diff``/``min``/``max``/``cumsum`` on scalars and vector
components, on face-less and face-connected grids (MITgcm, NEMO, MOM6,
cubed sphere, LLC; see :mod:`.grids`), the metric-weighted calculus
(``derivative``, ``integrate``, ``average``, ``cumint``), and the linear,
log and conservative vertical transforms, on torch tensors; the legacy
vertical binner (:mod:`.ops.regridding`) and timers (:mod:`.utils`).  With
xarray installed, ``Grid`` takes an ``xr.Dataset`` and its entry points take
and give ``xr.DataArray`` (:mod:`.adapters.xarray_adapter`).  On a CUDA tensor the hot paths run
hand-written CUDA kernels (``csrc/``); on a CPU tensor they run the kernels'
plain PyTorch versions.  Host data that enters the package goes to the CUDA
card unless the caller asks for the CPU (:func:`set_default_device`).
:mod:`.parallel` shards arrays over a mesh of devices as JAX does: in one
process that process holds every block, a device may repeat (logical
shards), and a collective is a copy between blocks; across processes
(``init_distributed``, ``make_multihost_mesh``) each holds its own blocks
and the rest move through ``torch.distributed``.
The JAX package ``xgcm_tpu`` is the reference this package is tested
against; this package imports neither it nor JAX.
"""

from .core.axis import Axis
from .core.dataarray import GriddedArray
from .core.dataset import Dataset, from_numpy_dataset
from .core.device import get_default_device, set_default_device
from .core.grid import Grid
from .core.grid_ufunc import GridUFunc, apply_as_grid_ufunc, as_grid_ufunc
from .core.signature import GridUFuncSignature
from . import grids  # noqa: E402  (needs Grid above)

__all__ = [
    "Axis",
    "Dataset",
    "Grid",
    "GriddedArray",
    "GridUFunc",
    "GridUFuncSignature",
    "apply_as_grid_ufunc",
    "as_grid_ufunc",
    "from_numpy_dataset",
    "get_default_device",
    "grids",
    "set_default_device",
]
