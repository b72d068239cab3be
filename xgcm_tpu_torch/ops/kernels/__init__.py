"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

==========================  ==============================  ===============================
wrapper                     CUDA source                     replaces (Pallas, JAX package)
==========================  ==============================  ===============================
``shift.shift``             ``csrc/shift.cu``               ``pallas_stencils.shift_op``
``cgrid_diagnostics.``      ``csrc/cgrid_diagnostics.cu``   ``pallas_stencils.``
``cgrid_diagnostics``                                       ``fused_cgrid_diagnostics``
``interp_linear.``          ``csrc/interp_linear.cu``       ``pallas_transform.``
``interp_linear``                                           ``interp_linear_fused_T``
==========================  ==============================  ===============================

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (building the library at first use) or raises.
"""

from . import build, cgrid_diagnostics, interp_linear, shift  # noqa: F401
