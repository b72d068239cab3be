"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

==========================  ==============================  ===============================
wrapper                     CUDA source                     replaces (Pallas, JAX package)
==========================  ==============================  ===============================
``shift.shift``             ``csrc/shift.cu``               ``pallas_stencils.shift_op``
``cgrid_diagnostics.``      ``csrc/cgrid_diagnostics.cu``   ``pallas_stencils.``
``cgrid_diagnostics``                                       ``fused_cgrid_diagnostics``
``interp_linear.``          ``csrc/interp_linear.cu``       ``pallas_transform.``
``interp_linear`` (C)                                       ``interp_linear_fused_T``
``interp_linear.``          ``csrc/interp_linear.cu``       ``pallas_transform.``
``interp_linear_multi`` (F)                                 ``interp_linear_fused_multi_T``
``conservative.``           ``csrc/conservative.cu``        ``pallas_transform.``
``conservative_rebin`` (G)                                  ``conservative_fused_T``
``conservative.``           ``csrc/conservative.cu``        ``pallas_transform.``
``conservative_rebin_multi``                                ``conservative_fused_multi_T``
(H)
``vorticity.vorticity`` (D) ``csrc/vorticity.cu``           ``pallas_stencils.fused_vorticity``
``face_shift.face_shift``   ``csrc/face_shift.cu``          ``pallas_stencils.face_shift_op``
(E)
``weighted_sum.``           ``csrc/weighted_sum.cu``        none: ``Grid.integrate``'s product,
``weighted_sum``                                            ``nan_to_num`` and sum, which XLA
                                                            fuses and eager PyTorch does not
==========================  ==============================  ===============================

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (building the library at first use) or raises.
"""

from . import (  # noqa: F401
    build,
    cgrid_diagnostics,
    conservative,
    face_shift,
    interp_linear,
    shift,
    vorticity,
    weighted_sum,
)
