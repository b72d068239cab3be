"""Parity harness for the PyTorch port: run a JAX callable and its port's
counterpart on the same numpy inputs and compare the results as numpy.

``conftest.py`` already keeps JAX on the CPU (with x64).  The port puts host
data on the CUDA card unless asked for the CPU; the parity tests ask for it
here, once, for every test file that imports this module.  Tests that need
the card build their inputs there as tensors, which keep their device.
Torch runs one thread per process, since the suite runs several workers at
once.
"""

from __future__ import annotations

import numpy as np
import torch

import xgcm_tpu_torch

xgcm_tpu_torch.set_default_device("cpu")
torch.set_num_threads(1)


def to_numpy(x):
    """numpy view of a JAX array, a torch tensor, a GriddedArray of either
    package, or a tuple/list of those."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if hasattr(x, "dims") and hasattr(x, "data"):
        x = x.data
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def run_both(jax_fn, torch_fn, *np_args):
    """(jax_result, torch_result) as numpy, each callable given the same
    numpy inputs (as jnp arrays and as CPU tensors)."""
    import jax.numpy as jnp

    j = jax_fn(*(jnp.asarray(a) for a in np_args))
    t = torch_fn(*(torch.as_tensor(np.ascontiguousarray(a)) for a in np_args))
    return to_numpy(j), to_numpy(t)


def assert_bitwise(actual, expected):
    """Same dtype, same shape, same values bit for bit (NaN in the same
    places counts as equal)."""
    actual, expected = to_numpy(actual), to_numpy(expected)
    assert actual.dtype == expected.dtype, (actual.dtype, expected.dtype)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    np.testing.assert_array_equal(actual, expected)


def assert_close(actual, expected, rtol, atol=0.0):
    """Identical NaN footprint, then allclose on the rest."""
    actual, expected = to_numpy(actual), to_numpy(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    np.testing.assert_array_equal(np.isnan(actual), np.isnan(expected))
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=atol)
