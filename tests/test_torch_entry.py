"""The port's analysis step (``xgcm_tpu_torch.entry.step``) against the JAX
package's flagship step (``__graft_entry__.entry``), rtol 1e-6 in float32."""

import numpy as np
import torch

from tests.torch_parity import assert_close, to_numpy
from xgcm_tpu_torch.entry import step


def _jax_step_at(nx, ny, nz):
    """The body of ``__graft_entry__.entry``'s step, on a grid of the given
    size (``entry`` itself fixes 256 x 256 x 16)."""
    import jax.numpy as jnp

    import xgcm_tpu as xt
    from __graft_entry__ import _build_grid
    from xgcm_tpu.ops.transform import interp_1d_linear

    grid = _build_grid(nx, ny)

    def jax_step(u, v, theta, targets):
        uu = xt.GriddedArray(u, ("yc", "xg"))
        vv = xt.GriddedArray(v, ("yg", "xc"))
        zeta = grid.diff(vv, "X") - grid.diff(uu, "Y")
        div = grid.diff(uu, "X", to="center") + grid.diff(vv, "Y", to="center")
        u_c = grid.interp(uu, "X", to="center")
        v_c = grid.interp(vv, "Y", to="center")
        ke = 0.5 * (u_c * u_c + v_c * v_c)
        ke_cols = jnp.broadcast_to(ke.data[..., None], ke.data.shape + (nz,))
        return zeta.data, div.data, interp_1d_linear(ke_cols, theta, targets, mask_edges=False)

    return jax_step


def test_step_matches_jax_small():
    ny = nx = 32
    nz = 8
    rng = np.random.RandomState(0)
    u = rng.rand(ny, nx).astype(np.float32)
    v = rng.rand(ny, nx).astype(np.float32)
    theta = np.sort(rng.rand(ny, nx, nz).astype(np.float32), axis=-1)
    targets = np.linspace(0.1, 0.9, 8).astype(np.float32)
    out_j = _jax_step_at(nx, ny, nz)(u, v, theta, targets)
    out_t = step(*(torch.as_tensor(a) for a in (u, v, theta, targets)))
    for a_t, a_j in zip(out_t, out_j):
        assert a_t.dtype == torch.float32
        assert_close(a_t, a_j, rtol=1e-6)


def test_step_matches_entry():
    import jax.numpy as jnp

    from __graft_entry__ import entry

    jax_step, (u, v, theta) = entry()
    targets = np.asarray(jnp.linspace(0.1, 0.9, 8, dtype=jnp.float32))
    out_j = jax_step(jnp.asarray(u), jnp.asarray(v), jnp.asarray(theta))
    out_t = step(*(torch.as_tensor(np.array(a)) for a in (u, v, theta, targets)))
    for a_t, a_j in zip(out_t, out_j):
        assert tuple(a_t.shape) == tuple(to_numpy(a_j).shape)
        assert_close(a_t, a_j, rtol=1e-6)
