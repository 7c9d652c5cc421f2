"""The port's second order above 28 joints on the CPU against the JAX
package's XLA tier (float64).

Above the JAX package's ``SO_MAX_NV`` (28) the JAX package leaves its
Pallas kernels for its XLA tier; the port's kernels serve up to
``build.MAX_JOINTS`` (64; on the card: tests/test_torch_ws_kernels.py and
tests/test_torch_kernels.py hold them against the plain versions), and on
CPU tensors the plain versions run, as here. The robot is atlas_grippers30 (atlas with a
one-joint gripper on each hand, tests/torch_big_robots.py): both packages
parse the same URDF string with their own ``parse_urdf``. On 2 lanes, within
1e-10 of each output's scale:

* the port's ``GRiD.idsva_so`` at (q, qd, qdd) against the JAX
  ``ops/so.py:idsva_so`` (analytical form, the XLA tier's math), qdd the
  forward dynamics at (q, qd, u);
* the port's ``GRiD.fdsva_so`` at (q, qd, u) against the JAX
  ``fdsva_compose`` of that IDSVA-SO stack with the JAX ``fd_grad``'s
  df/du and Minv.

The JAX second order traces for ~40 s at 30 joints on one core (~55 s at
34), so it runs once, and this file stands alone.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.ops import so as jax_so
from gridcodegenerator_tpu.ops.fd_grad import fd_grad as jax_fd_grad
from gridcodegenerator_tpu.ops.pallas.kernels import SO_MAX_NV
from gridcodegenerator_tpu.topology.urdf import parse_urdf as jax_parse_urdf
from gridcodegenerator_tpu_torch import GRiD
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.topology.urdf import parse_urdf
from torch_big_robots import atlas_hands_name, atlas_hands_urdf

torch.set_num_threads(1)
TOL = 1e-10
K = 1          # joints a hand: atlas_grippers30
B = 2
GRAVITY = -9.81


@functools.lru_cache(maxsize=None)
def case():
    """The port's CPU GRiD, each method's inputs (q, qd, u ~ U(-1, 1)
    from a seed; idsva_so's third the JAX qdd at them) and the JAX tensors:
    the IDSVA-SO stack at (q, qd, qdd) and FDSVA-SO composed from it."""
    urdf, name = atlas_hands_urdf(K), atlas_hands_name(K)
    grid = GRiD(parse_urdf(urdf, name=name), dtype=torch.float64,
                device="cpu")
    jm = jax_build_model(jax_parse_urdf(urdf, name=name), dtype=jnp.float64)
    rng = np.random.default_rng(24)
    q, qd, u = (rng.uniform(-1, 1, (grid.n, B)) for _ in range(3))
    jq, jqd, ju = map(jnp.asarray, (q, qd, u))
    df_du, qdd, Mi = jax_fd_grad(jm, jq, jqd, ju, GRAVITY,
                                 return_extras=True)
    T = jax_so.idsva_so(jm, jq, jqd, qdd, GRAVITY, form="analytical")
    ref = {"idsva_so": T, "fdsva_so": jax_so.fdsva_compose(jm, T, df_du, Mi)}
    inputs = {"idsva_so": (q, qd, np.array(qdd)), "fdsva_so": (q, qd, u)}
    return grid, inputs, {k: np.asarray(v) for k, v in ref.items()}


def test_second_order_ceiling_is_the_jax_packages():
    """The JAX package's ceiling for its fused second-order kernels is 28
    joints; the port's second-order kernels have none of their own: they
    stop where every kernel does, at build.MAX_JOINTS."""
    assert SO_MAX_NV == 28 < build.MAX_JOINTS == 64
    assert not hasattr(build, "SO_MAX_JOINTS")


@pytest.mark.parametrize("method", ["idsva_so", "fdsva_so"])
def test_plain_second_order_above_28_matches_jax(method):
    grid, inputs, ref = case()
    assert grid.n == 30 > SO_MAX_NV
    build.reset_counters()
    got = getattr(grid, method)(*(a.T for a in inputs[method]))
    assert got.shape == (B, 4, grid.n, grid.n, grid.n)
    assert not build.LAUNCHES and build.PLAIN_CALLS[method] == 1
    want = np.moveaxis(ref[method], -1, 0)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= TOL * scale
