"""The port's second-order ops on the humanoids against the JAX package's
(CPU, float64): gym_humanoid (17 joints) and atlas (28).

Above 16 joints the JAX ``fdsva_so_pallas`` takes a composed route
(``gridcodegenerator_tpu/ops/pallas/kernels.py``: ``fd_du_pallas`` with
extras, ``idsva_so_pallas`` at its qdd, then ``ops/so.py:fdsva_compose`` on
XLA), and so does the port's ``fdsva_so`` wherever one fused knot does not
fit a block (``ops/cuda/kernels.py:fdsva_so_composed``). Held here, at B=3
and within 1e-10 (the JAX package's oracle tolerance) of each output's
scale max(1, max|ref|): gym_humanoid's light links make its FDSVA-SO reach
1106, and the JAX package's own two routes' sums part from the port's by
1.2e-10 there (1.3e-12 on atlas):

* the port's plain ``idsva_so`` and ``fdsva_so`` against the JAX XLA
  functions, the math the Pallas bodies trace;
* the port's composed route (plain fd_du, plain idsva_so, then
  ``ops/so.py:fdsva_compose_lanes``) against the JAX ``fdsva_compose`` fed
  by the JAX tensors, and the port's contractions fed the same JAX
  tensors.

The JAX second-order functions trace for 10-26 s a robot on the CPU, so
each robot's JAX tensors are made once, and this file stands alone (the
tier-1 run gives each file a worker).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops import so as jax_so
from gridcodegenerator_tpu.ops.fd_grad import fd_grad as jax_fd_grad
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops import so
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.ops.cuda import kernels as K

torch.set_num_threads(1)
ATOL = 1e-10
B = 3
ROBOTS = ["gym_humanoid", "atlas"]
GRAVITY = -9.81


@functools.lru_cache(maxsize=None)
def case(robot):
    """The two packages' models, inputs (q, qd, u) ~ U(-1, 1) from a seed,
    and the JAX tensors: df_du, qdd and Minv (fd_grad with extras), the
    IDSVA-SO stack at (q, qd, qdd), FDSVA-SO composed from them, and
    FDSVA-SO by ``ops/so.py:fdsva_so``."""
    jm = jax_build_model(jax_load_robot(robot), dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    rng = np.random.default_rng(21)
    q, qd, u = (rng.uniform(-1, 1, (tm.n, B)) for _ in range(3))
    jq, jqd, ju = map(jnp.asarray, (q, qd, u))
    df_du, qdd, Mi = jax_fd_grad(jm, jq, jqd, ju, GRAVITY, return_extras=True)
    T = jax_so.idsva_so(jm, jq, jqd, qdd, GRAVITY, form="analytical")
    jax_out = {"df_du": df_du, "qdd": qdd, "Mi": Mi, "T": T,
               "composed": jax_so.fdsva_compose(jm, T, df_du, Mi),
               "fdsva_so": jax_so.fdsva_so(jm, jq, jqd, ju, GRAVITY)}
    return tm, (q, qd, u), {k: np.asarray(v) for k, v in jax_out.items()}


def _close(got, want):
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("robot", ROBOTS)
def test_idsva_so_matches_jax(robot):
    tm, (q, qd, _), ref = case(robot)
    got = so.idsva_so(tm, *map(torch.as_tensor, (q, qd, ref["qdd"])),
                      GRAVITY)
    assert got.shape == (4, tm.n, tm.n, tm.n, B)
    _close(got, ref["T"])


@pytest.mark.parametrize("robot", ROBOTS)
def test_fdsva_so_matches_jax(robot):
    tm, x, ref = case(robot)
    _close(so.fdsva_so(tm, *map(torch.as_tensor, x), GRAVITY),
           ref["fdsva_so"])


@pytest.mark.parametrize("robot", ROBOTS)
def test_composed_route_matches_jax_compose(robot):
    """The port's composed route on CPU tensors runs the plain fd_du and
    idsva_so, then its contractions, and meets the JAX composed route."""
    tm, x, ref = case(robot)
    build.reset_counters()
    got = K.fdsva_so_composed(tm, *map(torch.as_tensor, x), GRAVITY)
    assert dict(build.PLAIN_CALLS) == {"fd_du": 1, "idsva_so": 1}
    assert not build.LAUNCHES
    _close(got, ref["composed"])
    _close(got, ref["fdsva_so"])


@pytest.mark.parametrize("chunk_lanes", [1, 2, B])
@pytest.mark.parametrize("robot", ROBOTS)
def test_contractions_match_jax_compose(robot, chunk_lanes):
    """``fdsva_compose_lanes`` fed the JAX tensors, a chunk of 1, 2 or all
    lanes at a time (a ragged last chunk at 2), in place on T."""
    tm, _, ref = case(robot)
    T = torch.as_tensor(ref["T"]).clone()
    chunk = chunk_lanes * 4 * tm.n ** 3 * T.element_size()
    got = so.fdsva_compose_lanes(T, torch.as_tensor(ref["df_du"]),
                                 torch.as_tensor(ref["Mi"]),
                                 chunk_bytes=chunk)
    assert got is T
    _close(got, ref["composed"])
