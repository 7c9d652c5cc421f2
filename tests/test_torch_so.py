"""The port's plain second-order ops against the JAX package's (CPU, float64).

IDSVA-SO and FDSVA-SO on a 2-joint chain, the 7-joint iiwa and the branched
12-joint hyq at B=3, against ``gridcodegenerator_tpu.ops.so`` on its XLA
path (the analytical form, which is also the body of the JAX Pallas
kernels ``idsva_so_pallas`` and ``fdsva_so_pallas``). Inputs are made with
numpy from a seed and fed to both packages; the constants reach the port
through ``model_from_numpy``. Tolerance: 1e-10 absolute, the oracle
tolerance of the JAX package's own tests.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.ops import so as jax_so
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops import so

torch.set_num_threads(1)
ATOL = 1e-10
B = 3
ROBOTS = ["pendulum2", "iiwa", "hyq"]


@functools.lru_cache(maxsize=None)
def pair(robot):
    jm = jax_build_model(jax_load_robot(robot), dtype=jnp.float64)
    tm = model_from_numpy({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
                          {f: getattr(jm, f) for f in STATIC_FIELDS},
                          device="cpu")
    return jm, tm


def inputs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, B)) for _ in range(3)]


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("robot", ROBOTS)
def test_idsva_so_matches_jax(robot):
    jm, tm = pair(robot)
    q, qd, qdd = inputs(tm.n, seed=11)
    want = jax_so.idsva_so(jm, *map(jnp.asarray, (q, qd, qdd)),
                           form="analytical")
    got = so.idsva_so(tm, *map(torch.as_tensor, (q, qd, qdd)))
    assert got.shape == (4, tm.n, tm.n, tm.n, B)
    _close(got, want)


@pytest.mark.parametrize("robot", ROBOTS)
def test_fdsva_so_matches_jax(robot):
    jm, tm = pair(robot)
    q, qd, u = inputs(tm.n, seed=12)
    want = jax_so.fdsva_so(jm, *map(jnp.asarray, (q, qd, u)))
    got = so.fdsva_so(tm, *map(torch.as_tensor, (q, qd, u)))
    _close(got, want)


def test_idsva_so_stages_match_jax():
    jm, tm = pair("iiwa")
    q, qd, qdd = inputs(tm.n, seed=13)
    want_out, want = jax_so.idsva_so_analytical(
        jm, *map(jnp.asarray, (q, qd, qdd)), return_stages=True)
    got_out, got = so.idsva_so_analytical(
        tm, *map(torch.as_tensor, (q, qd, qdd)), return_stages=True)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    _close(got_out, want_out)


def test_unbatched_inputs_and_required_qdd():
    _, tm = pair("iiwa")
    q, qd, qdd = (torch.as_tensor(x[:, 0]) for x in inputs(tm.n, seed=14))
    got = so.idsva_so(tm, q, qd, qdd)
    want = so.idsva_so(tm, q[:, None], qd[:, None], qdd[:, None])[..., 0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-14)
    with pytest.raises(ValueError):
        so.idsva_so(tm, q, qd, None)
