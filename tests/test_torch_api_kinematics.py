"""The port's GRiD calls fd, crba, eepos, deepos, d2eepos, fk and
fd_packed, and ``ee_targets``, against the JAX package's GRiD (CPU).

Inputs are made with numpy from a seed and fed to both; the JAX GRiD runs
its XLA tier (``use_pallas=False``), the port's its plain versions (CPU
tensors). Tolerances as in ``test_torch_api.py``: 1e-10 absolute in
float64; in float32 1e-4 for values and 1e-3 for the EE Jacobian and
Hessian.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.api import GRiD as JaxGRiD
from gridcodegenerator_tpu_torch import GRiD

torch.set_num_threads(1)
ATOL = 1e-10
F32_TOL = {"value": 1e-4, "gradient": 1e-3}
DTYPES = {"f64": (torch.float64, jnp.float64),
          "f32": (torch.float32, jnp.float32)}
HYQ_TARGETS = ["lf_foot_fixed", "rh_foot_fixed"]


@pytest.fixture(scope="module", params=[(r, d) for r in ("pendulum2", "iiwa")
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def grids(request):
    robot, dt = request.param
    tdt, jdt = DTYPES[dt]
    return dt, GRiD(robot, dtype=tdt, device="cpu"), JaxGRiD(robot, dtype=jdt,
                                               use_pallas=False)


@pytest.fixture(scope="module")
def hyq_grids():
    """A branched robot with two of its four feet as EE targets."""
    return ("f64", GRiD("hyq", dtype=torch.float64, device="cpu",
                ee_targets=HYQ_TARGETS),
            JaxGRiD("hyq", dtype=jnp.float64, use_pallas=False,
                    ee_targets=HYQ_TARGETS))


# call -> (how to call it on either GRiD, kind of output)
CALLS = {
    "fd": (lambda g, x: g.fd(x["q"], x["qd"], x["u"]), "value"),
    "fd_packed": (lambda g, x: g.fd_packed(np.concatenate(
        [x["q"], x["qd"], x["u"]], axis=-1)), "value"),
    "crba": (lambda g, x: g.crba(x["q"]), "value"),
    "eepos": (lambda g, x: g.eepos(x["q"]), "value"),
    "deepos": (lambda g, x: g.deepos(x["q"]), "gradient"),
    "d2eepos": (lambda g, x: g.d2eepos(x["q"]), "gradient"),
    "fk": (lambda g, x: g.fk(x["q"]), "value"),
}


def _check_call(dt, ours, ref, call, batch):
    rng = np.random.default_rng(11)
    shape = (ours.n,) if batch is None else (batch, ours.n)
    x = {k: rng.uniform(-1, 1, shape) for k in ("q", "qd", "u")}
    fn, kind = CALLS[call]
    got, want = fn(ours, x), np.asarray(fn(ref, x))
    assert isinstance(got, torch.Tensor) and got.dtype == ours.dtype
    assert tuple(got.shape) == want.shape
    tol = ATOL if dt == "f64" else F32_TOL[kind]
    np.testing.assert_allclose(got.numpy(), want.astype(np.float64), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("batch", [None, 5], ids=["unbatched", "B5"])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_grid_matches_jax_grid(grids, call, batch):
    _check_call(*grids, call, batch)


@pytest.mark.parametrize("batch", [None, 5], ids=["unbatched", "B5"])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_hyq_grid_with_ee_targets_matches_jax_grid(hyq_grids, call, batch):
    _check_call(*hyq_grids, call, batch)


def test_grid_ee_targets():
    g = GRiD("hyq", dtype=torch.float64, device="cpu",
                ee_targets=HYQ_TARGETS)
    assert g.ee_targets == tuple(HYQ_TARGETS) and g.num_ees == 2
    assert GRiD("hyq", device="cpu").num_ees == 4 and GRiD("hyq", device="cpu").ee_targets is None
    with pytest.raises(ValueError):
        GRiD("hyq", device="cpu", ee_targets=["lf_foot_fixed", "no_such_frame"])
