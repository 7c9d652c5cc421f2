"""The port's GRiD against the JAX package's GRiD (CPU).

Inputs are made with numpy from a seed and fed to both; the JAX GRiD runs
its XLA tier (``use_pallas=False``), the port's its plain versions (CPU
tensors). Tolerances: 1e-10 absolute in float64, the oracle tolerance of
the JAX package's tests; in float32 the thresholds of ``bench.py`` config 1,
1e-4 absolute for values (c, qdd, Minv) and 1e-3 for gradients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.api import GRiD as JaxGRiD
from gridcodegenerator_tpu_torch import GRiD, init_robot
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS)
from gridcodegenerator_tpu_torch.models.zoo import iiwa_urdf, load_robot
from gridcodegenerator_tpu_torch.ops.cuda import build

torch.set_num_threads(1)
ATOL64 = 1e-10
F32_TOL = {"value": 1e-4, "gradient": 1e-3}
DTYPES = {"f64": (torch.float64, jnp.float64),
          "f32": (torch.float32, jnp.float32)}


@pytest.fixture(scope="module", params=[(r, d) for r in ("pendulum2", "iiwa")
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def grids(request):
    robot, dt = request.param
    tdt, jdt = DTYPES[dt]
    return dt, GRiD(robot, dtype=tdt, device="cpu"), JaxGRiD(robot, dtype=jdt,
                                               use_pallas=False)


def _packed(*xs):
    return np.concatenate(xs, axis=-1)


# call -> (how to call it on either GRiD, kind of output)
CALLS = {
    "id": (lambda g, x: g.id(x["q"], x["qd"], x["qdd"]), "value"),
    "id_bias": (lambda g, x: g.id(x["q"], x["qd"]), "value"),
    "id_du": (lambda g, x: g.id_du(x["q"], x["qd"], x["qdd"]), "gradient"),
    "id_du_zero_qdd": (lambda g, x: g.id_du(x["q"], x["qd"]), "gradient"),
    "aba": (lambda g, x: g.aba(x["q"], x["qd"], x["u"]), "value"),
    "minv": (lambda g, x: g.minv(x["q"]), "value"),
    "minv_upper": (lambda g, x: g.minv(x["q"], dense=False), "value"),
    "fd_du": (lambda g, x: g.fd_du(x["q"], x["qd"], x["u"]), "gradient"),
    "id_packed": (lambda g, x: g.id_packed(_packed(x["q"], x["qd"],
                                                   x["qdd"])), "value"),
    "aba_packed": (lambda g, x: g.aba_packed(_packed(x["q"], x["qd"],
                                                     x["u"])), "value"),
    "fd_du_packed": (lambda g, x: g.fd_du_packed(_packed(x["q"], x["qd"],
                                                         x["u"])),
                     "gradient"),
}


@pytest.mark.parametrize("batch", [None, 5], ids=["unbatched", "B5"])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_grid_matches_jax_grid(grids, call, batch):
    dt, ours, ref = grids
    rng = np.random.default_rng(11)
    shape = (ours.n,) if batch is None else (batch, ours.n)
    x = {k: rng.uniform(-1, 1, shape) for k in ("q", "qd", "qdd", "u")}
    fn, kind = CALLS[call]
    got, want = fn(ours, x), np.asarray(fn(ref, x))
    assert isinstance(got, torch.Tensor) and got.dtype == ours.dtype
    assert tuple(got.shape) == want.shape
    tol = ATOL64 if dt == "f64" else F32_TOL[kind]
    np.testing.assert_allclose(got.numpy(), want.astype(np.float64), rtol=0,
                               atol=tol)


def _tuples(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tuples(v) for v in x)
    return x


def test_grids_hold_the_same_robot(grids):
    _, ours, ref = grids
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ours.model, f).numpy(),
                                      np.asarray(getattr(ref.model, f)),
                                      err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(ours.model, f) == _tuples(getattr(ref.model, f)), f
    assert (ours.n, ours.num_pos, ours.num_vel) == (ref.n, ref.num_pos,
                                                    ref.num_vel)
    np.testing.assert_array_equal(ours.joint_limits(), ref.joint_limits())


# second-order call -> how to call it on either GRiD
SO_CALLS = {
    "idsva_so": lambda g, x: g.idsva_so(x["q"], x["qd"], x["qdd"]),
    "idsva_so_zero_qdd": lambda g, x: g.idsva_so(x["q"], x["qd"]),
    "fdsva_so": lambda g, x: g.fdsva_so(x["q"], x["qd"], x["u"]),
    "idsva_so_packed": lambda g, x: g.idsva_so_packed(
        _packed(x["q"], x["qd"], x["qdd"])),
    "fdsva_so_packed": lambda g, x: g.fdsva_so_packed(
        _packed(x["q"], x["qd"], x["u"])),
}


@pytest.fixture(scope="module")
def so_grids():
    return (GRiD("pendulum2", dtype=torch.float64, device="cpu"),
            JaxGRiD("pendulum2", dtype=jnp.float64, use_pallas=False))


@pytest.mark.parametrize("batch", [None, 3], ids=["unbatched", "B3"])
@pytest.mark.parametrize("call", sorted(SO_CALLS))
def test_grid_second_order_matches_jax_grid(so_grids, call, batch):
    """pendulum2, float64: (B, 4, n, n, n) or unbatched (4, n, n, n)."""
    ours, ref = so_grids
    rng = np.random.default_rng(12)
    shape = (ours.n,) if batch is None else (batch, ours.n)
    x = {k: rng.uniform(-1, 1, shape) for k in ("q", "qd", "qdd", "u")}
    got, want = SO_CALLS[call](ours, x), np.asarray(SO_CALLS[call](ref, x))
    assert tuple(got.shape) == want.shape == (
        () if batch is None else (batch,)) + (4,) + (ours.n,) * 3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL64)


@pytest.mark.parametrize("call", ["idsva_so", "fdsva_so"])
def test_grid_second_order_iiwa_matches_jax_ops(call):
    """iiwa, float64, B=3, against the JAX ops the JAX GRiD runs (eagerly:
    the JAX GRiD jit-compiles the unrolled 7-joint trace for minutes on the
    CPU)."""
    from gridcodegenerator_tpu.ops import so as jax_so
    g = GRiD("iiwa", dtype=torch.float64, device="cpu")
    ref = JaxGRiD("iiwa", dtype=jnp.float64, use_pallas=False)
    x = np.random.default_rng(13).uniform(-1, 1, (3, 3, 7))
    got = getattr(g, call)(*x)
    if call == "idsva_so":
        want = jax_so.idsva_so(ref.model, *(jnp.asarray(a.T) for a in x),
                               form="analytical")
    else:
        want = jax_so.fdsva_so(ref.model, *(jnp.asarray(a.T) for a in x))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1,
                                                        0), rtol=0,
                               atol=ATOL64)


@pytest.mark.parametrize("kwargs,error", [
    (dict(floating_base=True), NotImplementedError),
    (dict(use_kernels=True), ValueError),   # kernels need a CUDA device
], ids=["floating_base", "use_kernels_on_cpu"])
def test_constructor_refuses(kwargs, error):
    if kwargs.get("floating_base"):
        # a floating base is served (the plain twins), and refuses only
        # the kernels, which are fixed-base
        g = GRiD("iiwa", device="cpu", **kwargs)
        assert g.model.floating_base and g.num_pos == 14
        assert "floating=True" in repr(g)
        kwargs = dict(kwargs, use_kernels=True)
    with pytest.raises(error):
        GRiD("iiwa", device="cpu", **kwargs)


@pytest.mark.parametrize("use_kernels", [None, False])
def test_each_call_runs_one_plain_version_on_cpu(use_kernels):
    """On the CPU both settings run the plain versions, one per call."""
    g = GRiD("iiwa", dtype=torch.float64, device="cpu",
             use_kernels=use_kernels)
    x = np.random.default_rng(0).uniform(-1, 1, (3, 4, 7))
    for method, kernel, nargs in (("id", "rnea", 3), ("id_du", "id_du", 2),
                                  ("aba", "aba", 3), ("fd_du", "fd_du", 3),
                                  ("minv", "minv", 1), ("fd", "fd", 3),
                                  ("crba", "crba", 1), ("eepos", "eepos", 1),
                                  ("deepos", "deepos", 1),
                                  ("d2eepos", "d2eepos", 1),
                                  ("idsva_so", "idsva_so", 3),
                                  ("fdsva_so", "fdsva_so", 3)):
        build.reset_counters()
        getattr(g, method)(*x[:nargs])
        assert dict(build.PLAIN_CALLS) == {kernel: 1}, method
        assert not build.LAUNCHES


def test_robot_sources_agree(tmp_path):
    """Zoo name, URDF XML, URDF path and a topology give the same robot."""
    path = tmp_path / "iiwa.urdf"
    path.write_text(iiwa_urdf())
    q = np.random.default_rng(1).uniform(-1, 1, (3, 7))
    ref = GRiD("iiwa", dtype=torch.float64, device="cpu").id(q, q, q)
    for src in (iiwa_urdf(), str(path), load_robot("iiwa"),
                init_robot("iiwa")):
        got = GRiD(src, dtype=torch.float64, device="cpu").id(q, q, q)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(4, 8), (8,), (2, 3, 7)])
def test_bad_shapes_raise(shape):
    with pytest.raises(ValueError):
        GRiD("iiwa", device="cpu").minv(np.zeros(shape))


def test_default_device_is_the_card(monkeypatch):
    """Without a CUDA device the default raises at construction instead of
    falling back to the CPU; device="cpu" is the explicit request."""
    from gridcodegenerator_tpu_torch.models.model import (build_model,
                                                           model_from_numpy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = load_robot("pendulum2")
    cpu = build_model(topo, device="cpu")
    arrays = {f: getattr(cpu, f).numpy() for f in ARRAY_FIELDS}
    static = {f: getattr(cpu, f) for f in STATIC_FIELDS}
    for make in (lambda: GRiD("pendulum2"), lambda: build_model(topo),
                 lambda: model_from_numpy(arrays, static)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert GRiD("pendulum2", device="cpu").device.type == "cpu"
