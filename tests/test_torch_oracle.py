"""The port's float64 oracle, debug dumps and error checks (CPU).

* ``gridcodegenerator_tpu_torch/reference/oracle.py`` gives the JAX
  package's oracle's bits (rnea, minv, crba, forward_dynamics, aba,
  rnea_grad, fd_grad on pendulum2, iiwa and hyq), and the port's plain ops
  match it within 1e-10.
* ``utils/debug.py``: each staged dump equals the JAX package's within
  1e-12 and the oracle's stages within 1e-10; ``print_stages`` prints what
  the JAX one prints.
* ``utils/errors.py`` behaves as the JAX package's.
* The port's ``reference`` and ``utils`` modules import no jax.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu.reference import oracle as jax_oracle
from gridcodegenerator_tpu.utils import debug as jax_debug
from gridcodegenerator_tpu.utils import errors as jax_errors
from gridcodegenerator_tpu_torch.models.model import build_model
from gridcodegenerator_tpu_torch.models.zoo import load_robot
from gridcodegenerator_tpu_torch.ops.aba import aba
from gridcodegenerator_tpu_torch.ops.crba import crba
from gridcodegenerator_tpu_torch.ops.fd import forward_dynamics
from gridcodegenerator_tpu_torch.ops.fd_grad import fd_grad
from gridcodegenerator_tpu_torch.ops.id_grad import id_grad
from gridcodegenerator_tpu_torch.ops.minv import minv
from gridcodegenerator_tpu_torch.ops.rnea import rnea
from gridcodegenerator_tpu_torch.reference import oracle
from gridcodegenerator_tpu_torch.utils import debug, errors

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ROBOTS = ("pendulum2", "iiwa", "hyq")
LANES = 3
ORACLE_FNS = ("rnea", "minv", "crba", "forward_dynamics", "aba",
              "rnea_grad", "fd_grad")


def samples(n, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, (n, LANES)) for _ in range(4))


def oracle_args(fn, q, qd, qdd, u):
    return {"rnea": (q, qd, qdd), "minv": (q,), "crba": (q,),
            "forward_dynamics": (q, qd, u), "aba": (q, qd, u),
            "rnea_grad": (q, qd, qdd), "fd_grad": (q, qd, u)}[fn]


def _arrays(out):
    if isinstance(out, tuple):
        return [a for o in out for a in _arrays(o)]
    return [np.asarray(out)]


@pytest.mark.parametrize("fn", ORACLE_FNS)
@pytest.mark.parametrize("robot", ROBOTS)
def test_oracle_copy_is_the_jax_oracle_bit_for_bit(robot, fn):
    topo, jtopo = load_robot(robot), jax_load_robot(robot)
    q, qd, qdd, u = samples(topo.get_num_joints())
    for b in range(LANES):
        args = oracle_args(fn, q[:, b], qd[:, b], qdd[:, b], u[:, b])
        got = _arrays(getattr(oracle, fn)(topo, *args))
        want = _arrays(getattr(jax_oracle, fn)(jtopo, *args))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float64
            np.testing.assert_array_equal(g, w)


# each plain op and the oracle function it is held to: (op on lane-major
# tensors, oracle on one sample) -> one output
PLAIN = {
    "rnea": (lambda m, q, qd, qdd, u: rnea(m, q, qd, qdd),
             lambda t, q, qd, qdd, u: oracle.rnea(t, q, qd, qdd)[0]),
    "minv": (lambda m, q, qd, qdd, u: minv(m, q),
             lambda t, q, qd, qdd, u: oracle.minv(t, q)),
    "crba": (lambda m, q, qd, qdd, u: crba(m, q),
             lambda t, q, qd, qdd, u: oracle.crba(t, q)),
    "forward_dynamics": (
        lambda m, q, qd, qdd, u: forward_dynamics(m, q, qd, u),
        lambda t, q, qd, qdd, u: oracle.forward_dynamics(t, q, qd, u)),
    "aba": (lambda m, q, qd, qdd, u: aba(m, q, qd, u),
            lambda t, q, qd, qdd, u: oracle.aba(t, q, qd, u)),
    "id_grad": (lambda m, q, qd, qdd, u: id_grad(m, q, qd, qdd),
                lambda t, q, qd, qdd, u: oracle.rnea_grad(t, q, qd, qdd)),
    "fd_grad": (lambda m, q, qd, qdd, u: fd_grad(m, q, qd, u),
                lambda t, q, qd, qdd, u: oracle.fd_grad(t, q, qd, u)[0]),
}


@pytest.mark.parametrize("fn", list(PLAIN))
@pytest.mark.parametrize("robot", ROBOTS)
def test_plain_ops_match_the_oracle(robot, fn):
    topo = load_robot(robot)
    m = build_model(topo, dtype=torch.float64, device="cpu")
    xs = samples(m.n, seed=1)
    op, ref = PLAIN[fn]
    got = op(m, *map(torch.as_tensor, xs)).numpy()
    for b in range(LANES):
        want = ref(topo, *(x[:, b] for x in xs))
        np.testing.assert_allclose(got[..., b], want, rtol=0, atol=1e-10)


# each debug dump: (the port's args, the JAX package's args) from
# lane-major numpy (q, qd, qdd, u)
STAGES = {"rnea_stages": lambda q, qd, qdd, u: (q, qd, qdd),
          "minv_stages": lambda q, qd, qdd, u: (q,),
          "id_grad_stages": lambda q, qd, qdd, u: (q, qd, qdd),
          "aba_stages": lambda q, qd, qdd, u: (q, qd, u),
          "so_stages": lambda q, qd, qdd, u: (q, qd, qdd)}


@pytest.mark.parametrize("name", list(STAGES))
@pytest.mark.parametrize("robot", ["pendulum2", "hyq"])
def test_debug_stages_match_jax(robot, name):
    m = build_model(load_robot(robot), dtype=torch.float64, device="cpu")
    jm = jax_build_model(jax_load_robot(robot), dtype=jnp.float64)
    args = STAGES[name](*samples(m.n, seed=2))
    got = getattr(debug, name)(m, *map(torch.as_tensor, args))
    want = getattr(jax_debug, name)(jm, *map(jnp.asarray, args))
    assert list(got) == list(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("name", ["rnea", "minv", "id_grad", "aba"])
@pytest.mark.parametrize("robot", ["pendulum2", "hyq"])
def test_debug_stages_match_the_oracle(robot, name):
    topo = load_robot(robot)
    m = build_model(topo, dtype=torch.float64, device="cpu")
    q, qd, qdd, u = samples(m.n, seed=3)
    args = STAGES[f"{name}_stages"](q, qd, qdd, u)
    got = getattr(debug, f"{name}_stages")(m, *map(torch.as_tensor, args))
    for b in range(LANES):
        want = getattr(debug, f"oracle_{name}_stages")(
            topo, *(a[:, b] for a in args))
        report = debug.diff_stages(
            {k: v[..., b:b + 1] for k, v in got.items()}, want)
        assert set(report) == set(want) and len(report) >= 3, report
        assert max(report.values()) <= 1e-10, report


def test_print_stages_prints_what_the_jax_one_prints(capsys):
    m = build_model(load_robot("hyq"), dtype=torch.float64, device="cpu")
    st = debug.rnea_stages(m, *map(torch.as_tensor,
                                   samples(m.n, seed=4)[:3]))
    debug.print_stages(st, lane=1)
    got = capsys.readouterr().out
    jax_debug.print_stages(st, lane=1)
    assert got == capsys.readouterr().out and "c =" in got


def test_errors_behave_as_jax():
    x = np.array([1.0, 2.0])
    assert errors.assert_finite(torch.as_tensor(x)) is not None
    bad = np.array([1.0, np.nan])
    msgs = []
    for mod, wrap in ((errors, torch.as_tensor), (jax_errors, jnp.asarray)):
        with pytest.raises(FloatingPointError) as e:
            mod.assert_finite(wrap(bad), "x")
        msgs.append(str(e.value))
        fn = mod.checked(lambda a: (a * 2, {"b": a, "a": None}), "fn")
        fn(wrap(x))
        with pytest.raises(FloatingPointError) as e:
            fn(wrap(np.array([1.0, np.inf])))
        msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:] and "fn output 0" in msgs[1]
    for robot in ("iiwa", "pendulum2"):
        m = build_model(load_robot(robot), dtype=torch.float64, device="cpu")
        jm = jax_build_model(jax_load_robot(robot), dtype=jnp.float64)
        q = np.random.default_rng(5).uniform(-3, 3, (6, m.n))
        for args in ((q,), (q[0],), (q.T, False), (torch.as_tensor(q),)):
            got = errors.check_joint_limits(m, *args)
            want = jax_errors.check_joint_limits(jm, *(
                np.asarray(a) if isinstance(a, torch.Tensor) else a
                for a in args))
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.bool_
        assert robot == "pendulum2" or 0 < got.sum() < len(got)


def test_reference_and_utils_import_no_jax():
    code = (
        "import sys\n"
        "import gridcodegenerator_tpu_torch.reference.oracle\n"
        "import gridcodegenerator_tpu_torch.reference.spatial_np\n"
        "import gridcodegenerator_tpu_torch.utils.debug\n"
        "import gridcodegenerator_tpu_torch.utils.errors\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'gridcodegenerator_tpu']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
