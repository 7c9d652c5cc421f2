"""The port's per-robot code generator (``codegen/emit.py:gen_all_code``).

* The emitted module imports without a card and builds its GRiD at first
  use; it imports nothing of jax or of the JAX package (its source, and the
  modules a fresh interpreter holds after importing it).
* ``init_robot()`` rebuilds the topology exactly (atol 0).
* Its 12 algorithms on the CPU match the port's GRiD on the same inputs
  exactly (the same plain versions on the same constants), in float64; its
  ``<name>_kernel()`` callables run the same plain versions on lane-major
  tensors.
* On pendulum2 they match the module the JAX package's ``gen_all_code``
  emits (float32, that module's dtype): within 1e-5 of each output's scale
  max(1, max|ref|), float32 rounding summed in other orders.
"""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gridcodegenerator_tpu_torch import GRiD
from gridcodegenerator_tpu_torch.codegen import ALGORITHMS, gen_all_code
from gridcodegenerator_tpu_torch.codegen.emit import KERNELS
from gridcodegenerator_tpu_torch.models.zoo import load_robot
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.ops.cuda import kernels as K

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
NARGS = {name: len(args.split(", ")) for name, _, args in ALGORITHMS}
JAX_F32_ATOL = 1e-5


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", params=["pendulum2", "iiwa"])
def emitted(request, tmp_path_factory):
    robot = request.param
    path = gen_all_code(load_robot(robot), file_namespace=f"grid_{robot}",
                        path=str(tmp_path_factory.mktemp("gen")
                                 / f"grid_{robot}.py"))
    return robot, path


def _inputs(n, B, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (B, n)) for _ in range(3)]


def test_module_imports_without_a_card(emitted, monkeypatch):
    robot, path = emitted
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _load(path, f"grid_{robot}_nocard")
    assert mod.ROBOT_NAME == robot
    assert mod.NUM_JOINTS == len(load_robot(robot).joints)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.grid()   # the card by default: no fallback to the CPU
    mod.configure(device="cpu")
    assert mod.grid().device.type == "cpu"


def test_module_imports_nothing_of_jax(emitted):
    robot, path = emitted
    tree = ast.parse(Path(path).read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)]
    assert {m.split(".")[0] for m in names} == {
        "functools", "numpy", "torch", "gridcodegenerator_tpu_torch"}
    code = (f"import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('m', {path!r})\n"
            f"mod = importlib.util.module_from_spec(spec)\n"
            f"spec.loader.exec_module(mod)\n"
            f"mod.configure(device='cpu')\n"
            f"mod.id(*[[0.1] * mod.NUM_JOINTS] * 3)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"('jax', 'gridcodegenerator_tpu')]\n"
            f"assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_init_robot_rebuilds_the_topology(emitted):
    robot, path = emitted
    mod = _load(path, f"grid_{robot}_topo")
    want, got = load_robot(robot), mod.init_robot()
    assert got.name == want.name and got.floating_base == want.floating_base
    assert len(got.joints) == len(want.joints)
    for a, b in zip(got.joints, want.joints):
        for f in ("name", "jid", "parent_id", "jtype", "S_ind", "damping",
                  "limit_lower", "limit_upper", "effort_limit",
                  "velocity_limit", "parent_link", "child_link"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(a.Xtree, b.Xtree, rtol=0, atol=0)
        np.testing.assert_allclose(a.Ttree, b.Ttree, rtol=0, atol=0)
    for i in range(len(want.joints)):
        np.testing.assert_allclose(got.get_Imat_by_id(i),
                                   want.get_Imat_by_id(i), rtol=0, atol=0)
    np.testing.assert_allclose(got.get_Imats_ordered_by_id()[0],
                               want.get_Imats_ordered_by_id()[0], rtol=0,
                               atol=0)
    assert len(got.fixed_joints) == len(want.fixed_joints)
    for a, b in zip(got.fixed_joints, want.fixed_joints):
        assert (a.name, a.fid, a.parent_jid, a.parent_link, a.child_link) == (
            b.name, b.fid, b.parent_jid, b.parent_link, b.child_link)
        np.testing.assert_allclose(a.Ttree, b.Ttree, rtol=0, atol=0)


@pytest.mark.parametrize("algo", [a[0] for a in ALGORITHMS])
def test_algorithms_match_the_port_grid(emitted, algo):
    robot, path = emitted
    mod = _load(path, f"grid_{robot}_algos")
    mod.configure(device="cpu", dtype=torch.float64)
    ref = GRiD(robot, dtype=torch.float64, device="cpu")
    x = _inputs(ref.n, 3, seed=2)[:NARGS[algo]]
    plain = {KERNELS[algo][0]: 1}
    build.reset_counters()
    got = getattr(mod, algo)(*x)
    assert dict(build.PLAIN_CALLS) == plain and not build.LAUNCHES
    torch.testing.assert_close(got, getattr(ref, algo)(*x), rtol=0, atol=0)
    # the kernel tier on lane-major tensors: the same numbers
    lanes = [torch.as_tensor(a.T).contiguous() for a in x]
    build.reset_counters()
    out = getattr(mod, algo + "_kernel")()(*lanes)
    assert dict(build.PLAIN_CALLS) == plain and not build.LAUNCHES
    out = out[0] if algo == "fd_du" else out   # (df_du, qdd, Minv)
    torch.testing.assert_close(out.movedim(-1, 0), got, rtol=0, atol=0)


@pytest.fixture(scope="module")
def jax_pendulum(tmp_path_factory):
    from gridcodegenerator_tpu.codegen.emit import gen_all_code as jax_gen
    from gridcodegenerator_tpu.models.zoo import load_robot as jax_load
    d = tmp_path_factory.mktemp("gen_jax")
    return _load(jax_gen(jax_load("pendulum2"), file_namespace="grid_jax_pend",
                         path=str(d / "grid_jax_pend.py")), "grid_jax_pend")


@pytest.mark.parametrize("algo", [a[0] for a in ALGORITHMS])
def test_pendulum_algorithms_match_the_jax_module(jax_pendulum, tmp_path,
                                                  algo):
    mod = _load(gen_all_code(load_robot("pendulum2"),
                             path=str(tmp_path / "grid_pend.py")),
                "grid_pend_vs_jax")
    mod.configure(device="cpu")   # float32, the JAX module's dtype
    x = [a.astype(np.float32) for a in _inputs(2, 4, seed=3)][:NARGS[algo]]
    got = getattr(mod, algo)(*x)
    want = np.asarray(getattr(jax_pendulum, algo)(*x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_F32_ATOL
                               * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("algo", ["idsva_so", "fdsva_so"])
def test_atlas_module_serves_the_second_order_calls(tmp_path, algo):
    """The module of a 28-joint robot (atlas): its second-order calls match
    the port's GRiD on the CPU, and its kernel tier is the wrapper whose
    route at 28 joints is fdsva_so's composed one and idsva_so's bands."""
    path = gen_all_code(load_robot("atlas"), file_namespace="grid_atlas",
                        path=str(tmp_path / "grid_atlas.py"))
    mod = _load(path, f"grid_atlas_{algo}")
    mod.configure(device="cpu", dtype=torch.float64)
    ref = GRiD("atlas", dtype=torch.float64, device="cpu")
    x = _inputs(ref.n, 2, seed=3)
    build.reset_counters()
    got = getattr(mod, algo)(*x)
    assert dict(build.PLAIN_CALLS) == {algo: 1} and not build.LAUNCHES
    torch.testing.assert_close(got, getattr(ref, algo)(*x), rtol=0, atol=0)
    kern = getattr(mod, algo + "_kernel")()
    assert kern.func is getattr(K, algo) and kern.args[0] is mod.grid().model
