"""The port's robot model against the JAX package's (CPU, float64).

Both packages parse the same URDFs; the port's numpy copies of the topology
and zoo must give the JAX model's arrays and static fields exactly, and
``model_from_numpy`` must carry a JAX model's constants across unchanged.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.models.zoo import load_robot as jax_load_robot
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       build_model,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.models.zoo import list_robots, load_robot
from gridcodegenerator_tpu_torch.ops.aba import aba
from gridcodegenerator_tpu_torch.ops.common import pos_layout, vel_layout
from gridcodegenerator_tpu_torch.ops.xforms import all_xmats

torch.set_num_threads(1)

ROBOTS = ["pendulum2", "iiwa", "hyq", "mixed5", "iiwa14"]


def _jax_leaves(jm):
    arrays = {f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS}
    static = {f: getattr(jm, f) for f in STATIC_FIELDS}
    return arrays, static


@pytest.mark.parametrize("name", ROBOTS)
def test_build_model_matches_jax(name):
    jm = jax_build_model(jax_load_robot(name), dtype=jnp.float64)
    tm = build_model(load_robot(name), dtype=torch.float64, device="cpu")
    arrays, static = _jax_leaves(jm)
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), arrays[f],
                                      err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(tm, f) == static[f], f


@pytest.mark.parametrize("name", ["pendulum2", "iiwa"])
def test_model_from_numpy_carries_jax_constants(name):
    jm = jax_build_model(jax_load_robot(name), dtype=jnp.float64)
    arrays, static = _jax_leaves(jm)
    tm = model_from_numpy(arrays, static, device="cpu")
    assert tm.dtype == torch.float64 and tm.device.type == "cpu"
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), arrays[f])
    t32 = model_from_numpy(arrays, static, dtype=torch.float32,
                           device="cpu")
    assert all(getattr(t32, f).dtype == torch.float32 for f in ARRAY_FIELDS)
    back = t32.to(dtype=torch.float64)
    np.testing.assert_array_equal(back.Imat.numpy(),
                                  arrays["Imat"].astype(np.float32))


def test_zoo_lists_the_same_robots():
    from gridcodegenerator_tpu.models.zoo import list_robots as jax_list
    assert list_robots() == jax_list()


def test_floating_base_raises():
    """A floating model is served now: its position and velocity layouts
    put the root's 7 coordinates and 6 velocities first, ``all_xmats``
    reads the root's transform from them, and ``aba`` takes it."""
    m = build_model(load_robot("iiwa_floating"), dtype=torch.float64,
                    device="cpu")
    assert m.floating_base and (m.num_pos, m.num_vel) == (14, 13)
    assert pos_layout(m) == [(0, 7)] + [(7 + i, 1) for i in range(7)]
    assert vel_layout(m) == [(0, 6)] + [(6 + i, 1) for i in range(7)]
    q = torch.zeros((m.num_pos, 2), dtype=torch.float64)
    q[6] = 1.0                                  # the identity quaternion
    Xs = all_xmats(m, q)
    assert len(Xs) == 8
    assert torch.equal(Xs[0], torch.eye(6, dtype=torch.float64)[:, :, None]
                       .expand(6, 6, 2))
    fixed = build_model(load_robot("iiwa"), dtype=torch.float64,
                        device="cpu")
    for a, b in zip(Xs[1:], all_xmats(fixed, q[7:])):
        assert torch.equal(a, b)
    qd = torch.zeros((m.num_vel, 2), dtype=torch.float64)
    assert aba(m, q, qd, qd).shape == (13, 2)


@pytest.mark.parametrize("fname", ["iiwa14.urdf", "gym_ant.urdf",
                                   "gym_humanoid.urdf", "dm_quadruped.urdf"])
def test_vendor_urdfs_are_the_ports_own_copies(fname):
    """The port reads its own copy of each vendor URDF, inside the port's
    package, byte for byte the JAX package's."""
    from pathlib import Path

    import gridcodegenerator_tpu
    import gridcodegenerator_tpu_torch
    from gridcodegenerator_tpu_torch.models import zoo

    port = Path(gridcodegenerator_tpu_torch.__file__).resolve().parent
    vendor = Path(zoo.VENDOR_DIR).resolve()
    assert vendor.is_relative_to(port)
    jax_copy = (Path(gridcodegenerator_tpu.__file__).resolve().parent
                / "models" / "vendor" / fname)
    assert (vendor / fname).read_bytes() == jax_copy.read_bytes()


def test_top_level_exports_cover_the_jax_packages():
    """The port's package exports every name of the JAX package's
    ``__all__``, each the port's own (nothing of the JAX package)."""
    import gridcodegenerator_tpu
    import gridcodegenerator_tpu_torch

    assert set(gridcodegenerator_tpu.__all__) <= set(
        gridcodegenerator_tpu_torch.__all__)
    for name in gridcodegenerator_tpu_torch.__all__:
        obj = getattr(gridcodegenerator_tpu_torch, name)
        assert getattr(obj, "__module__", "gridcodegenerator_tpu_torch"
                       ).startswith("gridcodegenerator_tpu_torch"), name
    assert (gridcodegenerator_tpu_torch.__version__
            == gridcodegenerator_tpu.__version__)


@pytest.mark.parametrize("name", list_robots())
def test_robot_urdf_is_the_jax_packages(name):
    """``robot_urdf`` gives the JAX package's string for every bundled
    robot, ``_floating`` names included."""
    from gridcodegenerator_tpu.models.zoo import robot_urdf as jax_robot_urdf
    from gridcodegenerator_tpu_torch import robot_urdf

    assert robot_urdf(name) == jax_robot_urdf(name)
