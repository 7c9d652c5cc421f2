"""The port's floating base against the JAX package's JVP routes (CPU,
float64).

The part of ``tests/test_torch_floating.py`` whose eager JAX references take
most of a minute: ``GRiD.d2eepos`` on the four floating robots (the JAX
Hessian's nested JVPs through the pose extraction, 7x7 at the root), and
the JAX ``id_grad_seeded`` (dc_du by JVP-seeding RNEA through the joint
transforms, the base in the same body-frame chart) as a second witness of
the port's ``id_grad`` on the branched hyq_floating. Same inputs, same
tolerance: 1e-10 of each output's scale.
"""

import numpy as np
import pytest
import torch

from gridcodegenerator_tpu.ops import id_grad as jax_id_grad
from gridcodegenerator_tpu_torch.ops.id_grad import id_grad
from test_torch_floating import ROBOTS, Robot, _scale_close, check_method

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ROBOTS)
def test_grid_d2eepos_matches_jax(name):
    r = Robot(name)
    check_method(r, "d2eepos", "d2eepos")
    npos = r.g.num_pos
    H = r.g.d2eepos(r.x["q"])
    assert H.shape == (3, 6 * r.g.num_ees, npos, npos)
    assert torch.equal(H, H.transpose(-1, -2))


def test_id_grad_matches_jax_seeded_route_on_hyq():
    r = Robot("hyq_floating")
    got = id_grad(r.g.model, *(torch.as_tensor(r.x[k].T)
                               for k in ("q", "qd", "qdd")))
    want = jax_id_grad.id_grad_seeded(r.jm, r.lanes("q"), r.lanes("qd"),
                                      r.lanes("qdd"))
    _scale_close(got.numpy(), np.asarray(want))
