"""Config 5's scenario-tree MPC step above 28 joints against the JAX
package (CPU, float64).

On atlas_grippers34 (34 joints: atlas with a 3-joint gripper on each hand,
tests/torch_big_robots.py; both packages parse the same URDF string with
their own ``parse_urdf``), the port's one-device scenario step (S 8, N 4,
1 iteration, dt 0.002 as tests/test_torch_big_robots.py sets it; config
5's QuadCost) against the JAX ``make_scenario_step`` on a one-device mesh,
within 1e-8 of scale. The JAX step's XLA compile is most of this file's
time (80-83 s and 8.2 GB at its peak on a quiet machine) and does not
shrink with the shapes: at 30 or 32 joints, or with S 2 or N 2, it took
3-8x the CPU time. Eagerly it takes longer still.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gridcodegenerator_tpu.models.model import build_model as jax_build_model
from gridcodegenerator_tpu.parallel.mesh import make_mesh
from gridcodegenerator_tpu.parallel.scenario import \
    ScenarioMPCConfig as JaxScenarioMPCConfig
from gridcodegenerator_tpu.parallel.scenario import \
    make_scenario_step as jax_make_scenario_step
from gridcodegenerator_tpu.topology.urdf import parse_urdf as jax_parse_urdf
from gridcodegenerator_tpu.trajopt.cost import QuadCost as JaxQuadCost
from gridcodegenerator_tpu.trajopt.ilqr import ILQRConfig as JaxILQRConfig
from gridcodegenerator_tpu_torch.models.model import (ARRAY_FIELDS,
                                                       STATIC_FIELDS,
                                                       model_from_numpy)
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.parallel.scenario import (ScenarioMPCConfig,
                                                           make_scenario_step)
from gridcodegenerator_tpu_torch.trajopt.cost import QuadCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig
from torch_big_robots import atlas_hands_name, atlas_hands_urdf

torch.set_num_threads(1)
GRIPPERS = 3   # joints a hand: atlas_grippers34
DT = 0.002     # config 5's step on the hands (test_torch_big_robots.py)


def jax_model(k):
    return jax_build_model(jax_parse_urdf(atlas_hands_urdf(k),
                                          name=atlas_hands_name(k)),
                           dtype=jnp.float64)


def scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / scale


# ---------------------------------------------------------------------------
# config 5's scenario step on atlas_grippers34
# ---------------------------------------------------------------------------

def test_scenario_step_matches_jax_above_28():
    S, N = 8, 4
    jm = jax_model(GRIPPERS)
    tm = model_from_numpy(
        {f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS},
        {f: getattr(jm, f) for f in STATIC_FIELDS}, device="cpu")
    n = jm.n
    w = dict(Q=np.full(2 * n, 0.1), R=np.full(n, 1e-3),
             Qf=np.full(2 * n, 10.0), x_goal=np.zeros(2 * n))
    w["x_goal"][0] = 0.2
    jstep = jax_make_scenario_step(
        jm, JaxQuadCost(**{k: jnp.asarray(v) for k, v in w.items()}),
        JaxScenarioMPCConfig(JaxILQRConfig(N=N, dt=DT, iters=1), S),
        make_mesh(1))
    tstep = make_scenario_step(
        tm, QuadCost(**{k: torch.as_tensor(v) for k, v in w.items()}),
        ScenarioMPCConfig(ILQRConfig(N=N, dt=DT, iters=1), S))
    x0s = 0.02 * np.random.default_rng(0).standard_normal((2 * n, S))
    U = np.zeros((N, n, S))
    ref = jstep(jnp.asarray(x0s), jnp.asarray(U))
    build.reset_counters()
    got = tstep(torch.as_tensor(x0s), torch.as_tensor(U))
    assert dict(build.PLAIN_CALLS) == {"rollout": 1, "fd_du": 1, "riccati": 1,
                                       "linesearch_rollout": 1}
    for ours, theirs in zip(got, ref):
        assert np.isfinite(ours.numpy()).all()
        assert scaled_err(ours.numpy(), theirs) <= 1e-8
