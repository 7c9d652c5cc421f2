"""Scenario-tree MPC, on one device or on a mesh of ranks.

The counterpart of ``gridcodegenerator_tpu/parallel/scenario.py``. One
batched solve runs the perturbed scenarios of the current state as lanes
(on the card, with a QuadCost: one rollout, then fd_du, the stationary
Riccati sweep and the line search each iteration, every kernel over the
scenarios at once; any ``CostModel`` the solver takes runs), and the
scenario-tree consensus (all scenarios share the first move) is the
softmin-by-cost weighted mean of their first controls,
w = exp(-temp (c - min c)).

Without a mesh the step solves all S scenarios on one device. With a mesh
(``parallel/mesh.py``) it is the body of the JAX package's ``shard_map``,
run on every rank:

* the scenarios split over every axis but the knot axis ("dp"), each rank
  solving its S/ranks as lanes;
* where the mesh has a knot axis ("kp") of size D > 1 that divides the
  horizon (first order, no ``parallel_riccati``, a time-invariant cost),
  the solve's linearization and Riccati backward split the knots over it
  (``ILQRConfig.knot_axis``, ``parallel/knot_riccati.py``): each kp rank
  linearizes N/D knots, the value recursion reduces in ceil(log2 D)
  point-to-point rounds, and the gains are gathered for the forward pass,
  which every kp rank runs whole; otherwise the scenarios split over all
  axes;
* the consensus reduces over all axes: ``pmin`` of the local minimum cost,
  then ``psum`` of the weighted first controls and of the weights (kp
  replicas scale both alike).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.model import RobotModel
from ..trajopt.ilqr import ILQRConfig, dynamics_step, make_ilqr
from ..trajopt.mpc import shift_warm_start
from .collectives import pmin, psum
from .mesh import shard_along


@dataclasses.dataclass(frozen=True)
class ScenarioMPCConfig:
    ilqr: ILQRConfig
    n_scenarios: int              # scenarios S (divisible by the dp ranks)
    consensus_temp: float = 1.0   # softmin temperature of the cost weights


def consensus(u0s: torch.Tensor, costs: torch.Tensor, temp: float):
    """The softmin-by-cost weighted mean of the first controls u0s (n, S)
    under costs (S,) -> (n,)."""
    w = torch.exp(-temp * (costs - costs.min()))
    return (u0s * w[None]).sum(dim=1) / w.sum()


def scenario_axes(cost, cfg: ScenarioMPCConfig, mesh, knot_axis: str = "kp"):
    """(the axes the scenarios split over, the knot-sharded solver config):
    the knot axis joins the solve where JAX's rule takes it (its size D > 1
    divides N, first order, no parallel_riccati, a time-invariant cost)."""
    axes = tuple(mesh.axis_names)
    kp = mesh.shape[knot_axis] if knot_axis in axes else 1
    icfg = cfg.ilqr
    use_kp = (kp > 1 and icfg.N % kp == 0
              and not icfg.use_second_order and not icfg.parallel_riccati
              and getattr(cost, "time_invariant", False))
    if not use_kp:
        return axes, icfg
    return (tuple(a for a in axes if a != knot_axis),
            dataclasses.replace(icfg, knot_axis=knot_axis,
                                knot_axis_size=kp))


def make_scenario_step(model: RobotModel, cost, cfg: ScenarioMPCConfig,
                       mesh=None, knot_axis: str = "kp"):
    """Build the scenario-tree MPC step:

    step(x0s (2n, S_loc), U_warm (N, n, S_loc)) ->
        (u0_consensus (n,), U_next (N, n, S_loc), costs (S_loc,))

    ``x0s`` holds the perturbed scenario states on the trailing lane axis;
    U_next is each scenario's plan shifted one knot, the next step's warm
    start. Without a mesh S_loc = S. With a mesh the step takes and returns
    this rank's shards (S_loc = S over the ranks of ``step.scenario_axes``;
    ``parallel/mesh.py:shard_along(x, mesh, -1, step.scenario_axes)`` cuts
    them), and u0 is the same on every rank.
    """
    S = cfg.n_scenarios
    if mesh is None:
        sc_axes, icfg, S_loc = (), cfg.ilqr, S
    else:
        sc_axes, icfg = scenario_axes(cost, cfg, mesh, knot_axis)
        ranks = math.prod(mesh.shape[a] for a in sc_axes)
        if S % ranks:
            raise ValueError(f"{S} scenarios do not split over the "
                             f"{ranks} ranks of {sc_axes}")
        S_loc = S // ranks
        every = mesh.axis(mesh.axis_names)
    solve = make_ilqr(model, cost, icfg, mesh=mesh)

    def step(x0s: torch.Tensor, U_warm: torch.Tensor):
        if x0s.shape[-1] != S_loc or U_warm.shape[-1] != S_loc:
            raise ValueError(f"scenario step: {S_loc} scenarios expected, "
                             f"got {tuple(x0s.shape)} and "
                             f"{tuple(U_warm.shape)}")
        res = solve(x0s, U_warm)
        if mesh is None:
            u0 = consensus(res.U[0], res.cost, cfg.consensus_temp)
        else:
            cmin = pmin(res.cost.min()[None], every)
            w = torch.exp(-cfg.consensus_temp * (res.cost - cmin))
            nd = psum(torch.cat([(res.U[0] * w[None]).sum(dim=1),
                                 w.sum()[None]]), every)
            u0 = nd[:-1] / nd[-1]
        return u0, shift_warm_start(res.U), res.cost

    step.scenario_axes = sc_axes
    step.local_scenarios = S_loc
    return step


def perturb_scenarios(generator: torch.Generator, x0: torch.Tensor, S: int,
                      scale: float = 0.01) -> torch.Tensor:
    """S perturbed copies of x0 (2n,) -> (2n, S): x0 plus ``scale`` times
    standard normal draws from ``generator`` (drawn on its device, in x0's
    dtype; torch cannot reproduce ``jax.random``'s draws)."""
    noise = torch.randn((x0.shape[0], S), generator=generator,
                        dtype=x0.dtype, device=generator.device)
    return x0[:, None] + scale * noise.to(x0.device)


def closed_loop(model: RobotModel, cost, cfg: ScenarioMPCConfig,
                x0: torch.Tensor, steps: int, generator=None,
                noise_scale: float = 0.01, mesh=None):
    """Run the scenario-tree MPC closed loop for ``steps`` periods: each
    period perturbs the state into S scenarios, takes one scenario step
    (warm-started by the last) and applies the consensus control to the
    plant (one semi-implicit Euler step: the ``aba`` kernel on the card).
    With a mesh every rank draws all S scenarios from the same seeded
    generator and solves its shard, so the draws are the one-device
    loop's. Returns (states (steps+1, 2n), controls (steps, n))."""
    if generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    step = make_scenario_step(model, cost, cfg, mesh)
    n, S = model.num_vel, cfg.n_scenarios
    x = x0.to(model.dtype)
    U = torch.zeros((cfg.ilqr.N, n, step.local_scenarios), dtype=x.dtype,
                    device=x.device)
    xs, us = [x], []
    for _ in range(steps):
        x0s = perturb_scenarios(generator, x, S, noise_scale)
        if mesh is not None:
            x0s = shard_along(x0s, mesh, -1, step.scenario_axes)
        u0, U, _ = step(x0s, U)
        x = dynamics_step(model, x[:, None], u0[:, None], cfg.ilqr.dt,
                          cfg.ilqr.gravity)[:, 0]
        xs.append(x)
        us.append(u0)
    return torch.stack(xs), torch.stack(us)
