"""Scenario-tree MPC on one device.

The counterpart of ``gridcodegenerator_tpu/parallel/scenario.py`` without
its mesh: one batched solve runs all S perturbed scenarios of the current
state as lanes (on the card, with a QuadCost: one rollout, then fd_du,
the stationary Riccati sweep and the line search each iteration, every
kernel over all S scenarios at once; any ``CostModel`` the solver takes
runs), and the scenario-tree consensus (all scenarios share
the first move) is the softmin-by-cost weighted mean of their first
controls, w = exp(-temp (c - min c)). The JAX package shards the
scenarios over a device mesh and reduces with ``psum``; the port's
multi-device layer is not written yet, so a mesh raises.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.model import RobotModel
from ..trajopt.ilqr import ILQRConfig, dynamics_step, make_ilqr
from ..trajopt.mpc import shift_warm_start


@dataclasses.dataclass(frozen=True)
class ScenarioMPCConfig:
    ilqr: ILQRConfig
    n_scenarios: int              # scenarios S, the solve's lanes
    consensus_temp: float = 1.0   # softmin temperature of the cost weights


def _single_device(mesh, knot_axis):
    if mesh is not None or knot_axis is not None:
        raise NotImplementedError(
            "the multi-device scenario step (a mesh, a knot axis) is not "
            "ported: the port's scenario step runs on one device")


def consensus(u0s: torch.Tensor, costs: torch.Tensor, temp: float):
    """The softmin-by-cost weighted mean of the first controls u0s (n, S)
    under costs (S,) -> (n,)."""
    w = torch.exp(-temp * (costs - costs.min()))
    return (u0s * w[None]).sum(dim=1) / w.sum()


def make_scenario_step(model: RobotModel, cost, cfg: ScenarioMPCConfig,
                       mesh=None, knot_axis=None):
    """Build the scenario-tree MPC step:

    step(x0s (2n, S), U_warm (N, n, S)) ->
        (u0_consensus (n,), U_next (N, n, S), costs (S,))

    ``x0s`` holds the perturbed scenario states on the trailing lane axis;
    U_next is each scenario's plan shifted one knot, the next step's warm
    start.
    """
    _single_device(mesh, knot_axis)
    solve = make_ilqr(model, cost, cfg.ilqr)
    S = cfg.n_scenarios

    def step(x0s: torch.Tensor, U_warm: torch.Tensor):
        if x0s.shape[-1] != S or U_warm.shape[-1] != S:
            raise ValueError(f"scenario step: {S} scenarios expected, got "
                             f"{tuple(x0s.shape)} and "
                             f"{tuple(U_warm.shape)}")
        res = solve(x0s, U_warm)
        u0 = consensus(res.U[0], res.cost, cfg.consensus_temp)
        return u0, shift_warm_start(res.U), res.cost

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
    Returns (states (steps+1, 2n), controls (steps, n))."""
    _single_device(mesh, None)
    if generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    step = make_scenario_step(model, cost, cfg)
    n, S = model.num_vel, cfg.n_scenarios
    x = x0.to(model.dtype)
    U = torch.zeros((cfg.ilqr.N, n, S), dtype=x.dtype, device=x.device)
    xs, us = [x], []
    for _ in range(steps):
        x0s = perturb_scenarios(generator, x, S, noise_scale)
        u0, U, _ = step(x0s, U)
        x = dynamics_step(model, x[:, None], u0[:, None], cfg.ilqr.dt,
                          cfg.ilqr.gravity)[:, 0]
        xs.append(x)
        us.append(u0)
    return torch.stack(xs), torch.stack(us)
