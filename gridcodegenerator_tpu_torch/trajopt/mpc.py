"""Receding-horizon MPC on the batched iLQR/DDP solver.

The counterpart of ``gridcodegenerator_tpu/trajopt/mpc.py:MPC``. The
controller keeps the whole plan on the device and warm-starts each replan
with the previous solution shifted one knot (``U[1:] ++ U[-1:]``). Each
control period is one solve and one semi-implicit Euler step of the
plant: on the card the solve's kernels and one ``aba`` launch. The cost is
any ``CostModel`` the solver takes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.model import RobotModel
from .ilqr import ILQRConfig, dynamics_step, make_ilqr


def shift_warm_start(U: torch.Tensor) -> torch.Tensor:
    """The next replan's warm start from a plan U (N, n, B): U[1:] with its
    last knot repeated."""
    return torch.cat([U[1:], U[-1:]], dim=0)


@dataclasses.dataclass
class MPC:
    model: RobotModel
    cost: object
    cfg: ILQRConfig

    def __post_init__(self):
        self._solve = make_ilqr(self.model, self.cost, self.cfg)

    def replan(self, x0: torch.Tensor, U_warm: torch.Tensor):
        """One MPC replan: x0 (2n, B), U_warm (N, n, B).

        Returns (u0 (n, B), U_next (N, n, B) shifted warm start, cost (B,)).
        """
        res = self._solve(x0, U_warm)
        return res.U[0], shift_warm_start(res.U), res.cost

    def rollout_closed_loop(self, x0: torch.Tensor, steps: int):
        """Simulate ``steps`` control periods of the closed loop (replan each
        period, apply the first control). Returns (states (steps+1, 2n, B),
        controls (steps, n, B), costs (steps, B))."""
        n = self.model.num_vel
        x = x0.to(self.model.dtype)
        U = torch.zeros((self.cfg.N, n, x.shape[-1]), dtype=x.dtype,
                        device=x.device)
        xs, us, cs = [x], [], []
        for _ in range(steps):
            u0, U, c = self.replan(x, U)
            x = dynamics_step(self.model, x, u0, self.cfg.dt,
                              self.cfg.gravity)
            xs.append(x)
            us.append(u0)
            cs.append(c)
        return torch.stack(xs), torch.stack(us), torch.stack(cs)
