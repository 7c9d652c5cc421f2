"""Cost models for the trajectory optimizers.

The counterpart of ``gridcodegenerator_tpu/trajopt/cost.py``. The solvers
take a :class:`CostModel`: stage and terminal values and their quadratic
expansions on lane-major states x = [q; qd] (2n, B...) and controls u
(n, B...), the stage terms at the knot index ``t`` (an int). Provided:

* :class:`QuadCost` — diagonal quadratic tracking cost with closed-form
  expansions and a stationary curvature;
* :class:`EEReachCost` — 0.5*w*||ee_xyz(q) - goal||^2 with a Gauss-Newton
  Hessian from the FK Jacobian, plus quadratic velocity and control
  regularizers. Its pose and Jacobian come from the EE functions it is
  given (``ee_fns``): by default the kernel wrappers
  (``ops/cuda/kernels.py:eepos``, ``deepos``), which launch the eepos and
  deepos kernels on CUDA tensors and run the counted plain twins on CPU
  tensors; ``make_ilqr(use_kernels=False)`` hands it the plain twins.

Both take one goal shared by every problem, or one per problem ((2n, B) or
(3, B)); only the shared form is time-invariant, so only it lets the
solver fold the horizon into the lane axis (a per-problem goal cannot
broadcast against the folded N*B lanes).

Both carry the line-search hooks: ``ls_stage``/``ls_terminal`` (the cost as
the line-search kernel sums it along the sweep, in plain torch) and
``kernel_weights`` (the kernel's cost kind and its packed constants, read
from the device once, not on every launch), the counterpart of the JAX
``pallas_cost``: None where the cost is not time-invariant, as on any
``CostModel`` that does not set it; the solver then runs the line search
without a cost and sums ``stage`` and ``terminal`` over its rollouts.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..models.model import RobotModel
from ..ops import eepose as _eepose
from ..ops.cuda import kernels as _k


class CostModel:
    """Interface: all tensors lane-major, t is the knot index (an int)."""

    # True when the stage curvature (lxx, luu, lux) does not depend on
    # (x, u, t): the dense Riccati kernel then reads one curvature block
    # instead of an (N, ...) stack
    stationary_curvature = False

    # True when stage() and stage_expansion() ignore t (and the problem):
    # the solver folds the horizon into the lane axis and makes ONE stage
    # call over N*B lanes instead of N calls
    time_invariant = False

    # the line-search kernel's cost (kind and constants), or None: the
    # line search then rolls out without a cost and the solver sums stage()
    # and terminal() over its rollouts
    kernel_weights = None

    def stage(self, x, u, t):
        """-> cost per lane (B...)."""
        raise NotImplementedError

    def terminal(self, x):
        raise NotImplementedError

    def stage_expansion(self, x, u, t):
        """-> (l, lx (2n,B), lu (n,B), lxx (2n,2n,B), luu (n,n,B),
        lux (n,2n,B))."""
        raise NotImplementedError

    def terminal_expansion(self, x):
        """-> (l, lx, lxx)."""
        raise NotImplementedError


def _col(v, like):
    """A weight or goal (d,), or a per-problem goal (d, B), in the dtype and
    on the device of ``like``: (d,) as a column (d, 1...) against its batch
    axes, (d, B) as it is."""
    v = v.to(device=like.device, dtype=like.dtype)
    return v.reshape((-1,) + (1,) * (like.ndim - 1)) if v.ndim == 1 else v


@dataclasses.dataclass(frozen=True, eq=False)
class QuadCost(CostModel):
    """0.5 (x-xg)^T Q (x-xg) + 0.5 u^T R u, terminal Qf; diagonal weights."""

    Q: torch.Tensor         # (2n,)
    R: torch.Tensor         # (n,)
    Qf: torch.Tensor        # (2n,)
    x_goal: torch.Tensor    # (2n,) shared, or (2n, B) one per problem

    # the stage curvature (lxx, luu, lux) does not depend on x, u or t
    stationary_curvature = True

    @property
    def time_invariant(self):
        return self.x_goal.ndim == 1

    @property
    def goal_problems(self):
        """The problems the goal is given for (1 for a shared goal)."""
        return 1 if self.x_goal.ndim == 1 else self.x_goal.shape[1]

    def stage(self, x, u, t):
        dx = x - _col(self.x_goal, x)
        return (0.5 * (_col(self.Q, x) * dx * dx).sum(0)
                + 0.5 * (_col(self.R, u) * u * u).sum(0))

    def terminal(self, x):
        dx = x - _col(self.x_goal, x)
        return 0.5 * (_col(self.Qf, x) * dx * dx).sum(0)

    @staticmethod
    def _diag(w, like):
        """diag(w) broadcast over the batch of ``like``: (m, m, B...)."""
        d = torch.diag(w.to(device=like.device, dtype=like.dtype))
        return d.reshape(d.shape + (1,) * (like.ndim - 1)).expand(
            d.shape + like.shape[1:])

    def stage_expansion(self, x, u, t):
        """-> (l, lx (2n,B...), lu (n,B...), lxx (2n,2n,B...),
        luu (n,n,B...), lux (n,2n,B...)); the curvature blocks are
        broadcast views."""
        dx = x - _col(self.x_goal, x)
        lux = torch.zeros((), dtype=x.dtype, device=x.device).expand(
            (u.shape[0], x.shape[0]) + x.shape[1:])
        return (self.stage(x, u, t), _col(self.Q, x) * dx,
                _col(self.R, u) * u, self._diag(self.Q, x),
                self._diag(self.R, u), lux)

    def terminal_expansion(self, x):
        """-> (l, lx (2n,B...), lxx (2n,2n,B...))."""
        dx = x - _col(self.x_goal, x)
        return (self.terminal(x), _col(self.Qf, x) * dx,
                self._diag(self.Qf, x))

    # the line-search kernel sums exactly stage() and terminal()
    def ls_stage(self, x, u):
        return self.stage(x, u, 0)

    def ls_terminal(self, x):
        return self.terminal(x)

    @functools.cached_property
    def kernel_weights(self):
        """The line-search kernel's cost: kind "quad", constants
        Q (2n) | R (n) | Qf (2n) | x_goal (2n); None for a per-problem
        goal."""
        if not self.time_invariant:
            return None
        vals = torch.cat([self.Q, self.R, self.Qf, self.x_goal])
        return dict(kind="quad",
                    values=tuple(float(v) for v in vals.detach().cpu().double()),
                    ee_index=0)


@dataclasses.dataclass(frozen=True, eq=False)
class EEReachCost(CostModel):
    """Reach an EE xyz goal: stage/terminal GN cost on FK + regularizers."""

    model: RobotModel
    goal_xyz: torch.Tensor       # (3,) shared, or (3, B) one per problem
    w_pos: float = 1.0           # stage EE weight
    w_pos_f: float = 100.0       # terminal EE weight
    w_vel: float = 1e-2
    w_u: float = 1e-4
    ee_index: int = 0
    # (eepos, deepos), each (model, q) -> all EEs' poses (6 ne, B...) or
    # Jacobians (6 ne, n, B...); None: the kernel wrappers
    ee_fns: tuple = None

    @property
    def time_invariant(self):
        return self.goal_xyz.ndim == 1

    @property
    def goal_problems(self):
        """The problems the goal is given for (1 for a shared goal)."""
        return 1 if self.goal_xyz.ndim == 1 else self.goal_xyz.shape[1]

    @property
    def gn_factor_diags(self):
        return (self.w_vel, self.w_u)

    def _fns(self):
        return self.ee_fns or (_k.eepos, _k.deepos)

    def _err(self, q):
        """EE xyz error (3,B...) of EE ``ee_index``: one pose call."""
        pose = self._fns()[0](self.model, q.contiguous())
        k = 6 * self.ee_index
        return pose[k:k + 3] - _col(self.goal_xyz, q)

    def _err_jac(self, q):
        """EE xyz error (3,B...) and Jacobian (3,n,B...) of EE ``ee_index``:
        one pose call and one Jacobian call."""
        J = self._fns()[1](self.model, q.contiguous())
        k = 6 * self.ee_index
        return self._err(q), J[k:k + 3]

    def _stage(self, e, qd, u):
        return (0.5 * self.w_pos * (e * e).sum(0)
                + 0.5 * self.w_vel * (qd * qd).sum(0)
                + 0.5 * self.w_u * (u * u).sum(0))

    def stage(self, x, u, t):
        n = self.model.num_vel
        return self._stage(self._err(x[:n]), x[n:], u)

    def _terminal(self, e, qd):
        return (0.5 * self.w_pos_f * (e * e).sum(0)
                + 0.5 * self.w_vel * (qd * qd).sum(0))

    def terminal(self, x):
        n = self.model.num_vel
        return self._terminal(self._err(x[:n]), x[n:])

    def _expand(self, x, w_pos):
        """-> (e, lx, lxx) at the EE error e."""
        n = self.model.num_vel
        q, qd = x[:n], x[n:]
        e, J = self._err_jac(q)
        JTe = (J * e[:, None]).sum(0)                          # (n, B...)
        JTJ = torch.einsum("ki...,kj...->ij...", J, J)
        lx = torch.cat([w_pos * JTe, self.w_vel * qd], dim=0)
        eye = torch.eye(n, dtype=x.dtype, device=x.device).reshape(
            (n, n) + (1,) * (x.ndim - 1)).expand_as(JTJ)
        z = torch.zeros_like(JTJ)
        lxx = torch.cat([torch.cat([w_pos * JTJ, z], dim=1),
                         torch.cat([z, self.w_vel * eye], dim=1)], dim=0)
        return e, lx, lxx

    def stage_expansion(self, x, u, t):
        """The dense Gauss-Newton form -> (l, lx (2n,B...), lu (n,B...),
        lxx (2n,2n,B...), luu (n,n,B...), lux (n,2n,B...)): one pose and
        one Jacobian call."""
        n = self.model.num_vel
        e, lx, lxx = self._expand(x, self.w_pos)
        eye = torch.eye(n, dtype=x.dtype, device=x.device).reshape(
            (n, n) + (1,) * (x.ndim - 1))
        luu = (self.w_u * eye).expand((n, n) + x.shape[1:])
        lux = torch.zeros((), dtype=x.dtype, device=x.device).expand(
            (n, 2 * n) + x.shape[1:])
        return (self._stage(e, x[n:], u), lx, self.w_u * u, lxx, luu, lux)

    def terminal_expansion(self, x):
        """-> (l, lx (2n,B...), lxx (2n,2n,B...)): one pose and one
        Jacobian call."""
        e, lx, lxx = self._expand(x, self.w_pos_f)
        return self._terminal(e, x[self.model.num_vel:]), lx, lxx

    def gn_stage_factor(self, x, u, t):
        """(Jw (3, n, B...), lx (2n, B...), lu (n, B...)): the stage curvature
        is lxx = blkdiag(Jw^T Jw, w_vel*I), luu = w_u*I, lux = 0, so the
        solver hands the rank-3 factor to the Riccati sweep instead of dense
        (2n, 2n) blocks."""
        n = self.model.num_vel
        q, qd = x[:n], x[n:]
        e, J = self._err_jac(q)
        JTe = (J * e[:, None]).sum(0)
        lx = torch.cat([self.w_pos * JTe, self.w_vel * qd], dim=0)
        lu = self.w_u * u
        Jw = torch.sqrt(torch.tensor(self.w_pos, dtype=x.dtype)) * J
        return Jw, lx, lu

    # -- line-search cost: position-only FK (no atan2), the form the CUDA
    #    line-search kernel evaluates per lane ------------------------------
    def _sq(self, x):
        n = self.model.num_vel
        xyz = _eepose.eexyz(self.model, x[:n])
        k = 3 * self.ee_index
        d = xyz[k:k + 3] - _col(self.goal_xyz, x)
        qd = x[n:]
        return (d * d).sum(0), (qd * qd).sum(0)

    def ls_stage(self, x, u):
        e2, v2 = self._sq(x)
        return 0.5 * (self.w_pos * e2 + self.w_vel * v2
                      + self.w_u * (u * u).sum(0))

    def ls_terminal(self, x):
        e2, v2 = self._sq(x)
        return 0.5 * (self.w_pos_f * e2 + self.w_vel * v2)

    @functools.cached_property
    def kernel_weights(self):
        """The line-search kernel's cost: kind "ee", constants
        goal (3) | w_pos | w_pos_f | w_vel | w_u, on the EE ``ee_index``;
        None for a per-problem goal."""
        if not self.time_invariant:
            return None
        g = [float(v) for v in self.goal_xyz.detach().cpu().double()]
        return dict(kind="ee",
                    values=tuple(g + [float(self.w_pos), float(self.w_pos_f),
                                      float(self.w_vel), float(self.w_u)]),
                    ee_index=int(self.ee_index))
