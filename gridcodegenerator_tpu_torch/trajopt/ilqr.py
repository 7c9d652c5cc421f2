"""Batched iLQR and DDP on the port's kernels.

The counterpart of ``gridcodegenerator_tpu/trajopt/ilqr.py:make_ilqr``.
Every tensor carries a trailing batch axis B of independent problems. One
solve is an open-loop rollout, then ``iters`` iterations of

1. ``linearize``: one ``fd_du`` over all N*B knots, knot-major lanes
   (lane = t*B + b), assembled into the discrete A, B blocks;
2. ``second_order`` (``use_second_order`` only): one ``fdsva_so`` over the
   same N*B lanes, (4, n, n, n, N*B);
3. ``backward``: the Riccati sweep. A time-invariant Gauss-Newton-factored
   cost (``EEReachCost`` with a shared goal) runs the factored sweep
   kernel; any other cost runs the dense sweep kernel, on one curvature
   block where the curvature is stationary (``QuadCost``), else on
   per-knot curvature stacks. A time-invariant cost is expanded in one call
   over the N*B folded lanes, any other knot by knot (``stage_expansion(x,
   u, t)``). With ``use_second_order`` it is the exact DDP sweep, plain
   torch on every device (the JAX package runs it in XLA too): each knot
   contracts V'_x with its lane slice [t*B, (t+1)*B) of the flat
   second-order tensors. With ``parallel_riccati`` (first order) it is
   ``trajopt/priccati.py``'s associative suffix scan in plain torch on the
   dense stacks, then each knot's gain solve; ``use_second_order``
   ignores the flag, as the JAX solver does. With ``knot_axis`` (first
   order, a time-invariant cost, the mesh passed to ``make_ilqr``) the
   knots are split over that mesh axis: each rank linearizes its N/D
   knots (fd_du over N/D*B lanes), expands the cost on them and runs
   ``parallel/knot_riccati.py``'s reduce, and the gains are gathered for
   the forward pass, which every rank of the axis runs whole;
4. ``forward``: one line-search rollout over every step size, then the
   per-problem argmin and accept step. A cost with ``kernel_weights`` is
   summed inside the sweep; any other runs the line search without a cost
   and is summed over its rollouts by ``total_cost``, knot by knot where
   it is not time-invariant.

The cost is any ``CostModel`` (``trajopt/cost.py``), as in the JAX solver.
A per-problem goal of more than one problem with more than one step size
raises: the JAX solver cannot run it either (its line search widens the
lanes to n_alpha*B, and the (., B) goal does not broadcast against them).

``ILQRConfig.use_kernels``: None runs the CUDA kernels iff the tensors are
on CUDA (the wrappers dispatch on device); True insists on CUDA tensors;
False runs the plain PyTorch versions on any device, the EE cost's pose and
Jacobian too (``EEReachCost.ee_fns``).

Integrator: semi-implicit Euler — qd' = qd + dt*qdd, q' = q + dt*qd'.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.model import RobotModel
from ..ops.common import DEFAULT_GRAVITY, check_fixed_base, eye_b
from ..ops.cuda import kernels as _k
from ..ops.cuda import sweeps as _s
from ..ops.linalg import gj_inverse
from ..ops.spatial import bmm, bmv
from ..parallel.collectives import all_gather
from ..parallel.knot_riccati import local_knot_gains
from .priccati import suffix_value_functions


# the JAX solver's refusal (``gridcodegenerator_tpu/trajopt/ilqr.py:160-169``)
FIXED_BASE_ONLY = (
    "make_ilqr requires a fixed-base model: the solver's state is [q; qd] "
    "with num_pos == num_vel. Floating-base trajopt needs "
    "quaternion-manifold integration")


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    N: int = 64                   # knot points (horizon)
    dt: float = 0.01
    iters: int = 10
    reg: float = 1e-6             # Quu Levenberg regularization
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    gravity: float = DEFAULT_GRAVITY
    u_min: object = None          # control box bounds: scalar, per-dof (n,)
    u_max: object = None          # array, or None; both None = the robot's
                                  # effort limits (no clamp if it has none)
    use_kernels: Optional[bool] = None
    use_second_order: bool = False   # exact DDP terms from FDSVA-SO
    parallel_riccati: bool = False   # first order: the associative scan
    # the knot-sharded backward: the mesh axis the knots split over, and
    # its size D (the axis is used where D > 1; make_ilqr takes the mesh)
    knot_axis: Optional[str] = None
    knot_axis_size: int = 1
    # a part of the JAX solver the port leaves out; setting it raises
    ls_two_stage: bool = False


class ILQRResult(NamedTuple):
    X: torch.Tensor           # (N+1, 2n, B) optimized state trajectory
    U: torch.Tensor           # (N, n, B) optimized controls
    cost: torch.Tensor        # (B,) final cost
    cost_trace: torch.Tensor  # (iters+1, B)
    K: torch.Tensor           # (N, n, 2n, B) final feedback gains
    k: torch.Tensor           # (N, n, B) final feedforward


def resolve_control_bounds(model: RobotModel, cfg: ILQRConfig):
    """Per-dof (u_min, u_max) as (n, 1) tensors on the model's device: the
    config's if set, else ±the robot's effort limits; None where unbounded.
    As in the JAX solver, a scalar bound stays exact (in the model's dtype)
    and array bounds and effort limits are rounded through float32."""
    n = model.num_vel

    def col(b):
        if b is None:
            return None
        if np.isscalar(b):
            return torch.full((n, 1), float(b), dtype=model.dtype,
                              device=model.device)
        arr = np.broadcast_to(np.asarray(b, np.float32), (n,)).reshape(n, 1)
        return torch.as_tensor(arr.copy(), dtype=model.dtype,
                               device=model.device)

    if cfg.u_min is not None or cfg.u_max is not None:
        return col(cfg.u_min), col(cfg.u_max)
    eff = model.effort_limit.detach().double().cpu().numpy()
    if not np.isfinite(eff).any():
        return None, None
    return col(-eff), col(eff)


def dynamics_step(model: RobotModel, x, u, dt, gravity=DEFAULT_GRAVITY):
    """Semi-implicit Euler step on lane-major x = [q; qd] (2n, B) under u
    (n, B). The counterpart of ``gridcodegenerator_tpu/trajopt/ilqr.py:
    dynamics_step``: qdd from the ``aba`` kernel on a CUDA tensor, from the
    plain ABA on the CPU. The state is [q; qd] with num_pos == num_vel, so
    a floating base raises, as in ``make_ilqr``."""
    check_fixed_base(model, FIXED_BASE_ONLY)
    n = model.num_vel
    q, qd = x[:n], x[n:]
    qdd = _k.aba(model, q.contiguous(), qd.contiguous(), u.contiguous(),
                 gravity)
    qd_new = qd + dt * qdd
    return torch.cat([q + dt * qd_new, qd_new], dim=0)


def _knot_group(cfg: ILQRConfig, cost, mesh):
    """The knot axis's group where the backward is knot-sharded, else
    None; raises where the JAX solver does
    (``gridcodegenerator_tpu/trajopt/ilqr.py:329-341``) and where no mesh
    provides the axis."""
    if cfg.knot_axis is None or cfg.knot_axis_size <= 1:
        return None
    if cfg.use_second_order or cfg.parallel_riccati:
        raise NotImplementedError(
            "knot-sharded backward is first-order and replaces "
            "parallel_riccati")
    if cfg.N % cfg.knot_axis_size != 0:
        raise ValueError(f"knot count {cfg.N} must be divisible by the knot "
                         f"axis size {cfg.knot_axis_size}")
    if not getattr(cost, "time_invariant", False):
        raise NotImplementedError(
            "knot-sharded backward needs a time-invariant cost (local "
            "chunks evaluate stage_expansion at t=0)")
    if mesh is None or cfg.knot_axis not in mesh.axis_names:
        raise ValueError(f"the knot axis '{cfg.knot_axis}' needs a mesh "
                         f"that has it: make_ilqr(..., mesh=...)")
    group = mesh.axis(cfg.knot_axis)
    if group.size != cfg.knot_axis_size:
        raise ValueError(f"knot_axis_size {cfg.knot_axis_size}, but the "
                         f"mesh's '{cfg.knot_axis}' has {group.size} ranks")
    return group


def make_ilqr(model: RobotModel, cost, cfg: ILQRConfig,
              expose_parts: bool = False, mesh=None):
    """Build a batched solver: solve(x0 (2n,B), U0 (N,n,B)) -> ILQRResult.

    ``cost`` is a ``CostModel``: ``stage``/``terminal`` and their
    expansions (or, time-invariant, ``gn_stage_factor`` for first order).
    ``expose_parts=True`` also returns the phase closures ({rollout,
    linearize, second_order, backward, forward, total_cost}) so each phase
    can be timed on its own (with ``knot_axis``: {rollout, backward,
    forward, total_cost}, the backward linearizing its own knots).
    ``mesh`` (``parallel/mesh.py``) provides ``cfg.knot_axis``: every rank
    of that axis calls ``solve`` on the same inputs, as the body of the
    JAX package's ``shard_map`` does.
    """
    check_fixed_base(model, FIXED_BASE_ONLY)
    if cfg.ls_two_stage:
        raise NotImplementedError("ILQRConfig.ls_two_stage is not ported")
    knot_group = _knot_group(cfg, cost, mesh)
    fold_t = getattr(cost, "time_invariant", False)
    stationary = getattr(cost, "stationary_curvature", False)
    # the associative scan replaces the sweep kernels (first order only)
    scan = cfg.parallel_riccati and not cfg.use_second_order
    factored = (fold_t and not stationary and not cfg.use_second_order
                and not scan and hasattr(cost, "gn_stage_factor"))
    if not factored and not hasattr(cost, "stage_expansion"):
        raise NotImplementedError(
            "the solver needs a cost with stage_expansion (or, time-invariant "
            "and first order, gn_stage_factor)")
    n, nx = model.num_vel, 2 * model.num_vel
    N, dt, grav = cfg.N, cfg.dt, cfg.gravity
    na = len(cfg.alphas)
    if na > 1 and getattr(cost, "goal_problems", 1) > 1:
        raise NotImplementedError(
            f"a per-problem goal ({cost.goal_problems} problems) with "
            f"{na} step sizes: the JAX solver cannot run it either (its line "
            f"search widens the lanes to n_alpha*B and the (., B) goal does "
            f"not broadcast against them); use alphas=(1.0,)")
    alphas = torch.tensor(cfg.alphas, dtype=model.dtype, device=model.device)
    u_lo, u_hi = resolve_control_bounds(model, cfg)
    plain = cfg.use_kernels is False
    fd_du = _k.fd_du_plain if plain else _k.fd_du
    fdsva = _k.fdsva_so_plain if plain else _k.fdsva_so
    roll = _s.rollout_plain if plain else _s.rollout
    ls_roll = _s.linesearch_rollout_plain if plain else _s.linesearch_rollout
    ric_gn = _s.riccati_factored_plain if plain else _s.riccati_factored
    ric = _s.riccati_plain if plain else _s.riccati
    if plain and hasattr(cost, "ee_fns"):   # the EE cost's plain twins too
        cost = dataclasses.replace(cost, ee_fns=(_k.eepos_plain,
                                                 _k.deepos_plain))
    # the cost summed inside the line search, or None: summed after it
    ls_cost = cost if getattr(cost, "kernel_weights", None) is not None \
        else None

    def on_device(t):
        if cfg.use_kernels and not t.is_cuda:
            raise ValueError("use_kernels=True needs CUDA tensors")

    def fold(Z):
        """(Nk, d, B) -> (d, Nk*B), knot-major (lane = t*B + b)."""
        return Z.transpose(0, 1).reshape(Z.shape[1], -1)

    def unfold(z, nk=N):
        """(..., nk*B) -> (nk, ..., B), the inverse of :func:`fold`."""
        return z.reshape(z.shape[:-1] + (nk, -1)).movedim(-2, 0)

    def rollout(x0, U):
        on_device(x0)
        X = roll(model, x0, U, dt, grav, u_lo, u_hi)
        return torch.cat([x0[None], X], dim=0)            # (N+1, 2n, B)

    def total_cost(X, U):
        c = cost.terminal(X[N])
        if fold_t:   # one stage call over the N*B folded lanes
            return c + cost.stage(fold(X[:N]), fold(U), 0).reshape(
                N, -1).sum(0)
        for t in range(N):
            c = c + cost.stage(X[t], U[t], t)
        return c

    def linearize(Xs, U):
        """One fd_du over Nk*B knot-major lanes -> A (Nk,2n,2n,B),
        B (Nk,2n,n,B), for the Nk knots of ``Xs`` (the horizon, or one
        rank's chunk)."""
        on_device(Xs)
        Nk, B = Xs.shape[0], Xs.shape[-1]
        df_du, _, Mi = fd_du(model, fold(Xs[:, :n]), fold(Xs[:, n:]),
                             fold(U), grav)
        I_n = torch.eye(n, dtype=Xs.dtype, device=Xs.device)[:, :, None]
        A21 = dt * df_du[:, :n]                  # dqd'/dq
        A22 = I_n + dt * df_du[:, n:]            # dqd'/dqd
        A11 = I_n + dt * A21                     # dq'/dq
        A12 = dt * A22                           # dq'/dqd
        Bqd = dt * Mi                            # dqd'/du
        Bq = dt * Bqd                            # dq'/du
        Amat = torch.cat([torch.cat([A11, A12], dim=1),
                          torch.cat([A21, A22], dim=1)], dim=0)
        Bmat = torch.cat([Bq, Bqd], dim=0)
        Amat = Amat.reshape(nx, nx, Nk, B).permute(2, 0, 1, 3).contiguous()
        Bmat = Bmat.reshape(nx, n, Nk, B).permute(2, 0, 1, 3).contiguous()
        return Amat, Bmat

    def second_order(X, U):
        """One fdsva_so over the N*B knot-major lanes -> (4,n,n,n,N*B)."""
        on_device(X)
        return fdsva(model, fold(X[:N, :n]), fold(X[:N, n:]), fold(U), grav)

    def expansions(X, U, one_block):
        """The stage expansion's (lx (N,nx,B), lu (N,n,B), lxx, luu, lux):
        one call over the folded lanes for a time-invariant cost, else one
        a knot. The curvature is knot 0's block ((nx,nx,B), ...) with
        ``one_block``, else the per-knot stacks ((N,nx,nx,B), ...)."""
        B = X.shape[-1]
        if fold_t:
            _, lxf, luf, lxxf, luuf, luxf = cost.stage_expansion(
                fold(X[:N]), fold(U), 0)
            curv = ((c[..., :B] for c in (lxxf, luuf, luxf)) if one_block
                    else map(unfold, (lxxf, luuf, luxf)))
            return (unfold(lxf), unfold(luf), *curv)
        exps = [cost.stage_expansion(X[t], U[t], t) for t in range(N)]
        shapes = ((nx, nx, B), (n, n, B), (n, nx, B))
        if one_block:
            curv = (c.expand(s) for c, s in zip(exps[0][3:], shapes))
        else:
            curv = (torch.stack([e[3 + k].expand(s) for e in exps])
                    for k, s in enumerate(shapes))
        return (torch.stack([e[1] for e in exps]),
                torch.stack([e[2] for e in exps]), *curv)

    def ddp_backward(X, U, Amat, Bmat, so_flat):
        """The exact-Hessian sweep: the knot step with V'_x contracted with
        the second-order tensors of the semi-implicit Euler map."""
        B = X.shape[-1]
        _, Vx, Vxx = cost.terminal_expansion(X[N])
        lx, lu, lxx, luu, lux = expansions(X, U, one_block=False)
        ks, Ks = [None] * N, [None] * N
        for t in range(N - 1, -1, -1):
            d2q, d2qd, cr, dMi = (so_flat[c, ..., t * B:(t + 1) * B]
                                  for c in range(4))
            w = dt * Vx[n:] + dt * dt * Vx[:n]              # (n, B)
            hqq, hdd, hcr, hMq = (torch.einsum("i...,ijk...->jk...", w, s)
                                  for s in (d2q, d2qd, cr, dMi))
            dQxx = torch.cat([torch.cat([hqq, hcr.transpose(0, 1)], dim=1),
                              torch.cat([hcr, hdd], dim=1)], dim=0)
            dQux = torch.cat([hMq, torch.zeros_like(hMq)], dim=1)
            ks[t], Ks[t], Vx, Vxx = _s.riccati_knot(
                Amat[t], Bmat[t], Vx, Vxx, lx[t], lu[t], lxx[t], luu[t],
                lux[t], cfg.reg, dQxx, dQux)
        return torch.stack(ks), torch.stack(Ks)

    def scan_backward(X, U, Amat, Bmat):
        """The associative suffix scan (``reg=0``: the exact value
        recursion, as the sequential sweep propagates it), then every
        knot's gains, with ``cfg.reg`` in the Quu solves alone."""
        _, Vx0, Vxx0 = cost.terminal_expansion(X[N])
        lx, lu, lxx, luu, lux = expansions(X, U, one_block=False)
        Vx, Vxx = suffix_value_functions(Amat, Bmat, lx, lu, lxx, luu, lux,
                                         Vx0, Vxx0, reg=0.0)

        def last(t):         # the knot axis to the last batch axis
            return t.movedim(0, -1)
        A, Bm, Vx, Vxx = last(Amat), last(Bmat), last(Vx[1:]), last(Vxx[1:])
        Bt = Bm.transpose(0, 1)
        Qu = last(lu) + bmv(Bt, Vx)
        BtV = bmm(Bt, Vxx)
        Qux = last(lux) + bmm(BtV, A)
        Quu = last(luu) + bmm(BtV, Bm)
        Quu_inv = gj_inverse(Quu + cfg.reg * eye_b(n, Quu))
        # knot-major and contiguous, as the line-search kernel takes them
        return ((-bmv(Quu_inv, Qu)).movedim(-1, 0).contiguous(),
                (-bmm(Quu_inv, Qux)).movedim(-1, 0).contiguous())

    def knot_sharded_backward(X, U):
        """This rank's N/D knots linearized and expanded, the reduce over
        the knot axis, and every rank's gains gathered (JAX
        ``backward_knot_sharded``)."""
        on_device(X)
        D, B = knot_group.size, X.shape[-1]
        nl = N // D
        t0 = knot_group.index * nl
        X_loc, U_loc = X[t0:t0 + nl], U[t0:t0 + nl]
        Amat, Bmat = linearize(X_loc, U_loc)
        _, Vx0, Vxx0 = cost.terminal_expansion(X[N])
        _, lxf, luf, lxxf, luuf, luxf = cost.stage_expansion(
            fold(X_loc), fold(U_loc), 0)
        lanes = nl * B
        lxx, luu, lux = (unfold(c.expand(c.shape[:2] + (lanes,)), nl)
                         for c in (lxxf, luuf, luxf))
        ks, Ks = local_knot_gains(knot_group, D, cfg.reg, Amat, Bmat,
                                  unfold(lxf, nl), unfold(luf, nl), lxx,
                                  luu, lux, Vx0, Vxx0)
        return all_gather(ks, knot_group, 0), all_gather(Ks, knot_group, 0)

    def backward(X, U, Amat, Bmat, so_flat=None):
        """The Riccati sweep (see the module docstring for its forms)."""
        on_device(X)
        if cfg.use_second_order:
            return ddp_backward(X, U, Amat, Bmat, so_flat)
        if scan:
            return scan_backward(X, U, Amat, Bmat)
        _, Vx0, Vxx0 = cost.terminal_expansion(X[N])
        if factored:
            # the (r, n) GN factor and flat lx/lu go in the knot-major layout
            Jw, lxf, luf = cost.gn_stage_factor(fold(X[:N]), fold(U), 0)
            return ric_gn(Amat, Bmat, lxf.contiguous(), luf.contiguous(),
                          Jw.contiguous(), Vx0.contiguous(),
                          Vxx0.contiguous(), cfg.reg, *cost.gn_factor_diags)
        # a stationary curvature: one block for every knot; else the stacks
        ex = expansions(X, U, one_block=stationary)
        return ric(Amat, Bmat, *(e.contiguous() for e in ex),
                   Vx0.contiguous(), Vxx0.contiguous(), cfg.reg)

    def forward(X, U, ks, Ks):
        """Line search: every step size in one sweep, then the argmin."""
        on_device(X)
        B = X.shape[-1]
        alpha_rows = alphas[:, None].repeat(1, B)
        Xs, Uw, cw = ls_roll(model, X[0], U, X[:N], ks, Ks, alpha_rows, dt,
                             grav, u_lo, u_hi, ls_cost)
        if cw is None:   # the cost over the rollouts, lanes [a0*B | a1*B ..]
            cw = total_cost(torch.cat([X[0].repeat(1, na)[None], Xs]), Uw)
        cw = cw.reshape(na, B)
        best = torch.argmin(cw, dim=0)                     # (B,)
        idx = best[None, None, None, :]
        Xb = torch.gather(Xs.reshape(N, nx, na, B), 2,
                          idx.expand(N, nx, 1, B))[:, :, 0]
        Ub = torch.gather(Uw.reshape(N, n, na, B), 2,
                          idx.expand(N, n, 1, B))[:, :, 0]
        return (torch.cat([X[0][None], Xb], dim=0), Ub,
                cw.min(dim=0).values)

    def solve(x0, U0):
        x0 = x0.to(model.dtype).contiguous()
        U = U0.to(model.dtype).contiguous()
        X = rollout(x0, U)
        c = total_cost(X, U)
        trace = [c]
        ks = Ks = None
        for _ in range(cfg.iters):
            if knot_group is not None:
                ks, Ks = knot_sharded_backward(X, U)
            else:
                Amat, Bmat = linearize(X[:N], U)
                so_flat = (second_order(X, U) if cfg.use_second_order
                           else None)
                ks, Ks = backward(X, U, Amat, Bmat, so_flat)
                # freed before the next iteration's: 4 n^3 N B values
                del so_flat
            Xn, Un, cn = forward(X, U, ks, Ks)
            acc = cn < c
            X = torch.where(acc[None, None], Xn, X)
            U = torch.where(acc[None, None], Un, U)
            c = torch.where(acc, cn, c)
            trace.append(c)
        return ILQRResult(X, U, c, torch.stack(trace), Ks, ks)

    if expose_parts and knot_group is not None:
        return solve, {"rollout": rollout, "backward": knot_sharded_backward,
                       "forward": forward, "total_cost": total_cost}
    if expose_parts:
        return solve, {"rollout": rollout, "linearize": linearize,
                       "second_order": second_order, "backward": backward,
                       "forward": forward, "total_cost": total_cost}
    return solve
