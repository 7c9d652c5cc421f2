"""Articulated-body algorithm forward dynamics on batch-trailing tensors.

Three passes over the BFS waves: velocities and bias terms, the backward
articulated-inertia reduction, and forward acceleration recovery. Joint
damping enters as a bias torque, so ABA is the exact inverse of RNEA.
Fixed base, 1-dof joints.
"""

from __future__ import annotations

from typing import List

import torch

from ..models.model import RobotModel
from .common import DEFAULT_GRAVITY, check_fixed_base, e_vec, gravity_accel
from .spatial import Mv, XTMX, XTv, Xv, cross_fv, cross_mv, dot6, outer6
from .xforms import all_xmats


def aba(model: RobotModel, q, qd, u, gravity: float = DEFAULT_GRAVITY,
        return_stages: bool = False):
    """qdd = ABA(q, qd, u): (n, B...). With ``return_stages`` also the
    passes' intermediates (``utils/debug.py:aba_stages``): v, cbias, the
    accumulated pA, U, Dinv, uu, a and qdd, stacked per joint."""
    check_fixed_base(model)
    n = model.n
    Xs = all_xmats(model, q)
    bshape = qd.shape[1:]
    g = gravity_accel(gravity, qd)

    v: List[torch.Tensor] = [None] * n
    cb: List[torch.Tensor] = [None] * n
    pA: List[torch.Tensor] = [None] * n
    IA = [model.Imat[i].reshape((6, 6) + (1,) * len(bshape)).expand(
        (6, 6) + bshape) for i in range(n)]
    for lvl in model.bfs_levels:
        for i in lvl:
            vJ = e_vec(model.S_ind[i], qd[i])
            p = model.parent[i]
            v[i] = vJ if p == -1 else Xv(Xs[i], v[p]) + vJ
            cb[i] = cross_mv(v[i], vJ)
            pA[i] = cross_fv(v[i], Mv(model.Imat[i], v[i]))

    U: List[torch.Tensor] = [None] * n
    Dinv: List[torch.Tensor] = [None] * n
    uu: List[torch.Tensor] = [None] * n
    for lvl in reversed(model.bfs_levels):
        for i in lvl:
            p = model.parent[i]
            s = model.S_ind[i]
            Ui = IA[i][:, s]
            Dinv_i = 1.0 / Ui[s]
            uu_i = (u[i] - model.damping[i] * qd[i]) - pA[i][s]
            U[i], Dinv[i], uu[i] = Ui, Dinv_i, uu_i
            if p != -1:
                Ia = IA[i] - outer6(Ui * Dinv_i, Ui)
                pa = pA[i] + Xv(Ia, cb[i]) + Ui * (Dinv_i * uu_i)
                IA[p] = IA[p] + XTMX(Xs[i], Ia)
                pA[p] = pA[p] + XTv(Xs[i], pa)

    a: List[torch.Tensor] = [None] * n
    qdd: List[torch.Tensor] = [None] * n
    for lvl in model.bfs_levels:
        for i in lvl:
            p = model.parent[i]
            a_p = Xv(Xs[i], g.expand_as(cb[i]) if p == -1 else a[p]) + cb[i]
            qdd[i] = Dinv[i] * (uu[i] - dot6(U[i], a_p))
            a[i] = a_p + e_vec(model.S_ind[i], qdd[i])
    out = torch.stack(qdd)
    if return_stages:
        return out, {"v": torch.stack(v), "cbias": torch.stack(cb),
                     "pA": torch.stack(pA), "U": torch.stack(U),
                     "Dinv": torch.stack(Dinv), "uu": torch.stack(uu),
                     "a": torch.stack(a), "qdd": out}
    return out
