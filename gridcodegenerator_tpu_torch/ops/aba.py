"""Articulated-body algorithm forward dynamics on batch-trailing tensors.

Three passes over the BFS waves: velocities and bias terms, the backward
articulated-inertia reduction, and forward acceleration recovery. Joint
damping enters as a bias torque, so ABA is the exact inverse of RNEA. A
floating joint's 6x6 block (S = I6) is inverted by the pivot-free
Gauss-Jordan of ``minv._inv66``.
"""

from __future__ import annotations

from typing import List

import torch

from ..models.model import RobotModel
from .common import DEFAULT_GRAVITY, e_vec, gravity_accel, vel_layout
from .minv import _inv66
from .spatial import (Mv, XTMX, XTv, Xv, bmm, bmv, cross_fv, cross_mv, dot6,
                      outer6)
from .xforms import all_xmats


def aba(model: RobotModel, q, qd, u, gravity: float = DEFAULT_GRAVITY,
        return_stages: bool = False):
    """qdd = ABA(q, qd, u): (nv, B...). With ``return_stages`` (fixed
    base: a floating joint's U, Dinv and uu are 6 wide and do not stack)
    also the passes' intermediates (``utils/debug.py:aba_stages``): v,
    cbias, the accumulated pA, U, Dinv, uu, a and qdd, stacked per
    joint."""
    n = model.n
    vl = vel_layout(model)
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
            off, d = vl[i]
            vJ = (e_vec(model.S_ind[i], qd[off]) if d == 1
                  else qd[off:off + 6])
            p = model.parent[i]
            v[i] = vJ if p == -1 else Xv(Xs[i], v[p]) + vJ
            cb[i] = cross_mv(v[i], vJ)
            pA[i] = cross_fv(v[i], Mv(model.Imat[i], v[i]))

    U: List[torch.Tensor] = [None] * n
    Dinv: List[torch.Tensor] = [None] * n
    uu: List[torch.Tensor] = [None] * n
    for lvl in reversed(model.bfs_levels):
        for i in lvl:
            off, d = vl[i]
            p = model.parent[i]
            if d == 1:
                s = model.S_ind[i]
                Ui = IA[i][:, s]
                Dinv_i = 1.0 / Ui[s]
                uu_i = (u[off] - model.damping[i] * qd[off]) - pA[i][s]
            else:             # the floating joint: S = I6, U = IA, D = IA
                Ui = IA[i]
                Dinv_i = _inv66(Ui)
                uu_i = u[off:off + 6] - pA[i]
            U[i], Dinv[i], uu[i] = Ui, Dinv_i, uu_i
            if p != -1:
                if d == 1:
                    Ia = IA[i] - outer6(Ui * Dinv_i, Ui)
                    pa = pA[i] + Xv(Ia, cb[i]) + Ui * (Dinv_i * uu_i)
                else:
                    UD = bmm(Ui, Dinv_i)
                    Ia = IA[i] - bmm(UD, Ui.transpose(0, 1))
                    pa = pA[i] + Xv(Ia, cb[i]) + bmv(UD, uu_i)
                IA[p] = IA[p] + XTMX(Xs[i], Ia)
                pA[p] = pA[p] + XTv(Xs[i], pa)

    a: List[torch.Tensor] = [None] * n
    qdd: List[torch.Tensor] = [None] * n
    for lvl in model.bfs_levels:
        for i in lvl:
            off, d = vl[i]
            p = model.parent[i]
            a_p = Xv(Xs[i], g.expand_as(cb[i]) if p == -1 else a[p]) + cb[i]
            if d == 1:
                qdd_i = Dinv[i] * (uu[i] - dot6(U[i], a_p))
                a[i] = a_p + e_vec(model.S_ind[i], qdd_i)
                qdd[i] = qdd_i[None]
            else:
                qdd[i] = bmv(Dinv[i], uu[i] - bmv(U[i].transpose(0, 1), a_p))
                a[i] = a_p + qdd[i]
    out = torch.cat(qdd)
    if return_stages:
        return out, {"v": torch.stack(v), "cbias": torch.stack(cb),
                     "pA": torch.stack(pA), "U": torch.stack(U),
                     "Dinv": torch.stack(Dinv), "uu": torch.stack(uu),
                     "a": torch.stack(a), "qdd": out}
    return out
