"""Analytical inverse-dynamics gradient dc/d(q, qd) on batch-trailing tensors.

Five stages, as in ``gridcodegenerator_tpu/ops/id_grad.py``: temporaries,
forward dv/du waves, da/du, df/du, and the backward df accumulation with
extraction onto the joint axes. Each joint carries dense ``(6, nv, B...)``
column blocks; sparsity shows up as structural zeros.

A floating base contributes a 6-wide column block in the body-frame tangent
chart (``dX = -crm(e_j) X`` for each of its six directions j): dv/dq = 0
at the base, its six a0 = X g terms ``mx_j(X g)`` as da/dq, and its six
torque rows taken whole. The q-columns of a floating robot are therefore
num_vel wide, not num_pos.
"""

from __future__ import annotations

from typing import List

import torch

from ..models.model import RobotModel
from .common import DEFAULT_GRAVITY, gravity_accel, vel_layout
from .rnea import rnea_bpass, rnea_fpass
from .spatial import (Mcols, Mv, XTcols, XTv, Xcols, Xv, cross_fv, crfS_f,
                      mxS)
from .xforms import all_xmats


def _col_add(D, col, val):
    """D with ``val`` (6, B...) added to column ``col``."""
    D = D.clone()
    D[:, col] = D[:, col] + val
    return D


def id_grad_inner(model: RobotModel, Xs: List[torch.Tensor], qd: torch.Tensor,
                  v, a, f, gravity: float = DEFAULT_GRAVITY,
                  return_stages: bool = False):
    """dc_du (nv, 2*nv, B...) from RNEA intermediates (accumulated f).
    With ``return_stages`` also the stages' (n, 6, nv, B...) columns
    (``utils/debug.py:id_grad_stages``): dv/du, da/du, df/du before and
    after the backward accumulation, and dc_du."""
    n, nv = model.n, model.num_vel
    vl = vel_layout(model)
    bshape = qd.shape[1:]
    dtype, device = qd.dtype, qd.device
    g = gravity_accel(gravity, qd)

    def zeros():
        return torch.zeros((6, nv) + bshape, dtype=dtype, device=device)

    # ---- stage 1: temporaries --------------------------------------------
    Iv = [Mv(model.Imat[i], v[i]) for i in range(n)]
    MxXv, MxXa, Mxv, FxvI = [], [], [], []
    for i in range(n):
        p = model.parent[i]
        Xa_p = Xv(Xs[i], a[p] if p != -1 else g.expand_as(v[i]))
        if vl[i][1] == 1:
            s = model.S_ind[i]
            MxXv.append(mxS(s, Xv(Xs[i], v[p])) if p != -1 else None)
            MxXa.append(mxS(s, Xa_p))
            Mxv.append(mxS(s, v[i]))
        else:   # the floating base: six tangent directions; a0 = X g
            MxXv.append(None)
            MxXa.append(torch.stack([mxS(j, Xa_p) for j in range(6)], dim=1))
            Mxv.append(None)
        # crf(v) @ I as a (6, 6, B...) operator: columns cross_fv(v, I[:, k])
        Icols = [model.Imat[i][:, k].reshape((6,) + (1,) * len(bshape))
                 .expand_as(v[i]) for k in range(6)]
        FxvI.append(torch.stack([cross_fv(v[i], col) for col in Icols], dim=1))

    def put6(D, off, val6):
        """D with the (6, 6, B...) block ``val6`` added to columns off..+5."""
        D = D.clone()
        D[:, off:off + 6] = D[:, off:off + 6] + val6
        return D

    # ---- stage 2: forward dv/du waves ------------------------------------
    Dvq: List[torch.Tensor] = [None] * n
    Dvqd: List[torch.Tensor] = [None] * n
    for lvl in model.bfs_levels:
        for i in lvl:
            p = model.parent[i]
            off, d = vl[i]
            if p == -1:
                Dq, Dd = zeros(), zeros()
            else:
                Dq = _col_add(Xcols(Xs[i], Dvq[p]), off, MxXv[i])
                Dd = Xcols(Xs[i], Dvqd[p])
            Dvq[i] = Dq
            if d == 1:
                Dd = Dd.clone()
                Dd[model.S_ind[i], off] = Dd[model.S_ind[i], off] + 1.0
                Dvqd[i] = Dd
            else:   # dv0/dqd = S = I6
                Dvqd[i] = put6(Dd, off, torch.eye(
                    6, dtype=dtype, device=device).reshape(
                        (6, 6) + (1,) * len(bshape)))

    # ---- stage 3: da/du --------------------------------------------------
    Daq: List[torch.Tensor] = [None] * n
    Dad: List[torch.Tensor] = [None] * n
    for lvl in model.bfs_levels:
        for i in lvl:
            off, d = vl[i]
            if d == 6:   # the base: a0 = X(q) g (+ qdd): only the MxXa terms
                Daq[i] = put6(zeros(), off, MxXa[i])
                Dad[i] = zeros()
                continue
            s = model.S_ind[i]
            qdi = qd[off][None]
            Aq = _col_add(mxS(s, Dvq[i], qdi), off, MxXa[i])
            Ad = _col_add(mxS(s, Dvqd[i], qdi), off, Mxv[i])
            p = model.parent[i]
            if p != -1:
                Aq = Aq + Xcols(Xs[i], Daq[p])
                Ad = Ad + Xcols(Xs[i], Dad[p])
            Daq[i], Dad[i] = Aq, Ad

    # ---- stage 4: df/du = crf(dv/du) Iv + I da/du + (crf(v) I) dv/du -----
    Dfq: List[torch.Tensor] = [None] * n
    Dfd: List[torch.Tensor] = [None] * n
    for i in range(n):
        Iv_b = Iv[i][:, None].expand_as(Dvq[i])
        Dfq[i] = (cross_fv(Dvq[i], Iv_b) + Mcols(model.Imat[i], Daq[i])
                  + Xcols(FxvI[i], Dvq[i]))
        Dfd[i] = (cross_fv(Dvqd[i], Iv_b) + Mcols(model.Imat[i], Dad[i])
                  + Xcols(FxvI[i], Dvqd[i]))

    # ---- stage 5: backward df accumulation + extraction ------------------
    Dfq_body, Dfd_body = list(Dfq), list(Dfd)   # before the accumulation
    for lvl in reversed(model.bfs_levels):
        for i in lvl:
            p = model.parent[i]
            if p == -1:
                continue
            corr = XTv(Xs[i], crfS_f(model.S_ind[i], f[i]))
            Dfq[p] = _col_add(Dfq[p] + XTcols(Xs[i], Dfq[i]), vl[i][0], corr)
            Dfd[p] = Dfd[p] + XTcols(Xs[i], Dfd[i])

    dcq_rows, dcd_rows = [], []
    for i, (off, d) in enumerate(vl):
        if d == 6:   # the base's torque rows come out whole
            dcq_rows.append(Dfq[i])
            dcd_rows.append(Dfd[i])
        else:
            dcq_rows.append(Dfq[i][model.S_ind[i]][None])
            row = Dfd[i][model.S_ind[i]].clone()
            row[off] = row[off] + model.damping[i]
            dcd_rows.append(row[None])
    dcq = torch.cat(dcq_rows)
    dcd = torch.cat(dcd_rows)
    dc_du = torch.cat([dcq, dcd], dim=1)
    if return_stages:
        return dc_du, {
            "dv_dq": torch.stack(Dvq), "dv_dqd": torch.stack(Dvqd),
            "da_dq": torch.stack(Daq), "da_dqd": torch.stack(Dad),
            "df_dq_body": torch.stack(Dfq_body),
            "df_dqd_body": torch.stack(Dfd_body),
            "df_dq": torch.stack(Dfq), "df_dqd": torch.stack(Dfd),
            "dc_du": dc_du}
    return dc_du


def id_grad(model: RobotModel, q, qd, qdd=None,
            gravity: float = DEFAULT_GRAVITY) -> torch.Tensor:
    """dc_du = [dc/dq | dc/dqd]: (nv, 2*nv, B...)."""
    Xs = all_xmats(model, q)
    v, a, f = rnea_fpass(model, Xs, qd, qdd, gravity)
    _, f_acc = rnea_bpass(model, Xs, qd, f)
    return id_grad_inner(model, Xs, qd, v, a, f_acc, gravity)
