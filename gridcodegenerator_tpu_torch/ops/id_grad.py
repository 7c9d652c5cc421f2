"""Analytical inverse-dynamics gradient dc/d(q, qd) on batch-trailing tensors.

Five stages, as in ``gridcodegenerator_tpu/ops/id_grad.py``: temporaries,
forward dv/du waves, da/du, df/du, and the backward df accumulation with
extraction onto the joint axes. Each joint carries dense ``(6, nv, B...)``
column blocks; sparsity shows up as structural zeros. Fixed base, 1-dof
joints.
"""

from __future__ import annotations

from typing import List

import torch

from ..models.model import RobotModel
from .common import DEFAULT_GRAVITY, check_fixed_base, gravity_accel
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
    check_fixed_base(model)
    n, nv = model.n, model.num_vel
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
        s = model.S_ind[i]
        Xa_p = Xv(Xs[i], a[p] if p != -1 else g.expand_as(v[i]))
        MxXv.append(mxS(s, Xv(Xs[i], v[p])) if p != -1 else None)
        MxXa.append(mxS(s, Xa_p))
        Mxv.append(mxS(s, v[i]))
        # crf(v) @ I as a (6, 6, B...) operator: columns cross_fv(v, I[:, k])
        Icols = [model.Imat[i][:, k].reshape((6,) + (1,) * len(bshape))
                 .expand_as(v[i]) for k in range(6)]
        FxvI.append(torch.stack([cross_fv(v[i], col) for col in Icols], dim=1))

    # ---- stage 2: forward dv/du waves ------------------------------------
    Dvq: List[torch.Tensor] = [None] * n
    Dvqd: List[torch.Tensor] = [None] * n
    for lvl in model.bfs_levels:
        for i in lvl:
            p = model.parent[i]
            if p == -1:
                Dq, Dd = zeros(), zeros()
            else:
                Dq = _col_add(Xcols(Xs[i], Dvq[p]), i, MxXv[i])
                Dd = Xcols(Xs[i], Dvqd[p])
            Dvq[i] = Dq
            Dd = Dd.clone()
            Dd[model.S_ind[i], i] = Dd[model.S_ind[i], i] + 1.0
            Dvqd[i] = Dd

    # ---- stage 3: da/du --------------------------------------------------
    Daq: List[torch.Tensor] = [None] * n
    Dad: List[torch.Tensor] = [None] * n
    for lvl in model.bfs_levels:
        for i in lvl:
            s = model.S_ind[i]
            qdi = qd[i][None]
            Aq = _col_add(mxS(s, Dvq[i], qdi), i, MxXa[i])
            Ad = _col_add(mxS(s, Dvqd[i], qdi), i, Mxv[i])
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
            Dfq[p] = _col_add(Dfq[p] + XTcols(Xs[i], Dfq[i]), i, corr)
            Dfd[p] = Dfd[p] + XTcols(Xs[i], Dfd[i])

    dcq = torch.stack([Dfq[i][model.S_ind[i]] for i in range(n)])
    dcd = torch.stack([Dfd[i][model.S_ind[i]] for i in range(n)])
    dcd = dcd.clone()
    for i in range(n):
        dcd[i, i] = dcd[i, i] + model.damping[i]
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
