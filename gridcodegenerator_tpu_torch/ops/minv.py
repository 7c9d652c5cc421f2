"""Direct M^-1 (Carpentier's analytical inverse) on batch-trailing tensors.

A reverse-BFS articulated pass, then a forward pass that runs serially over
joints with a growing column range. Subtree column updates use dense 0/1
masks over the nv columns. Fixed base, 1-dof joints.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models.model import RobotModel
from .common import check_fixed_base, eye_b
from .spatial import XTMX, XTcols, XTv, Xcols, outer6
from .xforms import all_xmats


def minv_factors(model: RobotModel, q: torch.Tensor, Xs=None,
                 return_extras: bool = False):
    """Both passes -> the upper-triangular factor Minv_upper (nv, nv, B...);
    with ``return_extras`` also {U, Dinv, F, Xs}: per joint U (6, B...),
    Dinv (B...), the final F columns (6, nv, B...) and X(q)
    (``utils/debug.py:minv_stages``)."""
    check_fixed_base(model)
    n, nv = model.n, model.num_vel
    if Xs is None:
        Xs = all_xmats(model, q)
    bshape = Xs[0].shape[2:]
    dtype, device = Xs[0].dtype, Xs[0].device
    ones_b = (1,) * len(bshape)
    sub_mask = [model.subtree_mask[i].reshape((nv,) + ones_b)
                for i in range(n)]

    Minv = torch.zeros((nv, nv) + bshape, dtype=dtype, device=device)
    F: List[Optional[torch.Tensor]] = [None] * n   # (6, nv, B...) per joint
    U: List[Optional[torch.Tensor]] = [None] * n
    Dinv: List[Optional[torch.Tensor]] = [None] * n
    IA = [model.Imat[i].reshape((6, 6) + ones_b).expand((6, 6) + bshape)
          for i in range(n)]

    def zeros_F():
        return torch.zeros((6, nv) + bshape, dtype=dtype, device=device)

    for lvl in reversed(model.bfs_levels):
        for i in lvl:
            p = model.parent[i]
            if F[i] is None:
                F[i] = zeros_F()
            s = model.S_ind[i]
            Ui = IA[i][:, s]                              # (6, B...)
            Dinv_i = 1.0 / Ui[s]                          # (B...)
            U[i], Dinv[i] = Ui, Dinv_i
            row = -Dinv_i * F[i][s] * sub_mask[i]         # (nv, B...)
            row[i] = row[i] + Dinv_i
            Minv[i] = Minv[i] + row
            if p != -1:
                F[i] = F[i] + Ui[:, None] * Minv[i][None] * sub_mask[i][None]
                if F[p] is None:
                    F[p] = zeros_F()
                F[p] = F[p] + XTcols(Xs[i], F[i])
                Ia = IA[i] - outer6(Ui * Dinv_i, Ui)
                IA[p] = IA[p] + XTMX(Xs[i], Ia)

    for i in range(n):
        p = model.parent[i]
        s = model.S_ind[i]
        if p != -1:
            UX = XTv(Xs[i], U[i])                         # (6, B...)
            contr = (UX[:, None] * F[p]).sum(0)           # (nv, B...)
            Minv[i, i:] = Minv[i, i:] - Dinv[i] * contr[i:]
            Fi_new = Xcols(Xs[i], F[p])
        else:
            Fi_new = zeros_F()
        Fi_new[s] = Fi_new[s] + Minv[i]
        F[i] = torch.cat([F[i][:, :i], Fi_new[:, i:]], dim=1)

    if return_extras:
        return Minv, dict(U=U, Dinv=Dinv, F=F, Xs=Xs)
    return Minv


def densify(Minv_upper: torch.Tensor) -> torch.Tensor:
    """Mirror the upper triangle into the lower: M + M^T - diag(M)."""
    nv = Minv_upper.shape[0]
    return (Minv_upper + Minv_upper.transpose(0, 1)
            - Minv_upper * eye_b(nv, Minv_upper))


def minv(model: RobotModel, q: torch.Tensor,
         dense: bool = True) -> torch.Tensor:
    """M(q)^-1: (nv, nv, B...), dense symmetric or the upper factor."""
    Mu = minv_factors(model, q)
    return densify(Mu) if dense else Mu
