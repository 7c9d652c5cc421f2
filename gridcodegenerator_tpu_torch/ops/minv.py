"""Direct M^-1 (Carpentier's analytical inverse) on batch-trailing tensors.

A reverse-BFS articulated pass, then a forward pass that runs serially over
joints with a growing column range. Subtree column updates use dense 0/1
masks over the nv columns. The floating joint's 6x6 articulated block is
inverted by the pivot-free Gauss-Jordan of ``ops/linalg.py`` (``_inv66``;
the block is SPD), and only its upper triangle is stored, as the upper
factor keeps every diagonal block, so ``densify`` does not double it.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models.model import RobotModel
from .common import eye_b, vel_layout
from .linalg import gj_inverse
from .spatial import XTMX, XTcols, XTv, Xcols, bmm, outer6
from .xforms import all_xmats


def _inv66(D):
    """Batched 6x6 inverse of the SPD articulated base block, (6, 6, B...)."""
    return gj_inverse(D)


def minv_factors(model: RobotModel, q: torch.Tensor, Xs=None,
                 return_extras: bool = False):
    """Both passes -> the upper-triangular factor Minv_upper (nv, nv, B...);
    with ``return_extras`` also {U, Dinv, F, Xs}: per joint U (6, B...),
    Dinv (B...) ((6, 6, B...) and their inverse for the floating joint),
    the final F columns (6, nv, B...) and X(q) (``utils/debug.py:
    minv_stages``)."""
    n, nv = model.n, model.num_vel
    vl = vel_layout(model)
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
            off, d = vl[i]
            p = model.parent[i]
            if F[i] is None:
                F[i] = zeros_F()
            if d == 1:
                s = model.S_ind[i]
                Ui = IA[i][:, s]                          # (6, B...)
                Dinv_i = 1.0 / Ui[s]                      # (B...)
                row = -Dinv_i * F[i][s] * sub_mask[i]     # (nv, B...)
                row[off] = row[off] + Dinv_i
                Minv[off] = Minv[off] + row
                Fi_add = Ui[:, None] * Minv[off][None]
            else:             # the floating joint: S = I6, U = IA, D = IA
                Ui = IA[i]
                Dinv_i = _inv66(Ui)
                rows = -bmm(Dinv_i, F[i]) * sub_mask[i][None]
                triu = torch.ones((d, d), dtype=dtype, device=device).triu()
                rows[:, off:off + d] = (rows[:, off:off + d]
                                        + Dinv_i * triu.reshape((d, d)
                                                                + ones_b))
                Minv[off:off + d] = Minv[off:off + d] + rows
                Fi_add = bmm(Ui, Minv[off:off + d])
            U[i], Dinv[i] = Ui, Dinv_i
            if p != -1:
                F[i] = F[i] + Fi_add * sub_mask[i][None]
                if F[p] is None:
                    F[p] = zeros_F()
                F[p] = F[p] + XTcols(Xs[i], F[i])
                UDU = (outer6(Ui * Dinv_i, Ui) if d == 1 else
                       bmm(bmm(Ui, Dinv_i), Ui.transpose(0, 1)))
                IA[p] = IA[p] + XTMX(Xs[i], IA[i] - UDU)

    for i in range(n):
        off, d = vl[i]
        p = model.parent[i]
        if d == 1:
            if p != -1:
                UX = XTv(Xs[i], U[i])                     # (6, B...)
                contr = (UX[:, None] * F[p]).sum(0)       # (nv, B...)
                Minv[off, off:] = Minv[off, off:] - Dinv[i] * contr[off:]
                Fi_new = Xcols(Xs[i], F[p])
            else:
                Fi_new = zeros_F()
            s = model.S_ind[i]
            Fi_new[s] = Fi_new[s] + Minv[off]
            Fi_new = Fi_new[:, off:]
        else:
            if p != -1:
                UX = bmm(U[i].transpose(0, 1), Xs[i])     # U^T X
                Minv[off:off + d, off:] = Minv[off:off + d, off:] - bmm(
                    bmm(Dinv[i], UX), F[p][:, off:])
                Fi_new = Minv[off:off + d, off:] + Xcols(Xs[i], F[p][:, off:])
            else:
                Fi_new = Minv[off:off + d, off:].clone()
        F[i] = torch.cat([F[i][:, :off], Fi_new], dim=1)

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
