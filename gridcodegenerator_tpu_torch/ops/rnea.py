"""RNEA inverse dynamics on batch-trailing tensors.

The forward pass walks the BFS waves (velocities, accelerations, body
forces); the backward pass accumulates forces into parents and projects
them onto the joint axes. A floating joint takes its six velocities and
accelerations whole and gives its six force rows whole (``vel_layout``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models.model import RobotModel
from .common import DEFAULT_GRAVITY, e_vec, gravity_accel, vel_layout
from .spatial import Mv, XTv, Xv, cross_fv, cross_mv
from .xforms import all_xmats


def rnea_fpass(model: RobotModel, Xs: List[torch.Tensor], qd: torch.Tensor,
               qdd: Optional[torch.Tensor],
               gravity: float = DEFAULT_GRAVITY):
    """Forward pass -> per-joint lists of (6, B...) v, a, f."""
    g = gravity_accel(gravity, qd)
    n = model.n
    vl = vel_layout(model)
    v: List[torch.Tensor] = [None] * n
    a: List[torch.Tensor] = [None] * n

    def joint_vec(i, x):
        off, d = vl[i]
        return e_vec(model.S_ind[i], x[off]) if d == 1 else x[off:off + 6]

    for lvl in model.bfs_levels:
        for i in lvl:
            p = model.parent[i]
            vJ = joint_vec(i, qd)
            if p == -1:
                v[i] = vJ
                a[i] = Xv(Xs[i], g.expand_as(vJ))
            else:
                v[i] = Xv(Xs[i], v[p]) + vJ
                a[i] = Xv(Xs[i], a[p]) + cross_mv(v[i], vJ)
            if qdd is not None:
                a[i] = a[i] + joint_vec(i, qdd)
    f = [Mv(model.Imat[i], a[i]) + cross_fv(v[i], Mv(model.Imat[i], v[i]))
         for i in range(n)]
    return v, a, f


def rnea_bpass(model: RobotModel, Xs: List[torch.Tensor], qd: torch.Tensor,
               f: List[torch.Tensor]):
    """Backward pass -> (c (nv, B...), accumulated per-joint forces)."""
    f = list(f)
    for lvl in reversed(model.bfs_levels):
        for i in lvl:
            p = model.parent[i]
            if p != -1:
                f[p] = f[p] + XTv(Xs[i], f[i])
    rows = []
    for i, (off, d) in enumerate(vel_layout(model)):
        if d == 1:
            rows.append((f[i][model.S_ind[i]]
                         + model.damping[i] * qd[off])[None])
        else:
            rows.append(f[i])
    return torch.cat(rows), f


def rnea(model: RobotModel, q, qd, qdd=None,
         gravity: float = DEFAULT_GRAVITY) -> torch.Tensor:
    """c(q, qd[, qdd]): (nv, B...) joint torques (the floating joint's six
    base wrench rows first)."""
    Xs = all_xmats(model, q)
    _, _, f = rnea_fpass(model, Xs, qd, qdd, gravity)
    c, _ = rnea_bpass(model, Xs, qd, f)
    return c
