"""CRBA mass matrix on batch-trailing tensors.

Composite inertias accumulate up the tree in reverse BFS order; column i of
the upper triangle is the composite force of joint i carried up its ancestor
chain and projected on each ancestor's axis; the lower triangle mirrors it.
Fixed base, 1-dof joints.
"""

from __future__ import annotations

import torch

from ..models.model import RobotModel
from .common import check_fixed_base, eye_b
from .spatial import XTMX, XTv
from .xforms import all_xmats


def crba(model: RobotModel, q, Xs=None) -> torch.Tensor:
    """M(q): (nv, nv, B...) dense symmetric mass matrix."""
    check_fixed_base(model)
    n = model.n
    if Xs is None:
        Xs = all_xmats(model, q)
    bshape = Xs[0].shape[2:]
    Ic = [model.Imat[i].reshape((6, 6) + (1,) * len(bshape)).expand(
        (6, 6) + bshape) for i in range(n)]
    for lvl in reversed(model.bfs_levels):
        for i in lvl:
            p = model.parent[i]
            if p != -1:
                Ic[p] = Ic[p] + XTMX(Xs[i], Ic[i])

    zero = torch.zeros(bshape, dtype=Xs[0].dtype, device=Xs[0].device)
    cols = []
    for i in range(n):
        fh = Ic[i][:, model.S_ind[i]]                 # (6, B...)
        entries = {i: fh[model.S_ind[i]]}
        j = i
        while model.parent[j] != -1:                  # up the ancestors
            fh = XTv(Xs[j], fh)
            j = model.parent[j]
            entries[j] = fh[model.S_ind[j]]
        cols.append(torch.stack([entries.get(r, zero) for r in range(n)]))
    Mu = torch.stack(cols, dim=1)                     # upper triangle
    return Mu + Mu.transpose(0, 1) - Mu * eye_b(n, Mu)
