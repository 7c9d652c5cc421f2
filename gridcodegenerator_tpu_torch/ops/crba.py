"""CRBA mass matrix on batch-trailing tensors.

Composite inertias accumulate up the tree in reverse BFS order; column i of
the upper triangle is the composite force of joint i carried up its ancestor
chain and projected on each ancestor's axis; the lower triangle mirrors it.
A floating joint's column block is six columns wide (S = I6) and its rows
take the carried force whole.
"""

from __future__ import annotations

import torch

from ..models.model import RobotModel
from .common import S_matrix, eye_b, vel_layout
from .spatial import XTMX, XTcols, XTv
from .xforms import all_xmats


def crba(model: RobotModel, q, Xs=None) -> torch.Tensor:
    """M(q): (nv, nv, B...) dense symmetric mass matrix."""
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

    if model.floating_base:
        return _crba_blocks(model, Xs, Ic)
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


def _crba_blocks(model: RobotModel, Xs, Ic) -> torch.Tensor:
    """M by (row, column) blocks of each joint's dof, for a floating base:
    column block i is Ic_i S_i carried up the ancestors, each ancestor j's
    rows its S_j^T projection; the blocks above the diagonal mirror it."""
    vl = vel_layout(model)
    nv = model.num_vel
    dtype, device = Xs[0].dtype, Xs[0].device
    bshape = Xs[0].shape[2:]
    M = torch.zeros((nv, nv) + bshape, dtype=dtype, device=device)
    S = [torch.as_tensor(S_matrix(model, i), dtype=dtype, device=device)
         for i in range(model.n)]

    def rows_of(j, fh):        # S_j^T fh: (d_j, d_i, B...)
        return torch.einsum("jk,jl...->kl...", S[j], fh)

    for i in range(model.n):
        oi, di = vl[i]
        fh = torch.einsum("ij...,jk->ik...", Ic[i], S[i])
        M[oi:oi + di, oi:oi + di] = rows_of(i, fh)
        j = i
        while model.parent[j] != -1:
            fh = XTcols(Xs[j], fh)
            j = model.parent[j]
            oj, dj = vl[j]
            blk = rows_of(j, fh)
            M[oj:oj + dj, oi:oi + di] = blk
            M[oi:oi + di, oj:oj + dj] = blk.transpose(0, 1)
    return M
