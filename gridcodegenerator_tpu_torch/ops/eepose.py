"""End-effector pose and its Jacobian on batch-trailing tensors.

The pose is the chained homogeneous transform root->EE with xyz and ZYX-Euler
rpy extraction: roll = atan2(R21, R22), pitch = -atan2(R20, sqrt(R21^2 +
R22^2)), yaw = atan2(R10, R00). The Jacobian is the chain form of
``gridcodegenerator_tpu/ops/eepose.py:deepos_chain``: dT/dq_a = prefix_a .
dT_a . suffix_a, pushed through the derivative of the pose extraction.

End-effectors default to the robot's fixed-joint frames when it has any,
and to the leaf links otherwise; ``targets`` names the fixed-joint frames to
use instead. ``fk`` gives the world transform of every joint frame.

A floating root takes its 7 coordinates [x, y, z, qx, qy, qz, qw]
(``pos_layout``): its transform is [[R(quat / |quat|), p], [0, 1]], and its
derivatives over all 7 are forward-mode JVPs of that one small expression
(``torch.func.jvp``): the translation is linear, and only the 10
quaternion-quaternion pairs carry curvature. So ``deepos`` has num_pos
columns and ``d2eepos`` a 7x7 root block.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..models.model import RobotModel
from .common import pos_layout


def _fixed_chain(model: RobotModel, fid: int):
    j = model.fixed_parent[fid]
    return ((model.ancestors[j] + (j,)) if j >= 0 else (), fid)


def ee_chains(model: RobotModel, targets: Optional[Sequence[str]] = None
              ) -> List[Tuple[Tuple[int, ...], Optional[int]]]:
    """Per-EE (joint chain root->parent, fixed-joint index or None).

    ``targets`` names fixed-joint frames; an unknown name raises
    ``ValueError``."""
    if targets is not None:
        return [_fixed_chain(model, model.fixed_names.index(t))
                for t in targets]
    if model.fixed_parent:
        return [_fixed_chain(model, fid)
                for fid in range(len(model.fixed_parent))]
    return [(model.ancestors[leaf] + (leaf,), None) for leaf in model.leaves]


def num_ees(model: RobotModel, targets: Optional[Sequence[str]] = None) -> int:
    return len(ee_chains(model, targets))


def _mm44(A, B):
    """4x4 product with either operand batched (4,4,B...) or constant (4,4)."""
    sa = "ik" if A.ndim == 2 else "ik..."
    sb = "kj" if B.ndim == 2 else "kj..."
    out = "ij" if A.ndim == 2 and B.ndim == 2 else "ij..."
    return torch.einsum(f"{sa},{sb}->{out}", A, B)


def _mm44_opt(A, B):
    """_mm44 with None = identity."""
    if A is None:
        return B
    if B is None:
        return A
    return _mm44(A, B)


def _stack44(rows):
    return torch.stack([torch.stack(r) for r in rows])


def _joint_T_parts(model: RobotModel, i: int, qi, deriv: bool):
    """Joint-local transform Tj(q) (and dTj/dq when ``deriv``), (4,4,B...)."""
    z = torch.zeros_like(qi)
    o = torch.ones_like(qi)
    if model.jtype[i] == "revolute":
        c, s = torch.cos(qi), torch.sin(qi)
        ax = model.S_ind[i] % 3
        if ax == 0:
            R = [[o, z, z], [z, c, -s], [z, s, c]]
            dR = [[z, z, z], [z, -s, -c], [z, c, -s]]
        elif ax == 1:
            R = [[c, z, s], [z, o, z], [-s, z, c]]
            dR = [[-s, z, c], [z, z, z], [-c, z, -s]]
        else:
            R = [[c, -s, z], [s, c, z], [z, z, o]]
            dR = [[-s, -c, z], [c, -s, z], [z, z, z]]
        Tj = _stack44([R[0] + [z], R[1] + [z], R[2] + [z], [z, z, z, o]])
        if not deriv:
            return Tj, None
        dTj = _stack44([dR[0] + [z], dR[1] + [z], dR[2] + [z], [z, z, z, z]])
        return Tj, dTj
    if model.jtype[i] == "prismatic":
        ax = model.S_ind[i] - 3
        col = [z, z, z]
        col[ax] = qi
        Tj = _stack44([[o, z, z, col[0]], [z, o, z, col[1]],
                       [z, z, o, col[2]], [z, z, z, o]])
        if not deriv:
            return Tj, None
        dcol = [z, z, z]
        dcol[ax] = o
        dTj = _stack44([[z, z, z, dcol[0]], [z, z, z, dcol[1]],
                        [z, z, z, dcol[2]], [z, z, z, z]])
        return Tj, dTj
    raise NotImplementedError(model.jtype[i])


def _joint_d2T(model: RobotModel, i: int, qi):
    """Ttree . d2Tj/dq2 of joint i, (4,4,B...): -R on the rotating 2x2 block
    of a revolute joint; None (zero) for a prismatic one."""
    if model.jtype[i] != "revolute":
        return None
    z = torch.zeros_like(qi)
    c, s = torch.cos(qi), torch.sin(qi)
    ax = model.S_ind[i] % 3
    if ax == 0:
        R = [[z, z, z], [z, -c, s], [z, -s, -c]]
    elif ax == 1:
        R = [[-c, z, -s], [z, z, z], [s, z, -c]]
    else:
        R = [[-c, s, z], [-s, -c, z], [z, z, z]]
    return _mm44(model.Ttree[i], _stack44([R[0] + [z], R[1] + [z],
                                           R[2] + [z], [z, z, z, z]]))


def _floating_T(q7):
    """The floating root's link->parent transform from q7 = [x, y, z, qx,
    qy, qz, qw] (7, B...) -> (4,4,B...); the quaternion is normalized
    here."""
    p = q7[:3]
    x, y, z, w = q7[3:7] / torch.sqrt((q7[3:7] * q7[3:7]).sum(0))
    zz, oo = torch.zeros_like(x), torch.ones_like(x)
    return _stack44([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
         p[0]],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
         p[1]],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
         p[2]],
        [zz, zz, zz, oo]])


def _floating_derivs(q7, hess: bool):
    """(T, [dT/dq_c for the 7 coordinates], {(c1, c2): d2T/dq_c1 dq_c2}) of
    the floating root, by JVPs of :func:`_floating_T`. The map holds the
    10 quaternion pairs c1 <= c2 (with ``hess``): the translation is
    linear and does not mix with the quaternion."""
    seeds = []
    for c in range(7):
        e = torch.zeros_like(q7)
        e[c] = 1.0
        seeds.append(e)
    dTs = [torch.func.jvp(_floating_T, (q7,), (e,))[1] for e in seeds]
    d2 = {}
    if hess:
        for c1 in range(3, 7):
            def along_c1(v, e=seeds[c1]):
                return torch.func.jvp(_floating_T, (v,), (e,))[1]
            for c2 in range(c1, 7):
                d2[c1, c2] = torch.func.jvp(along_c1, (q7,), (seeds[c2],))[1]
    return _floating_T(q7), dTs, d2


def _coords(q, layout):
    """A joint's coordinates at its ``pos_layout`` entry (off, k): q[off]
    (B...), or (7, B...) for the floating root."""
    off, k = layout
    return q[off] if k == 1 else q[off:off + k]


def _joint_T_lanes(model: RobotModel, i: int, qi):
    """Link->parent transform of joint i: qi (B...) (the floating root's
    (7, B...)) -> (4,4,B...)."""
    if model.jtype[i] == "floating":
        return _floating_T(qi)
    return _mm44(model.Ttree[i], _joint_T_parts(model, i, qi, False)[0])


def _chain_T(model: RobotModel, q, chain, fid):
    """Chain product T_c0 ... T_ck [. Tfixed] -> (4,4,B...)."""
    if not chain:
        T = model.Tfixed[fid]
        return T.reshape((4, 4) + (1,) * (q.ndim - 1)).expand(
            (4, 4) + q.shape[1:])
    pl = pos_layout(model)
    T = _joint_T_lanes(model, chain[0], _coords(q, pl[chain[0]]))
    for j in chain[1:]:
        T = _mm44(T, _joint_T_lanes(model, j, _coords(q, pl[j])))
    if fid is not None:
        T = _mm44(T, model.Tfixed[fid])
    return T


def _pose_from_T(T):
    """(4,4,B...) -> (6,B...) [xyz, roll, pitch, yaw]."""
    roll = torch.atan2(T[2, 1], T[2, 2])
    pitch = -torch.atan2(T[2, 0], torch.sqrt(T[2, 1] ** 2 + T[2, 2] ** 2))
    yaw = torch.atan2(T[1, 0], T[0, 0])
    return torch.cat([T[:3, 3], torch.stack([roll, pitch, yaw])], dim=0)


def _pose_jvp(T, dT):
    """Directional derivative of :func:`_pose_from_T` at T along dT."""
    def datan2(y, x, dy, dx):
        return (x * dy - y * dx) / (x * x + y * y)
    r = torch.sqrt(T[2, 1] ** 2 + T[2, 2] ** 2)
    dr = (T[2, 1] * dT[2, 1] + T[2, 2] * dT[2, 2]) / r
    droll = datan2(T[2, 1], T[2, 2], dT[2, 1], dT[2, 2])
    dpitch = -datan2(T[2, 0], r, dT[2, 0], dr)
    dyaw = datan2(T[1, 0], T[0, 0], dT[1, 0], dT[0, 0])
    return torch.cat([dT[:3, 3], torch.stack([droll, dpitch, dyaw])], dim=0)


def _hatan2(y, x, y1, x1, y2, x2, y12, x12):
    """Second derivative of atan2(y, x) along directions 1 and 2, with the
    second-order direction (y12, x12): f'[d12] + f''[d1, d2], where, with
    r2 = x^2 + y^2, f_yy = -2xy/r2^2, f_xx = 2xy/r2^2, f_xy = (y^2-x^2)/r2^2."""
    r2 = x * x + y * y
    return ((x * y12 - y * x12) / r2
            + (2 * x * y * (x1 * x2 - y1 * y2)
               + (y * y - x * x) * (y1 * x2 + x1 * y2)) / (r2 * r2))


def _pose_hvp(T, dT1, dT2, d2T):
    """Second directional derivative of :func:`_pose_from_T` at T:
    f'(T)[d2T] + f''(T)[dT1, dT2], in closed form. Pitch nests
    r = sqrt(T21^2 + T22^2), whose second derivative is
    (dT1 . dT2 + T . d2T) / r - r1 r2 / r on the (T21, T22) pair."""
    a, b = T[2, 1], T[2, 2]
    r = torch.sqrt(a * a + b * b)
    r1 = (a * dT1[2, 1] + b * dT1[2, 2]) / r
    r2 = (a * dT2[2, 1] + b * dT2[2, 2]) / r
    r12 = (a * d2T[2, 1] + b * d2T[2, 2] + dT1[2, 1] * dT2[2, 1]
           + dT1[2, 2] * dT2[2, 2] - r1 * r2) / r
    roll = _hatan2(a, b, dT1[2, 1], dT1[2, 2], dT2[2, 1], dT2[2, 2],
                   d2T[2, 1], d2T[2, 2])
    pitch = -_hatan2(T[2, 0], r, dT1[2, 0], r1, dT2[2, 0], r2, d2T[2, 0],
                     r12)
    yaw = _hatan2(T[1, 0], T[0, 0], dT1[1, 0], dT1[0, 0], dT2[1, 0],
                  dT2[0, 0], d2T[1, 0], d2T[0, 0])
    return torch.cat([d2T[:3, 3], torch.stack([roll, pitch, yaw])], dim=0)


def eepos(model: RobotModel, q, targets: Optional[Sequence[str]] = None):
    """EE poses: q (num_pos, B...) -> (num_ees*6, B...)."""
    return torch.cat([_pose_from_T(_chain_T(model, q, chain, fid))
                      for chain, fid in ee_chains(model, targets)], dim=0)


def eexyz(model: RobotModel, q, targets: Optional[Sequence[str]] = None):
    """EE xyz positions only: q (num_pos, B...) -> (num_ees*3, B...)."""
    return torch.cat([_chain_T(model, q, chain, fid)[:3, 3]
                      for chain, fid in ee_chains(model, targets)], dim=0)


def _chain_parts(model: RobotModel, q, chain, hess: bool = False):
    """Per chain joint a: T_a, its derivatives dT_a (a list, one per
    coordinate: one, or the floating root's seven) and, with ``hess``, its
    second derivatives (a map over coordinate pairs c1 <= c2, zero pairs
    left out), all with Ttree applied; prefix_a = T_0 ... T_a-1 (None for
    a = 0) and suffix_a = T_a+1 ... T_k-1 Tfixed (None for the last joint
    without a fixed frame); each joint's first q-column; and the full
    chain transform."""
    chain, fid = chain
    pl = pos_layout(model)
    Ts, dTs, d2Ts, offs = [], [], [], []
    for j in chain:
        qj = _coords(q, pl[j])
        offs.append(pl[j][0])
        if model.jtype[j] == "floating":
            T, dT, d2 = _floating_derivs(qj, hess)
        else:
            Tj, dTj = _joint_T_parts(model, j, qj, True)
            T, dT = _mm44(model.Ttree[j], Tj), [_mm44(model.Ttree[j], dTj)]
            d2j = _joint_d2T(model, j, qj) if hess else None
            d2 = {} if d2j is None else {(0, 0): d2j}
        Ts.append(T)
        dTs.append(dT)
        d2Ts.append(d2)
    k = len(chain)
    prefix, acc = [None] * k, None
    for a in range(k):
        prefix[a] = acc
        acc = Ts[a] if acc is None else _mm44(acc, Ts[a])
    suffix = [None] * k
    acc = model.Tfixed[fid] if fid is not None else None
    for a in range(k - 1, -1, -1):
        suffix[a] = acc
        acc = Ts[a] if acc is None else _mm44(Ts[a], acc)
    return Ts, dTs, d2Ts, offs, prefix, suffix, acc


def deepos(model: RobotModel, q, targets: Optional[Sequence[str]] = None):
    """EE pose Jacobian, chain form: (num_ees*6, num_pos, B...)."""
    npos = model.num_pos
    zero = torch.zeros((6,) + q.shape[1:], dtype=q.dtype, device=q.device)
    blocks = []
    for chain in ee_chains(model, targets):
        cols = {}
        if chain[0]:
            _, dTs, _, offs, prefix, suffix, Tfull = _chain_parts(model, q,
                                                                 chain)
            for a in range(len(chain[0])):
                for c, dT_c in enumerate(dTs[a]):
                    dT = _mm44_opt(_mm44_opt(prefix[a], dT_c), suffix[a])
                    cols[offs[a] + c] = _pose_jvp(Tfull, dT)
        blocks.append(torch.stack([cols.get(c, zero) for c in range(npos)],
                                  dim=1))
    return torch.cat(blocks, dim=0)


def d2eepos(model: RobotModel, q, targets: Optional[Sequence[str]] = None):
    """EE pose Hessian, chain form: (num_ees*6, num_pos, num_pos, B...),
    symmetric; ``gridcodegenerator_tpu/ops/eepose.py:d2eepos_chain``.

    For chain coordinates of joints a < b, d2T/dq_a dq_b = W_ab . dT_b .
    suffix_b with W_ab = prefix_a . dT_a . T_a+1 ... T_b-1 (one sweep per
    coordinate of a), and within joint a's block d2T = prefix_a . d2T_a .
    suffix_a (zero for a prismatic joint and the floating root's
    translation); each goes through the pose extraction's second
    derivative (:func:`_pose_hvp`). Joints off the chain, and every entry
    of an EE with an empty chain, are zero."""
    npos = model.num_pos
    zero = torch.zeros((6,) + q.shape[1:], dtype=q.dtype, device=q.device)
    zero44 = torch.zeros((4, 4) + q.shape[1:], dtype=q.dtype, device=q.device)
    blocks = []
    for chain in ee_chains(model, targets):
        H = {}
        if chain[0]:
            k = len(chain[0])
            Ts, dTs, d2Ts, offs, prefix, suffix, Tfull = _chain_parts(
                model, q, chain, hess=True)
            dTf = [[_mm44_opt(_mm44_opt(prefix[a], dT_c), suffix[a])
                    for dT_c in dTs[a]] for a in range(k)]
            for a in range(k):
                oa, nca = offs[a], len(dTs[a])
                for c1 in range(nca):
                    for c2 in range(c1, nca):
                        d2j = d2Ts[a].get((c1, c2))
                        d2T = (zero44 if d2j is None else
                               _mm44_opt(_mm44_opt(prefix[a], d2j),
                                         suffix[a]))
                        H[oa + c1, oa + c2] = H[oa + c2, oa + c1] = (
                            _pose_hvp(Tfull, dTf[a][c1], dTf[a][c2], d2T))
                W = [_mm44_opt(prefix[a], dT_c) for dT_c in dTs[a]]
                for b in range(a + 1, k):
                    for c1 in range(nca):
                        for c2, dT_bc in enumerate(dTs[b]):
                            d2T = _mm44_opt(_mm44(W[c1], dT_bc), suffix[b])
                            H[oa + c1, offs[b] + c2] = H[
                                offs[b] + c2, oa + c1] = _pose_hvp(
                                    Tfull, dTf[a][c1], dTf[b][c2], d2T)
                    W = [_mm44(Wc, Ts[b]) for Wc in W]
        blocks.append(torch.stack([
            torch.stack([H.get((r, c), zero) for c in range(npos)], dim=1)
            for r in range(npos)], dim=1))
    return torch.cat(blocks, dim=0)


def fk(model: RobotModel, q):
    """World transforms of every joint frame: q (num_pos, B...) ->
    (n, 4, 4, B...); each parent's transform is reused down the tree."""
    Tw = [None] * model.n
    for i, layout in enumerate(pos_layout(model)):   # parents come first
        Ti = _joint_T_lanes(model, i, _coords(q, layout))
        p = model.parent[i]
        Tw[i] = Ti if p < 0 else _mm44(Tw[p], Ti)
    return torch.stack(Tw)
