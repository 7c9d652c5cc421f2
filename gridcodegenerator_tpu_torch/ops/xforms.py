"""Joint transforms X_i(q_i), (6, 6, B...) per joint.

Each 1-dof joint's ``X = X_joint(q) @ X_tree``: a coordinate rotation for a
revolute joint, a translation along the axis for a prismatic one. The
floating joint's X comes from its 7 coordinates [x, y, z, qx, qy, qz, qw]
(``floating_xmat``).
"""

from __future__ import annotations

from typing import List

import torch

from ..models.model import RobotModel
from .common import pos_layout


def _rot_E(axis: int, c, s):
    """Coordinate rotation E = R_axis(q)^T as a (3, 3, B...) stack."""
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    if axis == 0:
        rows = [[o, z, z], [z, c, s], [z, -s, c]]
    elif axis == 1:
        rows = [[c, z, -s], [z, o, z], [s, z, c]]
    else:
        rows = [[c, s, z], [-s, c, z], [z, z, o]]
    return torch.stack([torch.stack(r) for r in rows])


def _skew_axis(k: int, qi):
    """skew(q e_k) as a (3, 3, B...) stack."""
    z = torch.zeros_like(qi)
    rows = {
        0: [[z, z, z], [z, z, -qi], [z, qi, z]],
        1: [[z, z, qi], [z, z, z], [-qi, z, z]],
        2: [[z, -qi, z], [qi, z, z], [z, z, z]],
    }[k]
    return torch.stack([torch.stack(r) for r in rows])


def joint_xmat(model: RobotModel, i: int, qi) -> torch.Tensor:
    """X_i(q_i) for one 1-dof joint: qi (B...) -> (6, 6, B...)."""
    XT = model.Xtree[i]
    if model.jtype[i] == "revolute":
        E = _rot_E(model.S_ind[i] % 3, torch.cos(qi), torch.sin(qi))
        top = torch.einsum("ik...,kj->ij...", E, XT[:3])
        bot = torch.einsum("ik...,kj->ij...", E, XT[3:])
        return torch.cat([top, bot], dim=0)
    if model.jtype[i] == "prismatic":
        # X = [[I, 0], [-skew(q e_k), I]] @ XT
        sk = _skew_axis(model.S_ind[i] - 3, qi)
        shape = (3, 6) + qi.shape
        top = XT[:3].reshape((3, 6) + (1,) * qi.ndim).expand(shape)
        bot = (XT[3:].reshape((3, 6) + (1,) * qi.ndim)
               - torch.einsum("ik...,kj->ij...", sk, XT[:3]))
        return torch.cat([top, bot], dim=0)
    raise NotImplementedError(model.jtype[i])


def floating_xmat(q7) -> torch.Tensor:
    """The floating joint's X from q7 = [x, y, z, qx, qy, qz, qw] (7, B...)
    -> (6, 6, B...); the quaternion is normalized here."""
    p = q7[:3]
    x, y, z, w = q7[3:7] / torch.sqrt((q7[3:7] * q7[3:7]).sum(0))
    # R takes child-frame vectors into the parent frame; E = R^T
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)])])
    E = R.transpose(0, 1)
    zz = torch.zeros_like(p[0])
    sk = torch.stack([torch.stack([zz, -p[2], p[1]]),
                      torch.stack([p[2], zz, -p[0]]),
                      torch.stack([-p[1], p[0], zz])])
    bl = -torch.einsum("ik...,kj...->ij...", E, sk)
    return torch.cat([torch.cat([E, torch.zeros_like(E)], dim=1),
                      torch.cat([bl, E], dim=1)], dim=0)


def all_xmats(model: RobotModel, q) -> List[torch.Tensor]:
    """Per-joint X(q) list; q is (num_pos, B...) in ``pos_layout``."""
    return [floating_xmat(q[off:off + k]) if k == 7
            else joint_xmat(model, i, q[off])
            for i, (off, k) in enumerate(pos_layout(model))]
