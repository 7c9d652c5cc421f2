"""Forward dynamics via the Minv route on batch-trailing tensors.

qdd = Minv(q) (u - c(q, qd)): the bias RNEA (no qdd), Carpentier's direct
Minv on the same joint transforms, then the matvec. Fixed base, 1-dof
joints.
"""

from __future__ import annotations

from ..models.model import RobotModel
from .common import DEFAULT_GRAVITY
from .minv import densify, minv_factors
from .rnea import rnea_bpass, rnea_fpass
from .spatial import bmv
from .xforms import all_xmats


def forward_dynamics(model: RobotModel, q, qd, u,
                     gravity: float = DEFAULT_GRAVITY,
                     return_extras: bool = False):
    """qdd (nv, B...); with ``return_extras`` (qdd, c, Minv dense, Xs)."""
    Xs = all_xmats(model, q)
    _, _, f = rnea_fpass(model, Xs, qd, None, gravity)
    c, _ = rnea_bpass(model, Xs, qd, f)
    Mi = densify(minv_factors(model, q, Xs=Xs))
    qdd = bmv(Mi, u - c)
    if return_extras:
        return qdd, c, Mi, Xs
    return qdd
