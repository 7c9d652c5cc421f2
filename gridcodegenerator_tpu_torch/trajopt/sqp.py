"""SQP trajectory optimizer with exact second-order dynamics Hessians.

The counterpart of ``gridcodegenerator_tpu/trajopt/sqp.py``: single-shooting
SQP, each iteration solving the quadratic subproblem by the Riccati
recursion with the second-order dynamics terms kept, which for the
unconstrained subproblem is the exact-Hessian DDP backward sweep
(``make_ilqr`` with ``use_second_order=True``). Control bounds are handled
by the clamped rollouts of the line search. The second-order tensors come
from FDSVA-SO (``ops/so.py``; the ``fdsva_so`` kernel on the card). The
cost is any ``CostModel`` with ``stage_expansion``: ``QuadCost``, a user
cost of the knot index, or ``EEReachCost``, whose dense Gauss-Newton
expansion takes its pose and Jacobian from the eepos and deepos kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.model import RobotModel
from .ilqr import ILQRConfig, make_ilqr


@dataclasses.dataclass(frozen=True)
class SQPConfig(ILQRConfig):
    use_second_order: bool = True


def make_sqp(model: RobotModel, cost, cfg: Optional[SQPConfig] = None,
             expose_parts: bool = False, **kw):
    """Build the SQP solver (the solve signature of ``make_ilqr``)."""
    if cfg is None:
        cfg = SQPConfig(**kw)
    if not cfg.use_second_order:
        raise ValueError("SQP needs the exact-Hessian sweep "
                         "(use_second_order=True)")
    return make_ilqr(model, cost, cfg, expose_parts)
