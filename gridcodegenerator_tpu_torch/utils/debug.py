"""Staged-intermediate debugging: the DEBUG_MODE analog.

The counterpart of ``gridcodegenerator_tpu/utils/debug.py``. The reference
threads printf dumps of every intermediate through its kernels
(``DEBUG_MODE``/``NEED_PRINT_MAT``) to be eye-diffed against the NumPy
oracle's prints. Here ``*_stages`` take lane-major torch tensors (on any
device) and return every intermediate of the port's plain ops as named
numpy arrays, with the JAX package's keys and layouts; ``oracle_*_stages``
give the float64 oracle's (``reference/oracle.py``) for one sample;
``print_stages`` renders them like the oracle's dumps, and
``diff_stages`` automates the diff.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.model import RobotModel
from ..ops.aba import aba as _aba
from ..ops.common import DEFAULT_GRAVITY, check_fixed_base
from ..ops.id_grad import id_grad_inner
from ..ops.minv import densify, minv_factors
from ..ops.rnea import rnea_bpass, rnea_fpass
from ..ops.so import idsva_so_analytical
from ..ops.xforms import all_xmats
from ..reference import oracle as _oracle
from ..topology.robot import RobotTopology


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _np_stages(stages) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in stages.items()}


# the JAX package's refusal (``gridcodegenerator_tpu/utils/debug.py:65-69``)
STAGES_FIXED_BASE = ("staged dumps beyond RNEA are fixed-base (the floating "
                     "6-dof block's per-joint intermediates have mixed "
                     "shapes)")


def rnea_stages(model: RobotModel, q, qd, qdd=None,
                gravity=DEFAULT_GRAVITY) -> Dict[str, np.ndarray]:
    """All RNEA intermediates for lane-major inputs: X, v, a, f_body,
    f_accumulated, c — the reference's per-stage dump set."""
    Xs = all_xmats(model, q)
    v, a, f = rnea_fpass(model, Xs, qd, qdd, gravity)
    c, f_acc = rnea_bpass(model, Xs, qd, f)
    return _np_stages({"X": torch.stack(Xs), "v": torch.stack(v),
                       "a": torch.stack(a), "f_body": torch.stack(f),
                       "f": torch.stack(f_acc), "c": c})


def oracle_rnea_stages(topo: RobotTopology, q, qd, qdd=None,
                       gravity=DEFAULT_GRAVITY) -> Dict[str, np.ndarray]:
    """The float64 oracle's intermediates for one sample (same keys)."""
    n = topo.get_num_joints()
    v, a, f_body = _oracle.rnea_fpass(topo, q, qd, qdd, gravity)
    c, f_acc = _oracle.rnea_bpass(topo, q, qd, f_body)
    return {
        "X": np.stack([topo.get_Xmat_Func_by_id(i)(q[i])
                       for i in range(n)])[..., None],
        "v": v.T[:, :, None],
        "a": a.T[:, :, None],
        "f_body": f_body.T[:, :, None],
        "f": f_acc.T[:, :, None],
        "c": c[:, None],
    }


def minv_stages(model: RobotModel, q) -> Dict[str, np.ndarray]:
    """Direct-Minv intermediates (lane-major inputs): per-joint U, Dinv,
    final F columns, the SYMMETRIC_UPPER factor and the dense inverse —
    the reference's DEBUG set."""
    check_fixed_base(model, STAGES_FIXED_BASE)
    Mu, extras = minv_factors(model, q, return_extras=True)
    return _np_stages({
        "U": torch.stack(extras["U"]),          # (n, 6, B)
        "Dinv": torch.stack(extras["Dinv"]),    # (n, B)
        "F": torch.stack(extras["F"]),          # (n, 6, nv, B)
        "Minv_upper": Mu,
        "Minv": densify(Mu),
    })


def oracle_minv_stages(topo: RobotTopology, q) -> Dict[str, np.ndarray]:
    """The float64 oracle's Minv intermediates for one sample (same keys)."""
    _, st = _oracle.minv(topo, q, return_stages=True)
    return {k: np.asarray(v)[..., None] for k, v in st.items()}


def id_grad_stages(model: RobotModel, q, qd, qdd=None,
                   gravity=DEFAULT_GRAVITY) -> Dict[str, np.ndarray]:
    """ID-gradient intermediates: dv/du, da/du, df/du (body + accumulated)
    and dc_du — the reference's staged DEBUG dumps. Layout (n, 6, nv, B):
    [joint, component, column, lane]."""
    check_fixed_base(model, STAGES_FIXED_BASE)
    Xs = all_xmats(model, q)
    v, a, f = rnea_fpass(model, Xs, qd, qdd, gravity)
    _, f_acc = rnea_bpass(model, Xs, qd, f)
    _, st = id_grad_inner(model, Xs, qd, v, a, f_acc, gravity,
                          return_stages=True)
    return _np_stages(st)


def oracle_id_grad_stages(topo: RobotTopology, q, qd, qdd=None,
                          gravity=DEFAULT_GRAVITY) -> Dict[str, np.ndarray]:
    """The oracle's ID-gradient intermediates for one sample (same keys,
    transposed from the oracle's (6, col, joint) into (joint, 6, col))."""
    _, v, a, f = _oracle.rnea(topo, q, qd, qdd, gravity)
    _, _, st = _oracle.rnea_grad_inner(topo, q, qd, v, a, f, gravity,
                                       return_stages=True)
    out = {}
    for k, arr in st.items():
        if k.startswith(("dv_", "da_", "df_")):
            out[k] = np.transpose(arr, (2, 0, 1))[..., None]
        else:
            out[k] = np.asarray(arr)[..., None]
    return out


def aba_stages(model: RobotModel, q, qd, u,
               gravity=DEFAULT_GRAVITY) -> Dict[str, np.ndarray]:
    """ABA intermediates: v, cbias, accumulated pA, U, Dinv, uu, a, qdd —
    the reference's DEBUG sites through its three passes."""
    check_fixed_base(model, STAGES_FIXED_BASE)
    _, st = _aba(model, q, qd, u, gravity, return_stages=True)
    return _np_stages(st)


def oracle_aba_stages(topo: RobotTopology, q, qd, u,
                      gravity=DEFAULT_GRAVITY) -> Dict[str, np.ndarray]:
    """The oracle's ABA intermediates for one sample (same keys)."""
    _, st = _oracle.aba(topo, q, qd, u, gravity, return_stages=True)
    out = {}
    for k, arr in st.items():
        arr = np.asarray(arr)
        if arr.ndim == 2 and arr.shape[0] == 6:  # (6, n) -> (n, 6)
            arr = arr.T
        out[k] = arr[..., None]
    return out


def so_stages(model: RobotModel, q, qd, qdd=None,
              gravity=DEFAULT_GRAVITY) -> Dict[str, np.ndarray]:
    """IDSVA-SO intermediates from the analytical route: forward kinematic
    quantities (v, a, psid, psidd, Sd), composite IC/BC/f, the T1-T4
    vectors, and the stacked output tensors. No independent oracle computes
    these stage for stage; localize numerical divergence by diffing against
    a float64 model's stages (``diff_stages(so_stages(m32, ...),
    so_stages(m64, ...))``)."""
    check_fixed_base(model, STAGES_FIXED_BASE)
    if qdd is None:
        qdd = torch.zeros_like(qd)
    _, st = idsva_so_analytical(model, q, qd, qdd, gravity,
                                return_stages=True)
    return _np_stages(st)


def print_stages(stages: Dict[str, np.ndarray], lane: int = 0,
                 precision: int = 4) -> None:
    """Render staged dumps in the reference's per-joint print style."""
    with np.printoptions(precision=precision, suppress=True, linewidth=100):
        for key, arr in stages.items():
            if arr.ndim >= 3:  # per joint
                for i in range(arr.shape[0]):
                    print(f"{key}[{i}] =")
                    print(arr[i, ..., lane])
            else:
                print(f"{key} =")
                print(arr[..., lane] if arr.ndim > 1 else arr)


def diff_stages(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
                atol: float = 1e-5, lane: int = 0) -> Dict[str, float]:
    """Max abs difference per stage; raises nothing — returns the report."""
    report = {}
    for key in a:
        if key not in b:
            continue
        xa = a[key][..., lane] if a[key].ndim > 1 else a[key]
        xb = b[key][..., lane] if b[key].ndim > 1 else b[key]
        xa, xb = np.broadcast_arrays(np.squeeze(xa), np.squeeze(xb))
        report[key] = float(np.abs(xa - xb).max())
    return report
