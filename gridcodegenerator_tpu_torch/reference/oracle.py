"""NumPy float64 oracle for every dynamics algorithm in the suite.

This is the framework's correctness anchor, mirroring the role of the
reference's ``_test.py`` validation layer (the reference repo's ``_test.py``,
the reference repo's ``README.md:59-66``) but written as free functions over a
:class:`RobotTopology` (no god-object mixins) and extended with ABA and CRBA
oracles, which the reference ships only as generated CUDA
(the reference repo's ``algorithms/_aba.py``, ``_crba.py``).

Semantics (identical to the reference oracle):
  * gravity enters as a fictitious base acceleration ``a_base = [0]*5 + [-GRAVITY]``
    with ``GRAVITY = -9.81`` by default (``_test.py:13-14``);
  * velocity damping adds ``damping_i * qd_i`` to joint force i (``_test.py:104-105``);
  * ``minv`` returns the symmetric-upper-triangular factorized inverse unless
    densified (``_test.py:204-226``);
  * ``rnea_grad`` returns ``dc_du = [dc/dq | dc/dqd]`` with damping on the
    diagonal of dc/dqd (``_test.py:486``).

Fixed-base only (floating base is handled in the JAX layer where the
quaternion chart is differentiable); the reference's oracle is likewise
fixed-base in practice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..topology.robot import RobotTopology
from .spatial_np import crf, crm, fxv, mxS

DEFAULT_GRAVITY = -9.81


def gravity_vec(GRAVITY: float = DEFAULT_GRAVITY) -> np.ndarray:
    g = np.zeros(6)
    g[5] = -GRAVITY
    return g


def _xmats(robot: RobotTopology, q: np.ndarray):
    return [robot.get_Xmat_Func_by_id(i)(q[i]) for i in range(robot.get_num_joints())]


# ---------------------------------------------------------------------------
# RNEA inverse dynamics
# ---------------------------------------------------------------------------

def rnea_fpass(robot, q, qd, qdd=None, GRAVITY=DEFAULT_GRAVITY):
    """Forward pass: velocities, accelerations, and per-body forces."""
    n = robot.get_num_joints()
    v = np.zeros((6, n))
    a = np.zeros((6, n))
    f = np.zeros((6, n))
    X = _xmats(robot, q)
    gvec = gravity_vec(GRAVITY)
    parent = robot.get_parent_id_array()
    for i in range(n):
        S = robot.get_S_by_id(i)
        p = parent[i]
        if p == -1:
            v[:, i] = S * qd[i]
            a[:, i] = X[i] @ gvec
        else:
            v[:, i] = X[i] @ v[:, p] + S * qd[i]
            a[:, i] = X[i] @ a[:, p] + mxS(S, v[:, i], qd[i])
        if qdd is not None:
            a[:, i] += S * qdd[i]
        I = robot.get_Imat_by_id(i)
        f[:, i] = I @ a[:, i] + fxv(v[:, i], I @ v[:, i])
    return v, a, f


def rnea_bpass(robot, q, qd, f):
    """Backward pass: joint torques + force accumulation up the tree."""
    n = robot.get_num_joints()
    c = np.zeros(n)
    f = f.copy()
    X = _xmats(robot, q)
    for i in range(n - 1, -1, -1):
        c[i] = robot.get_S_by_id(i) @ f[:, i]
        p = robot.get_parent_id(i)
        if p != -1:
            f[:, p] += X[i].T @ f[:, i]
    for i in range(n):
        c[i] += robot.get_damping_by_id(i) * qd[i]
    return c, f


def rnea(robot, q, qd, qdd=None, GRAVITY=DEFAULT_GRAVITY):
    v, a, f = rnea_fpass(robot, q, qd, qdd, GRAVITY)
    c, f = rnea_bpass(robot, q, qd, f)
    return c, v, a, f


# ---------------------------------------------------------------------------
# Direct Minv (Carpentier analytical inverse of the joint-space inertia matrix)
# ---------------------------------------------------------------------------

def minv(robot, q, output_dense: bool = True, return_stages: bool = False):
    """M(q)^-1 via the articulated-body factorized analytical inverse."""
    n = robot.get_num_joints()
    Minv = np.zeros((n, n))
    F = np.zeros((n, 6, n))
    U = np.zeros((n, 6))
    Dinv = np.zeros(n)
    IA = {i: robot.get_Imat_by_id(i) for i in range(n)}
    X = _xmats(robot, q)

    for i in range(n - 1, -1, -1):
        S = robot.get_S_by_id(i)
        U[i] = IA[i] @ S
        Dinv[i] = 1.0 / (S @ U[i])
        Minv[i, i] = Dinv[i]
        sub = robot.get_subtree_by_id(i)
        Minv[i, sub] -= Dinv[i] * (S @ F[i][:, sub])
        p = robot.get_parent_id(i)
        if p != -1:
            F[i][:, sub] += np.outer(U[i], Minv[i, sub])
            F[p][:, sub] += X[i].T @ F[i][:, sub]
            Ia = IA[i] - np.outer(U[i], Dinv[i] * U[i])
            IA[p] = IA[p] + X[i].T @ Ia @ X[i]

    # forward pass — serial over joints (growing column ranges)
    for i in range(n):
        p = robot.get_parent_id(i)
        S = robot.get_S_by_id(i)
        if p != -1:
            Minv[i, i:] -= Dinv[i] * (U[i] @ X[i]) @ F[p][:, i:]
        F[i][:, i:] = np.outer(S, Minv[i, i:])
        if p != -1:
            F[i][:, i:] += X[i] @ F[p][:, i:]

    if return_stages:
        # staged-dump hook (utils/debug.py; reference DEBUG sites
        # _direct_minv.py:72-79): per-pass U, Dinv, final F, upper factor
        Minv_upper = Minv.copy()
        iu = np.triu_indices(n, 1)
        Minv[(iu[1], iu[0])] = Minv[iu]
        return Minv, {"U": U, "Dinv": Dinv, "F": F,
                      "Minv_upper": Minv_upper, "Minv": Minv}
    if output_dense:
        iu = np.triu_indices(n, 1)
        Minv[(iu[1], iu[0])] = Minv[iu]
    return Minv


# ---------------------------------------------------------------------------
# CRBA mass matrix
# ---------------------------------------------------------------------------

def crba(robot, q):
    """Composite-rigid-body mass matrix M(q) (dense symmetric)."""
    n = robot.get_num_joints()
    X = _xmats(robot, q)
    Ic = [robot.get_Imat_by_id(i) for i in range(n)]
    M = np.zeros((n, n))
    for i in range(n - 1, -1, -1):
        p = robot.get_parent_id(i)
        if p != -1:
            Ic[p] = Ic[p] + X[i].T @ Ic[i] @ X[i]
    for i in range(n):
        S = robot.get_S_by_id(i)
        fh = Ic[i] @ S
        M[i, i] = S @ fh
        j = i
        while robot.get_parent_id(j) != -1:
            fh = X[j].T @ fh
            j = robot.get_parent_id(j)
            M[i, j] = M[j, i] = robot.get_S_by_id(j) @ fh
    return M


# ---------------------------------------------------------------------------
# Forward dynamics (Minv route and ABA route)
# ---------------------------------------------------------------------------

def forward_dynamics(robot, q, qd, u, GRAVITY=DEFAULT_GRAVITY):
    """qdd = Minv(q) (u - c(q, qd)); the reference FD composition
    (the reference repo's ``algorithms/_forward_dynamics.py:41-49``)."""
    c, _, _, _ = rnea(robot, q, qd, None, GRAVITY)
    return minv(robot, q, True) @ (u - c)


def aba(robot, q, qd, u, GRAVITY=DEFAULT_GRAVITY, return_stages=False):
    """Articulated-body algorithm forward dynamics (Featherstone ch. 7).

    Includes joint damping as an extra bias torque so that
    ``aba(q, qd, rnea(q, qd, qdd)) == qdd`` holds with damped joints.
    """
    n = robot.get_num_joints()
    X = _xmats(robot, q)
    parent = robot.get_parent_id_array()
    gvec = gravity_vec(GRAVITY)

    v = np.zeros((6, n))
    cbias = np.zeros((6, n))
    IA = [robot.get_Imat_by_id(i).copy() for i in range(n)]
    pA = np.zeros((6, n))
    for i in range(n):
        S = robot.get_S_by_id(i)
        p = parent[i]
        vJ = S * qd[i]
        v[:, i] = vJ if p == -1 else X[i] @ v[:, p] + vJ
        cbias[:, i] = crm(v[:, i]) @ vJ
        pA[:, i] = crf(v[:, i]) @ (IA[i] @ v[:, i])

    U = np.zeros((6, n))
    d = np.zeros(n)
    uu = np.zeros(n)
    tau_eff = u - np.array(
        [robot.get_damping_by_id(i) * qd[i] for i in range(n)])
    for i in range(n - 1, -1, -1):
        S = robot.get_S_by_id(i)
        U[:, i] = IA[i] @ S
        d[i] = S @ U[:, i]
        uu[i] = tau_eff[i] - S @ pA[:, i]
        p = parent[i]
        if p != -1:
            Ia = IA[i] - np.outer(U[:, i], U[:, i]) / d[i]
            pa = (pA[:, i] + Ia @ cbias[:, i] + U[:, i] * (uu[i] / d[i]))
            IA[p] = IA[p] + X[i].T @ Ia @ X[i]
            pA[:, p] += X[i].T @ pa

    a = np.zeros((6, n))
    qdd = np.zeros(n)
    for i in range(n):
        p = parent[i]
        a_p = X[i] @ (gvec if p == -1 else a[:, p]) + cbias[:, i]
        qdd[i] = (uu[i] - U[:, i] @ a_p) / d[i]
        a[:, i] = a_p + robot.get_S_by_id(i) * qdd[i]
    if return_stages:
        # staged-dump hook; pA/U/uu hold the post-backward accumulated values
        return qdd, {"v": v, "cbias": cbias, "pA": pA, "U": U,
                     "Dinv": 1.0 / d, "uu": uu, "a": a, "qdd": qdd}
    return qdd


# ---------------------------------------------------------------------------
# Analytical first-order gradients
# ---------------------------------------------------------------------------

def rnea_grad_inner(robot, q, qd, v, a, f, GRAVITY=DEFAULT_GRAVITY,
                    return_stages=False):
    """dc/dq, dc/dqd given RNEA intermediates (reference ``_test.py:229-488``).

    Dense (6, n, n) partials here — the oracle favors clarity; the TPU layer
    owns the ancestor/subtree sparsity compression.
    """
    n = robot.get_num_joints()
    X = _xmats(robot, q)
    parent = robot.get_parent_id_array()
    gvec = gravity_vec(GRAVITY)

    # temporaries
    Xv = np.zeros((6, n))
    Xa = np.zeros((6, n))
    Iv = np.zeros((6, n))
    MxXv = np.zeros((6, n))
    MxXa = np.zeros((6, n))
    Mxv = np.zeros((6, n))
    FxvI = np.zeros((n, 6, 6))
    for i in range(n):
        p = parent[i]
        I = robot.get_Imat_by_id(i)
        Xv[:, i] = 0.0 if p == -1 else X[i] @ v[:, p]
        Xa[:, i] = X[i] @ (gvec if p == -1 else a[:, p])
        Iv[:, i] = I @ v[:, i]
        S = robot.get_S_by_id(i)
        MxXv[:, i] = mxS(S, Xv[:, i])
        MxXa[:, i] = mxS(S, Xa[:, i])
        Mxv[:, i] = mxS(S, v[:, i])
        FxvI[i] = crf(v[:, i]) @ I

    dv_dq = np.zeros((6, n, n))
    dv_dqd = np.zeros((6, n, n))
    da_dq = np.zeros((6, n, n))
    da_dqd = np.zeros((6, n, n))
    df_dq = np.zeros((6, n, n))
    df_dqd = np.zeros((6, n, n))

    # forward: dv/du over ancestors+self
    for i in range(n):
        p = parent[i]
        S = robot.get_S_by_id(i)
        if p != -1:
            for col in robot.get_ancestors_by_id(i):
                dv_dq[:, col, i] = X[i] @ dv_dq[:, col, p]
                dv_dqd[:, col, i] = X[i] @ dv_dqd[:, col, p]
            dv_dq[:, i, i] += MxXv[:, i]
        dv_dqd[:, i, i] += S

    # da/du = mxS(dv/du) qd + {MxXa, Mxv} on the self column
    for i in range(n):
        S = robot.get_S_by_id(i)
        cols = robot.get_ancestors_by_id(i) + [i]
        for col in cols:
            da_dq[:, col, i] = mxS(S, dv_dq[:, col, i], qd[i])
            da_dqd[:, col, i] = mxS(S, dv_dqd[:, col, i], qd[i])
        da_dq[:, i, i] += MxXa[:, i]
        da_dqd[:, i, i] += Mxv[:, i]

    # da/du += X da_parent/du
    for i in range(n):
        p = parent[i]
        if p == -1:
            continue
        for col in robot.get_ancestors_by_id(i) + [i]:
            da_dq[:, col, i] += X[i] @ da_dq[:, col, p]
            da_dqd[:, col, i] += X[i] @ da_dqd[:, col, p]

    # df/du = crf(dv/du) Iv + I da/du + (crf(v) I) dv/du
    for i in range(n):
        I = robot.get_Imat_by_id(i)
        for col in robot.get_ancestors_by_id(i) + [i]:
            df_dq[:, col, i] = (crf(dv_dq[:, col, i]) @ Iv[:, i]
                                + I @ da_dq[:, col, i]
                                + FxvI[i] @ dv_dq[:, col, i])
            df_dqd[:, col, i] = (crf(dv_dqd[:, col, i]) @ Iv[:, i]
                                 + I @ da_dqd[:, col, i]
                                 + FxvI[i] @ dv_dqd[:, col, i])

    # backward: df_parent/du += X^T df/du plus the self-column correction
    # (dX_i/dq_i)^T f_i = X^T crf(S) f.  The reference computes this as
    # -X^T crm(f) S (``_test.py:433-437``), which equals X^T crf(S) f only for
    # revolute S; crf(S) f == icrf(f) S is the general identity, so prismatic
    # joints are handled correctly here (clean-semantics choice per SURVEY §7).
    Xmxf = np.zeros((6, n))
    for i in range(n):
        Xmxf[:, i] = X[i].T @ (crf(robot.get_S_by_id(i)) @ f[:, i])
    for i in range(n - 1, -1, -1):
        p = parent[i]
        if p == -1:
            continue
        cols = robot.get_ancestors_by_id(i) + robot.get_subtree_by_id(i)
        for col in cols:
            df_dq[:, col, p] += X[i].T @ df_dq[:, col, i]
            df_dqd[:, col, p] += X[i].T @ df_dqd[:, col, i]
            if col == i:
                df_dq[:, col, p] += Xmxf[:, i]

    # extract dc/du = S^T df/du (+ damping on the dqd diagonal)
    dc_dq = np.zeros((n, n))
    dc_dqd = np.zeros((n, n))
    for i in range(n):
        S = robot.get_S_by_id(i)
        for col in robot.get_ancestors_by_id(i) + robot.get_subtree_by_id(i):
            dc_dq[i, col] = S @ df_dq[:, col, i]
            dc_dqd[i, col] = S @ df_dqd[:, col, i]
        dc_dqd[i, i] += robot.get_damping_by_id(i)
    if return_stages:
        # staged-dump hook; df here is the accumulated (post-backward) form
        return dc_dq, dc_dqd, {
            "dv_dq": dv_dq, "dv_dqd": dv_dqd,
            "da_dq": da_dq, "da_dqd": da_dqd,
            "df_dq": df_dq, "df_dqd": df_dqd,
            "dc_du": np.hstack([dc_dq, dc_dqd]),
        }
    return dc_dq, dc_dqd


def rnea_grad(robot, q, qd, qdd=None, GRAVITY=DEFAULT_GRAVITY):
    """dc_du = [dc/dq | dc/dqd], shape (n, 2n)."""
    _, v, a, f = rnea(robot, q, qd, qdd, GRAVITY)
    dc_dq, dc_dqd = rnea_grad_inner(robot, q, qd, v, a, f, GRAVITY)
    return np.hstack([dc_dq, dc_dqd])


def fd_grad(robot, q, qd, u, GRAVITY=DEFAULT_GRAVITY):
    """df_du = -Minv @ dc_du at qdd = FD(q, qd, u); shape (n, 2n).

    The Carpentier identity dFD = -Minv dID (reference
    the reference repo's ``algorithms/_forward_dynamics_gradient.py:56-76``).
    """
    c, _, _, _ = rnea(robot, q, qd, None, GRAVITY)
    Mi = minv(robot, q, True)
    qdd = Mi @ (u - c)
    dc_du = rnea_grad(robot, q, qd, qdd, GRAVITY)
    return -Mi @ dc_du, qdd, Mi
