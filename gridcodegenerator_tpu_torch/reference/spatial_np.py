"""Scalar spatial-algebra helpers for the NumPy oracle (float64).

Semantics match the reference's validation helpers
(the reference repo's ``_test.py:522-681``): 6-vectors are ``[angular; linear]``,
``crm(v)`` is the motion cross-product matrix, ``crf(v) = -crm(v)^T`` the force
one. Implemented here from the standard Featherstone definitions rather than
per-index unrolls — the oracle is clarity-first; speed lives in the TPU layer.
"""

from __future__ import annotations

import numpy as np


def crm(v: np.ndarray) -> np.ndarray:
    """6x6 motion cross-product matrix: crm(v) @ m == v x m (motion)."""
    w, l = v[:3], v[3:]
    wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                  dtype=np.float64)
    lx = np.array([[0, -l[2], l[1]], [l[2], 0, -l[0]], [-l[1], l[0], 0]],
                  dtype=np.float64)
    M = np.zeros((6, 6))
    M[:3, :3] = wx
    M[3:, :3] = lx
    M[3:, 3:] = wx
    return M


def crf(v: np.ndarray) -> np.ndarray:
    """6x6 force cross-product matrix: crf(v) = -crm(v)^T."""
    return -crm(v).T


def mxS(S: np.ndarray, v: np.ndarray, alpha: float = 1.0) -> np.ndarray:
    """crm(v) @ (S * alpha): the velocity-product term for one-hot S."""
    return crm(v) @ (np.asarray(S, dtype=np.float64) * alpha)


def fxv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """crf(a) @ b."""
    return crf(a) @ b


def mxv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """crm(a) @ b."""
    return crm(a) @ b


def icrf(v: np.ndarray) -> np.ndarray:
    """Inverse-force-cross operator: icrf(f) such that icrf(f) @ v == crf(v) @ f.

    Used by the second-order (IDSVA) derivations
    (cf. the reference repo's ``helpers/_spatial_algebra_helpers.py:392-450``).
    """
    w, l = v[:3], v[3:]
    wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                  dtype=np.float64)
    lx = np.array([[0, -l[2], l[1]], [l[2], 0, -l[0]], [-l[1], l[0], 0]],
                  dtype=np.float64)
    M = np.zeros((6, 6))
    M[:3, :3] = wx
    M[:3, 3:] = lx
    M[3:, :3] = lx
    return -M
