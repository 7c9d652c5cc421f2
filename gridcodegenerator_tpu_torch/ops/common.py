"""Shared helpers for the batched (trailing-axis) algorithm implementations."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..models.model import RobotModel

DEFAULT_GRAVITY = -9.81


def check_fixed_base(model: RobotModel, why: str):
    """Raise ``NotImplementedError(why)`` for a floating-base model where
    the caller needs a fixed base (the second-order tensors, the solvers'
    [q; qd] state, the staged dumps)."""
    if model.floating_base:
        raise NotImplementedError(why)


def vel_layout(model: RobotModel) -> List[Tuple[int, int]]:
    """Per joint (velocity offset, dof): dof 6 for the floating joint."""
    out, off = [], 0
    for i in range(model.n):
        d = 6 if model.jtype[i] == "floating" else 1
        out.append((off, d))
        off += d
    return out


def pos_layout(model: RobotModel) -> List[Tuple[int, int]]:
    """Per joint (position offset, coordinates): 7 for the floating joint
    ([x, y, z, qx, qy, qz, qw])."""
    out, off = [], 0
    for i in range(model.n):
        k = 7 if model.jtype[i] == "floating" else 1
        out.append((off, k))
        off += k
    return out


def S_matrix(model: RobotModel, i: int) -> np.ndarray:
    """Constant (6, dof) motion subspace of joint i."""
    if model.jtype[i] == "floating":
        return np.eye(6)
    S = np.zeros((6, 1))
    S[model.S_ind[i], 0] = 1.0
    return S


def gravity_accel(gravity: float, like: torch.Tensor) -> torch.Tensor:
    """The fictitious base acceleration [0,0,0,0,0,-gravity] as a (6, 1...)
    column that broadcasts over the trailing batch shape of ``like``."""
    g = torch.zeros((6,) + (1,) * (like.ndim - 1), dtype=like.dtype,
                    device=like.device)
    g[5] = -gravity
    return g


def e_vec(k: int, x: torch.Tensor) -> torch.Tensor:
    """(6, B...) tensor equal to e_k * x for x of shape (B...)."""
    out = torch.zeros((6,) + x.shape, dtype=x.dtype, device=x.device)
    out[k] = x
    return out


def eye_b(m: int, like: torch.Tensor) -> torch.Tensor:
    """(m, m, 1...) identity that broadcasts over the trailing batch of
    ``like`` (whose first two dims are the matrix dims)."""
    return torch.eye(m, dtype=like.dtype, device=like.device).reshape(
        (m, m) + (1,) * (like.ndim - 2))
