"""The LQR backward pass as an associative suffix scan (plain torch).

The counterpart of ``gridcodegenerator_tpu/trajopt/priccati.py``. The
sequential Riccati recursion has depth N; this module writes the value
recursion as an associative suffix scan over conditional value-function
elements (the parallel LQT construction of Särkkä and García-Fernández,
"Temporal Parallelization of Dynamic Programming and Linear Quadratic
Tracking"), whose depth is logarithmic in N at about twice the operations.

Element e = (A, b, C, eta, J) encodes the conditional value function between
two knots. The stage element of an LQR stage with cross and linear cost
terms follows by completing the square in u:

    U = luu + reg I,  A~ = A - B U^-1 lux,      b = -B U^-1 lu,
    C = B U^-1 B',    J = lxx - lux' U^-1 lux,  eta = -(lx - lux' U^-1 lu)

and the terminal element is (0, 0, 0, -VxN, VxxN). The inclusive suffix scan
gives V_t(dx) = 1/2 dx' J_t dx - eta_t' dx at every knot.

The scan is ``jax.lax.associative_scan(..., reverse=True)``'s odd/even
recursion, each of its rounds one batched ``_combine`` over every pair it
joins: the knot axis rides as the last batch axis of every element, so a
round is a handful of batched contractions whatever the number of pairs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..ops.common import eye_b
from ..ops.linalg import gj_inverse
from ..ops.spatial import bmm, bmv

Elem = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
             torch.Tensor]


def _combine(e_early: Sequence[torch.Tensor],
             e_late: Sequence[torch.Tensor]) -> Elem:
    """Associative combination of two conditional-value elements, each
    batch-trailing: matrices (nx, nx, B...), vectors (nx, B...)."""
    A1, b1, C1, n1, J1 = e_early
    A2, b2, C2, n2, J2 = e_late
    I = eye_b(A1.shape[0], A1)
    M = gj_inverse(I + bmm(C1, J2))           # (I + C1 J2)^-1
    Nt = gj_inverse(I + bmm(J2, C1))          # (I + J2 C1)^-1
    A1T = A1.transpose(0, 1)
    A2M = bmm(A2, M)
    A12 = bmm(A2M, A1)
    b12 = bmv(A2M, b1 + bmv(C1, n2)) + b2
    C12 = bmm(bmm(A2M, C1), A2.transpose(0, 1)) + C2
    n12 = bmv(A1T, bmv(Nt, n2 - bmv(J2, b1))) + n1
    J12 = bmm(A1T, bmm(Nt, bmm(J2, A1))) + J1
    return (A12, b12, C12, n12, J12)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along the last axis (len(a) is len(b)
    or len(b) + 1)."""
    out = torch.empty(a.shape[:-1] + (a.shape[-1] + b.shape[-1],),
                      dtype=a.dtype, device=a.device)
    out[..., 0::2] = a
    out[..., 1::2] = b
    return out


def associative_scan(fn, elems: Sequence[torch.Tensor],
                     rounds: List[int] = None) -> List[torch.Tensor]:
    """Inclusive scan of ``fn`` over the last axis of every tensor of
    ``elems``: out[k] = fn(... fn(elems[0], elems[1]) ..., elems[k]).

    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    the half-length result, then combine its odd prefixes with the even
    elements. ``rounds``, if given, is appended one entry (the pairs
    joined) for each batched ``fn`` call."""
    n = elems[0].shape[-1]
    if n < 2:
        return list(elems)

    def call(a, b):
        if rounds is not None:
            rounds.append(a[0].shape[-1])
        return fn(a, b)

    reduced = call([e[..., 0:n - 1:2] for e in elems],
                   [e[..., 1::2] for e in elems])
    odd = associative_scan(fn, reduced, rounds)
    if n % 2 == 0:
        left = [e[..., :-1] for e in odd]
    else:
        left = odd
    tail = [e[..., 2::2] for e in elems]
    if tail[0].shape[-1]:
        even = call(left, tail)
        even = [torch.cat([e[..., :1], r], dim=-1)
                for e, r in zip(elems, even)]
    else:
        even = [e[..., :1] for e in elems]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def stage_elements(A, Bm, lx, lu, lxx, luu, lux, reg: float = 0.0) -> Elem:
    """The stage elements of knots on the last batch axis: ``A (nx, nx,
    B..., N)``, ``Bm (nx, nu, B..., N)``, ``lx (nx, B..., N)`` and so on,
    with U = luu + reg I."""
    Uinv = gj_inverse(luu + reg * eye_b(luu.shape[0], luu))
    UiW = bmm(Uinv, lux)                      # (nu, nx, B, N)
    Uilu = bmv(Uinv, lu)                      # (nu, B, N)
    WT = lux.transpose(0, 1)
    return (A - bmm(Bm, UiW), -bmv(Bm, Uilu),
            bmm(Bm, bmm(Uinv, Bm.transpose(0, 1))),
            -(lx - bmv(WT, Uilu)), lxx - bmm(WT, UiW))


def terminal_element(VxN, VxxN) -> Elem:
    """(0, 0, 0, -VxN, VxxN): the terminal value as an element."""
    zM = torch.zeros_like(VxxN)
    return (zM, torch.zeros_like(VxN), zM, -VxN, VxxN)


def suffix_value_functions(Amat, Bmat, lx, lu, lxx, luu, lux, VxN, VxxN,
                           reg: float = 0.0):
    """Every knot's value function from one associative suffix scan.

    Knot-stacked, batch-trailing inputs: ``Amat (N, nx, nx, B)``,
    ``Bmat (N, nx, nu, B)``, ``lx (N, nx, B)``, ``lu (N, nu, B)``,
    ``lxx (N, nx, nx, B)``, ``luu (N, nu, nu, B)``, ``lux (N, nu, nx, B)``;
    terminal ``VxN (nx, B)``, ``VxxN (nx, nx, B)``. Returns ``(Vx, Vxx)``,
    ``(N+1, nx, B)`` and ``(N+1, nx, nx, B)`` (index N the terminal).

    ``reg`` enters the value propagation (U = luu + reg I in every
    element), unlike a sequential sweep that regularizes only its gain
    solves: the solver passes 0 and regularizes its gain solves alone.
    """
    def last(t):            # the knot axis to the last batch axis
        return t.movedim(0, -1)

    stage = stage_elements(*map(last, (Amat, Bmat, lx, lu, lxx, luu, lux)),
                           reg)
    terminal = terminal_element(VxN, VxxN)
    elems = [torch.cat([s, t[..., None].to(s.dtype)], dim=-1)
             for s, t in zip(stage, terminal)]
    # reverse: scan the flipped knots with the later element first
    flipped = [e.flip(-1) for e in elems]
    suff = associative_scan(lambda late, early: _combine(early, late),
                            flipped)
    eta, J = suff[3].flip(-1), suff[4].flip(-1)
    return -eta.movedim(-1, 0), J.movedim(-1, 0)
