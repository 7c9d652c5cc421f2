"""The knot-sharded Riccati reduce: the LQR backward pass over ranks.

The counterpart of ``gridcodegenerator_tpu/parallel/knot_riccati.py``. The
horizon (knot) axis is split over a mesh axis of D ranks, N/D knots each.
Every rank forms its knots' conditional-value elements
(``trajopt/priccati.py``) and runs a local associative suffix scan; the
chunk aggregates are reduced over the ranks in ceil(log2 D) point-to-point
rounds (a reverse Hillis-Steele scan over the axis), and each rank then
finishes its local suffixes and gains on its own. Sequential depth:
O(log N/D + log D) instead of N. Plain torch on every device, as the JAX
reduce is XLA (``lax.associative_scan``, ``ppermute``).

Two entry points:

* :func:`local_knot_gains`: one rank's part, for a caller that holds its
  knot chunk (the knot-sharded backward of ``trajopt/ilqr.py``);
* :func:`sharded_lqr_gains`: the same over full knot stacks that every
  rank holds: it takes this rank's chunk and gathers the gains.

Where ``jax.lax.ppermute`` delivers zeros to a device with no source (and
the JAX body keeps that device's aggregate), a rank here receives nothing
and keeps its own: the same values with no zero element in between.
"""

from __future__ import annotations

import torch

from ..ops.common import eye_b
from ..ops.linalg import gj_inverse
from ..ops.spatial import bmm, bmv
from ..trajopt.priccati import (_combine, associative_scan, stage_elements,
                                terminal_element)
from .collectives import all_gather, ppermute
from .mesh import AxisGroup, Mesh


def local_knot_gains(group: AxisGroup, D: int, reg: float,
                     Amat, Bmat, lx, lu, lxx, luu, lux, VxN, VxxN):
    """One rank's part of the knot-sharded Riccati reduce.

    ``group`` is the knot axis (``Mesh.axis("kp")``) of size ``D``. The
    inputs are this rank's knot chunk (leading axis N/D: rank d holds
    knots [d N/D, (d+1) N/D)), knot-stacked and batch-trailing as in
    ``priccati.suffix_value_functions``; ``VxN``/``VxxN`` (the terminal
    expansion, (nx, B) and (nx, nx, B)) are the same on every rank.
    Returns the chunk's gains ``(ks (N/D, nu, B), Ks (N/D, nu, nx, B))``,
    knot-major and contiguous.

    ``reg`` enters the gain solves alone; the value propagation uses the
    exact elements, so the sweep matches a sequential Riccati recursion to
    O(reg^2)."""
    if group.size != D:
        raise ValueError(f"a knot axis of {group.size} ranks, not {D}")
    nu = Bmat.shape[2]
    B = Amat.shape[-1]

    def last(t):            # the knot axis to the last batch axis
        return t.movedim(0, -1)

    A, Bm, lu_l, luu_l, lux_l = map(last, (Amat, Bmat, lu, luu, lux))
    elems = stage_elements(A, Bm, last(lx), lu_l, last(lxx), luu_l, lux_l)
    # the local inclusive suffix scan: the flipped knots, later first
    flipped = [e.flip(-1) for e in elems]
    suffix = [e.flip(-1) for e in associative_scan(
        lambda late, early: _combine(early, late), flipped)]
    agg = tuple(e[..., 0] for e in suffix)      # the whole chunk
    terminal = terminal_element(VxN.expand(-1, B),
                                VxxN.expand(-1, -1, B))
    d = group.index
    is_last = d == D - 1
    if is_last:
        agg = _combine(agg, terminal)

    # the reverse Hillis-Steele inclusive scan over the axis
    x, k = agg, 1
    while k < D:
        y = ppermute(x, group, k)
        if y is not None:                       # d + k <= D - 1
            x = _combine(x, y)
        k *= 2
    # the exclusive aggregate from the right: r_d = x_{d+1}, the terminal
    # at the end
    r = ppermute(x, group, 1) if D > 1 else None
    if r is None:
        r = terminal

    sg = _combine(suffix, tuple(e[..., None] for e in r))
    Vx = torch.cat([-sg[3][..., 1:], -r[3][..., None]], dim=-1)
    Vxx = torch.cat([sg[4][..., 1:], r[4][..., None]], dim=-1)
    Bt = Bm.transpose(0, 1)
    Qu = lu_l + bmv(Bt, Vx)
    BtV = bmm(Bt, Vxx)
    Qux = lux_l + bmm(BtV, A)
    Quu = luu_l + bmm(BtV, Bm)
    Quu_inv = gj_inverse(Quu + reg * eye_b(nu, Quu))
    return ((-bmv(Quu_inv, Qu)).movedim(-1, 0).contiguous(),
            (-bmm(Quu_inv, Qux)).movedim(-1, 0).contiguous())


def sharded_lqr_gains(mesh: Mesh, axis_name: str = "kp", reg: float = 0.0):
    """Build gains(Amat, Bmat, lx, lu, lxx, luu, lux, VxN, VxxN) -> (ks,
    Ks) over the knot axis ``axis_name`` of ``mesh``.

    Every rank passes the full knot stacks (shapes as in
    ``priccati.suffix_value_functions``); each reduces its own N/D knots
    with :func:`local_knot_gains` and every rank gets the gathered
    ``(ks (N, nu, B), Ks (N, nu, nx, B))``."""
    group = mesh.axis(axis_name)
    D = group.size

    def gains(*args):
        N = args[0].shape[0]
        if N % D != 0:
            raise ValueError(f"knot count {N} must be divisible by mesh "
                             f"axis '{axis_name}' size {D}")
        n_loc = N // D
        chunk = [a[group.index * n_loc:(group.index + 1) * n_loc]
                 for a in args[:7]]
        ks, Ks = local_knot_gains(group, D, reg, *chunk, *args[7:])
        return all_gather(ks, group, 0), all_gather(Ks, group, 0)

    return gains
