"""Whole-horizon sweeps of the iLQR solver: CUDA kernels and plain versions.

* ``rollout`` — open-loop N-step rollout with the control clamp.
  Replaces ``gridcodegenerator_tpu/ops/pallas/sweeps.py:rollout_pallas``.
* ``feedback_rollout`` — closed-loop N-step rollout of one step size, the
  step size folded into the feedforward term. Replaces
  ``sweeps.py:feedback_rollout_pallas``.
* ``linesearch_rollout`` — feedback rollouts for every step size at once,
  with the cost (EE reach or quadratic) summed inside the sweep, or with
  no cost (``cost=None``: the solver sums a cost that is not
  time-invariant over the rollouts itself). Replaces
  ``sweeps.py:linesearch_rollout_pallas`` (without ``cost_consts``: the
  no-cost instance).
* ``riccati_factored`` — the backward Riccati sweep fed by the Gauss-Newton
  factor of the cost. Replaces ``sweeps.py:riccati_pallas_factored``.
* ``riccati`` — the backward Riccati sweep with dense curvature blocks, per
  knot or one stationary block. Replaces ``sweeps.py:riccati_pallas``.

Both Riccati sweeps run the same knot step (:func:`riccati_knot` here;
``csrc/sweep_warp.cuh:riccati_knot_warp`` in both kernels, the curvature an
input policy: the factor, dense blocks per knot, or one stationary block
staged once).

On the TPU the horizon was a sequential grid axis carrying state in VMEM
scratch from one grid step to the next. Blocks on the GPU run in no order,
so each kernel runs the whole horizon loop inside a block.
``riccati_factored`` and ``riccati`` run a warp per problem,
``linesearch_rollout``, ``rollout`` and ``feedback_rollout`` a group of
threads per rollout on one step program (``csrc/sweep_warp.cuh``; the
rollout's control law is u = clamp(U_t), the feedback rollout's the line
search's at a step size of 1, and neither sums a cost), their state in
shared memory; the block stages each knot's inputs for G consecutive
problems with cp.async while the knot before is computed.

Integrator: semi-implicit Euler — qd' = qd + dt*qdd, q' = q + dt*qd'.
A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises (a plan that holds no problem or rollout is refused before the
launch: ``build.fits``). Where a Riccati problem does not fit a block
(from 30 to 48 joints, by curvature and dtype) it runs on the device-memory
route, a problem a block, its state in a workspace sized by the blocks in
flight (``build.workspace``); where a rollout block's tiles do not fit (the
line search and the feedback rollout above 52 joints in float64),
the tiles go there.
"""

from __future__ import annotations

import torch

from ...models.model import RobotModel
from ..aba import aba
from ..common import DEFAULT_GRAVITY
from ..linalg import gj_inverse
from ..spatial import bmm, bmv
from . import build

ROLLOUT = "rollout"
FEEDBACK = "feedback_rollout"
LINESEARCH = "linesearch_rollout"
# the line search's no-cost instance: counted apart from the instances with
# an in-kernel cost
LINESEARCH_NOCOST = "linesearch_nocost"
RICCATI = "riccati_factored"
RICCATI_DENSE = "riccati"
SOURCES = {ROLLOUT: "gridcodegenerator_tpu_torch/csrc/rollout.cu",
           FEEDBACK: "gridcodegenerator_tpu_torch/csrc/feedback_rollout.cu",
           LINESEARCH: "gridcodegenerator_tpu_torch/csrc/linesearch.cu",
           LINESEARCH_NOCOST:
               "gridcodegenerator_tpu_torch/csrc/linesearch.cu",
           RICCATI: "gridcodegenerator_tpu_torch/csrc/riccati.cu",
           RICCATI_DENSE: "gridcodegenerator_tpu_torch/csrc/riccati.cu"}
REPLACES = {ROLLOUT: "gridcodegenerator_tpu/ops/pallas/sweeps.py:406",
            FEEDBACK: "gridcodegenerator_tpu/ops/pallas/sweeps.py:440",
            LINESEARCH: "gridcodegenerator_tpu/ops/pallas/sweeps.py:486",
            LINESEARCH_NOCOST: "gridcodegenerator_tpu/ops/pallas/sweeps.py:486",
            RICCATI: "gridcodegenerator_tpu/ops/pallas/sweeps.py:267",
            RICCATI_DENSE: "gridcodegenerator_tpu/ops/pallas/sweeps.py:689"}
# the line-search kernel's cost kinds (csrc/linesearch.cu); "none": no cost
COST_KINDS = {"ee": 0, "quad": 1, "none": 2}


def euler_step(model: RobotModel, x, u, dt, gravity=DEFAULT_GRAVITY):
    """Semi-implicit Euler step on x = [q; qd] (2n, B...)."""
    n = model.num_vel
    q, qd = x[:n], x[n:]
    qd_new = qd + dt * aba(model, q, qd, u, gravity)
    return torch.cat([q + dt * qd_new, qd_new], dim=0)


def _clamp(u, u_lo, u_hi):
    if u_lo is None and u_hi is None:
        return u
    return torch.clamp(u, u_lo, u_hi)


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------

def rollout_plain(model: RobotModel, x0, U, dt, gravity=DEFAULT_GRAVITY,
                  u_lo=None, u_hi=None):
    """(x0 (nx,B), U (N,n,B)) -> X (N,nx,B), the state after each step."""
    build.PLAIN_CALLS[ROLLOUT] += 1
    xs, x = [], x0
    for t in range(U.shape[0]):
        x = euler_step(model, x, _clamp(U[t], u_lo, u_hi), dt, gravity)
        xs.append(x)
    return torch.stack(xs)


def rollout(model: RobotModel, x0, U, dt, gravity=DEFAULT_GRAVITY,
            u_lo=None, u_hi=None):
    if not x0.is_cuda:
        return rollout_plain(model, x0, U, dt, gravity, u_lo, u_hi)
    dcode, nj = build.kernel_key(model, x0, ROLLOUT)
    build.fits(ROLLOUT, nj, x0.dtype)
    n, nx = model.n, 2 * model.n
    N, B = U.shape[0], x0.shape[-1]
    if x0.shape != (nx, B) or U.shape != (N, n, B):
        raise ValueError(f"{ROLLOUT}: bad shapes {tuple(x0.shape)}, "
                         f"{tuple(U.shape)}")
    build.require(dict(x0=x0, U=U, u_lo=u_lo, u_hi=u_hi), x0.dtype,
                  x0.device, ROLLOUT)
    X = torch.empty((N, nx, B), dtype=x0.dtype, device=x0.device)
    err = build.lib(nj).gridtorch_rollout(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(x0),
        build.ptr(U), build.ptr(u_lo), build.ptr(u_hi), build.ptr(X), N, B,
        float(dt), float(gravity), build.stream_ptr(x0.device))
    build.check(err, ROLLOUT)
    build.LAUNCHES[ROLLOUT] += 1
    return X


# ---------------------------------------------------------------------------
# feedback rollout
# ---------------------------------------------------------------------------

def feedback_rollout_plain(model: RobotModel, x0, Uref, Xref, kff, K, dt,
                           gravity=DEFAULT_GRAVITY, u_lo=None, u_hi=None):
    """(x0 (nx,B), Uref (N,n,B), Xref (N,nx,B), kff (N,n,B), K (N,n,nx,B))
    -> (X (N,nx,B), U (N,n,B)): u_t = clamp(Uref_t + kff_t + K_t (x_t -
    Xref_t)), X the state after each step, U the clamped controls."""
    build.PLAIN_CALLS[FEEDBACK] += 1
    xs, us, x = [], [], x0
    for t in range(Uref.shape[0]):
        u = _clamp(Uref[t] + (kff[t] + bmv(K[t], x - Xref[t])), u_lo, u_hi)
        x = euler_step(model, x, u, dt, gravity)
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.stack(us)


def feedback_rollout(model: RobotModel, x0, Uref, Xref, kff, K, dt,
                     gravity=DEFAULT_GRAVITY, u_lo=None, u_hi=None):
    if not x0.is_cuda:
        return feedback_rollout_plain(model, x0, Uref, Xref, kff, K, dt,
                                      gravity, u_lo, u_hi)
    dcode, nj = build.kernel_key(model, x0, FEEDBACK)
    build.fits(FEEDBACK, nj, x0.dtype)
    n, nx = model.n, 2 * model.n
    N, B = Uref.shape[0], x0.shape[-1]
    given = dict(x0=x0, Uref=Uref, Xref=Xref, kff=kff, K=K)
    _check_shapes(FEEDBACK, dict(x0=(nx, B), Uref=(N, n, B), Xref=(N, nx, B),
                                 kff=(N, n, B), K=(N, n, nx, B)), given)
    build.require(dict(given, u_lo=u_lo, u_hi=u_hi), x0.dtype, x0.device,
                  FEEDBACK)
    X = torch.empty((N, nx, B), dtype=x0.dtype, device=x0.device)
    U = torch.empty((N, n, B), dtype=x0.dtype, device=x0.device)
    # a workspace where the tiles sit in device memory: a block a group of
    # G problems at most
    groups = -(-B // build.plan(FEEDBACK, nj, x0.dtype)["knots_per_block"])
    ws, nws = build.workspace(FEEDBACK, nj, x0, groups)
    err = build.lib(nj).gridtorch_feedback_rollout(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(x0),
        build.ptr(Uref), build.ptr(Xref), build.ptr(kff), build.ptr(K),
        build.ptr(u_lo), build.ptr(u_hi), build.ptr(X), build.ptr(U), N, B,
        float(dt), float(gravity), build.stream_ptr(x0.device),
        build.ptr(ws), nws)
    build.check(err, FEEDBACK)
    build.LAUNCHES[FEEDBACK] += 1
    return X, U


# ---------------------------------------------------------------------------
# line-search rollout
# ---------------------------------------------------------------------------

def linesearch_rollout_plain(model: RobotModel, x0, Uref, Xref, k, K,
                             alpha_rows, dt, gravity, u_lo, u_hi, cost):
    """Feedback rollouts for every row of ``alpha_rows`` (na, B):

    u_t = clamp(Uref_t + alpha * k_t + K_t (x_t - Xref_t)), lanes
    alpha-major ([a0*B | a1*B | ...]) -> (X (N,nx,na*B), U (N,n,na*B),
    cost (na*B)). ``cost`` (an ``EEReachCost`` or a ``QuadCost``) is summed
    along the sweep: ``ls_stage`` at each knot, ``ls_terminal`` at the
    end; with ``cost=None`` nothing is summed and the cost is None.
    """
    build.PLAIN_CALLS[LINESEARCH if cost is not None
                      else LINESEARCH_NOCOST] += 1
    na = alpha_rows.shape[0]

    def widen(z):
        return z.repeat((1,) * (z.ndim - 1) + (na,))

    alpha = alpha_rows.reshape(-1)
    x = widen(x0)
    acc = torch.zeros_like(x[0])
    xs, us = [], []
    for t in range(Uref.shape[0]):
        du = alpha * widen(k[t]) + bmv(widen(K[t]), x - widen(Xref[t]))
        u = _clamp(widen(Uref[t]) + du, u_lo, u_hi)
        if cost is not None:
            acc = acc + cost.ls_stage(x, u)
        x = euler_step(model, x, u, dt, gravity)
        xs.append(x)
        us.append(u)
    if cost is None:
        return torch.stack(xs), torch.stack(us), None
    return torch.stack(xs), torch.stack(us), acc + cost.ls_terminal(x)


def linesearch_rollout(model: RobotModel, x0, Uref, Xref, k, K, alpha_rows,
                       dt, gravity, u_lo, u_hi, cost):
    if not x0.is_cuda:
        return linesearch_rollout_plain(model, x0, Uref, Xref, k, K,
                                        alpha_rows, dt, gravity, u_lo, u_hi,
                                        cost)
    what = LINESEARCH if cost is not None else LINESEARCH_NOCOST
    dcode, nj = build.kernel_key(model, x0, what)
    build.fits("linesearch", nj, x0.dtype, what)
    n, nx = model.n, 2 * model.n
    N, B = Uref.shape[0], x0.shape[-1]
    na = alpha_rows.shape[0]
    expect = dict(x0=(nx, B), Uref=(N, n, B), Xref=(N, nx, B), k=(N, n, B),
                  K=(N, n, nx, B), alpha_rows=(na, B))
    given = dict(x0=x0, Uref=Uref, Xref=Xref, k=k, K=K, alpha_rows=alpha_rows)
    _check_shapes(what, expect, given)
    build.require(dict(given, u_lo=u_lo, u_hi=u_hi), x0.dtype, x0.device,
                  what)
    dev, dt_ = x0.device, x0.dtype
    X = torch.empty((N, nx, na * B), dtype=dt_, device=dev)
    U = torch.empty((N, n, na * B), dtype=dt_, device=dev)
    kind, ee, c, cbuf = COST_KINDS["none"], 0, None, None
    if cost is not None:
        w = cost.kernel_weights
        if w is None or w["kind"] not in COST_KINDS:
            raise NotImplementedError(
                f"{LINESEARCH}: no kernel cost for {type(cost).__name__}"
                + ("" if w is None else f" (kind {w['kind']!r})"))
        kind, ee = COST_KINDS[w["kind"]], w["ee_index"]
        c = torch.empty((na * B,), dtype=dt_, device=dev)
        cbuf = build.cost_buffer(cost, x0)
    # a workspace where the tiles sit in device memory: the grid's blocks at
    # most, a block of G problems for each step size
    blocks = -(-B // build.plan("linesearch", nj, dt_)["knots_per_block"]) * na
    ws, nws = build.workspace("linesearch", nj, x0, blocks)
    err = build.lib(nj).gridtorch_linesearch(
        dcode, nj, build.ptr(build.model_buffer(model, ee)),
        build.ptr(x0), build.ptr(Uref),
        build.ptr(Xref), build.ptr(k), build.ptr(K), build.ptr(alpha_rows),
        build.ptr(u_lo), build.ptr(u_hi), build.ptr(X), build.ptr(U),
        build.ptr(c), N, B, na, float(dt), float(gravity), kind,
        build.ptr(cbuf), build.stream_ptr(dev), build.ptr(ws), nws)
    build.check(err, what)
    build.LAUNCHES[what] += 1
    return X, U, c


# ---------------------------------------------------------------------------
# Riccati sweeps
# ---------------------------------------------------------------------------

def riccati_knot(At, Bt, Vx, Vxx, lx, lu, lxx, luu, lux, reg, dQxx=None,
                 dQux=None):
    """One backward knot: Q assembly, gains from Gauss-Jordan on
    Quu + reg I, and the FULL value update (it cancels the regularization
    to O(reg^2)), symmetrized. ``dQxx``/``dQux`` are added to Qxx/Qux
    before the gains (the second-order DDP terms).
    -> (k (n,B), K (n,nx,B), Vx (nx,B), Vxx (nx,nx,B))."""
    n = Bt.shape[1]
    AT, BT = At.transpose(0, 1), Bt.transpose(0, 1)
    Qx = lx + bmv(AT, Vx)
    Qu = lu + bmv(BT, Vx)
    VxxA = bmm(Vxx, At)
    Qxx = lxx + bmm(AT, VxxA)
    Qux = lux + bmm(BT, VxxA)
    Quu = luu + bmm(BT, bmm(Vxx, Bt))
    if dQxx is not None:
        Qxx = Qxx + dQxx
        Qux = Qux + dQux
    eye_n = torch.eye(n, dtype=At.dtype, device=At.device)[:, :, None]
    Quu_inv = gj_inverse(Quu + reg * eye_n)
    k_t = -bmv(Quu_inv, Qu)
    K_t = -bmm(Quu_inv, Qux)
    KT, QuxT = K_t.transpose(0, 1), Qux.transpose(0, 1)
    Vx = Qx + bmv(KT, bmv(Quu, k_t)) + bmv(KT, Qu) + bmv(QuxT, k_t)
    Vxx = Qxx + bmm(KT, bmm(Quu, K_t)) + bmm(KT, Qux) + bmm(QuxT, K_t)
    return k_t, K_t, Vx, 0.5 * (Vxx + Vxx.transpose(0, 1))


def riccati_factored_plain(A, Bm, lx, lu, Jw, Vx0, Vxx0, reg, qd_diag,
                           u_diag):
    """Backward Riccati sweep with lxx = blkdiag(Jw^T Jw, qd_diag*I),
    luu = u_diag*I, lux = 0.

    A (N,nx,nx,B), Bm (N,nx,n,B), Vx0 (nx,B), Vxx0 (nx,nx,B); lx (nx,N*B),
    lu (n,N*B) and Jw (r,n,N*B) in the solver's knot-major lane layout
    (lane = t*B + b). -> (k (N,n,B), K (N,n,nx,B)).
    """
    build.PLAIN_CALLS[RICCATI] += 1
    N, nx, n, B = Bm.shape
    eye_n = torch.eye(n, dtype=A.dtype, device=A.device)[:, :, None]
    qd_eye = torch.zeros((nx, nx, 1), dtype=A.dtype, device=A.device)
    qd_eye[n:, n:] = eye_n
    lux = torch.zeros((n, nx, 1), dtype=A.dtype, device=A.device)
    Vx, Vxx = Vx0, Vxx0
    ks, Ks = [None] * N, [None] * N
    for t in range(N - 1, -1, -1):
        lane = slice(t * B, (t + 1) * B)
        Jt = Jw[:, :, lane]
        lxx = qd_diag * qd_eye + torch.zeros_like(Vxx)
        lxx[:n, :n] = lxx[:n, :n] + bmm(Jt.transpose(0, 1), Jt)
        ks[t], Ks[t], Vx, Vxx = riccati_knot(
            A[t], Bm[t], Vx, Vxx, lx[:, lane], lu[:, lane], lxx,
            u_diag * eye_n, lux, reg)
    return torch.stack(ks), torch.stack(Ks)


def riccati_factored(A, Bm, lx, lu, Jw, Vx0, Vxx0, reg, qd_diag, u_diag):
    if not A.is_cuda:
        return riccati_factored_plain(A, Bm, lx, lu, Jw, Vx0, Vxx0, reg,
                                      qd_diag, u_diag)
    N, nx, n, B = Bm.shape
    r = Jw.shape[0]
    _check_riccati_key(RICCATI, n, A.dtype)
    build.fits(RICCATI, n, A.dtype)
    expect = dict(A=(N, nx, nx, B), lx=(nx, N * B), lu=(n, N * B),
                  Jw=(r, n, N * B), Vx0=(nx, B), Vxx0=(nx, nx, B))
    given = dict(A=A, lx=lx, lu=lu, Jw=Jw, Vx0=Vx0, Vxx0=Vxx0)
    _check_shapes(RICCATI, expect, given)
    if not 1 <= r <= 6:
        raise NotImplementedError(f"{RICCATI}: factor rank {r} not in 1..6")
    build.require(dict(given, Bm=Bm), A.dtype, A.device, RICCATI)
    ks = torch.empty((N, n, B), dtype=A.dtype, device=A.device)
    Ks = torch.empty((N, n, nx, B), dtype=A.dtype, device=A.device)
    ws, nws = build.workspace(RICCATI, n, A, B)
    err = build.lib(n).gridtorch_riccati_factored(
        build.DTYPE_CODES[A.dtype], n, build.ptr(A), build.ptr(Bm),
        build.ptr(lx), build.ptr(lu), build.ptr(Jw), build.ptr(Vx0),
        build.ptr(Vxx0), build.ptr(ks), build.ptr(Ks), N, B, r, float(reg),
        float(qd_diag), float(u_diag), build.stream_ptr(A.device),
        build.ptr(ws), nws)
    build.check(err, RICCATI)
    build.LAUNCHES[RICCATI] += 1
    return ks, Ks


def riccati_plain(A, Bm, lx, lu, lxx, luu, lux, Vx0, Vxx0, reg):
    """Backward Riccati sweep with dense curvature.

    A (N,nx,nx,B), Bm (N,nx,n,B), lx (N,nx,B), lu (N,n,B); lxx (nx,nx,B),
    luu (n,n,B), lux (n,nx,B) for a stationary curvature (one block for
    every knot), or each with a leading N axis; Vx0 (nx,B), Vxx0 (nx,nx,B).
    -> (k (N,n,B), K (N,n,nx,B)).
    """
    build.PLAIN_CALLS[RICCATI_DENSE] += 1
    N = A.shape[0]
    stationary = lxx.ndim == 3
    Vx, Vxx = Vx0, Vxx0
    ks, Ks = [None] * N, [None] * N
    for t in range(N - 1, -1, -1):
        curv = (lxx, luu, lux) if stationary else (lxx[t], luu[t], lux[t])
        ks[t], Ks[t], Vx, Vxx = riccati_knot(A[t], Bm[t], Vx, Vxx, lx[t],
                                             lu[t], *curv, reg)
    return torch.stack(ks), torch.stack(Ks)


def riccati(A, Bm, lx, lu, lxx, luu, lux, Vx0, Vxx0, reg):
    if not A.is_cuda:
        return riccati_plain(A, Bm, lx, lu, lxx, luu, lux, Vx0, Vxx0, reg)
    N, nx, n, B = Bm.shape
    _check_riccati_key(RICCATI_DENSE, n, A.dtype)
    stationary = lxx.ndim == 3
    instance = "riccati" if stationary else "riccati_stacked"
    build.fits(instance, n, A.dtype, RICCATI_DENSE)
    lead = () if stationary else (N,)
    expect = dict(A=(N, nx, nx, B), lx=(N, nx, B), lu=(N, n, B),
                  lxx=lead + (nx, nx, B), luu=lead + (n, n, B),
                  lux=lead + (n, nx, B), Vx0=(nx, B), Vxx0=(nx, nx, B))
    given = dict(A=A, lx=lx, lu=lu, lxx=lxx, luu=luu, lux=lux, Vx0=Vx0,
                 Vxx0=Vxx0)
    _check_shapes(RICCATI_DENSE, expect, given)
    build.require(dict(given, Bm=Bm), A.dtype, A.device, RICCATI_DENSE)
    ks = torch.empty((N, n, B), dtype=A.dtype, device=A.device)
    Ks = torch.empty((N, n, nx, B), dtype=A.dtype, device=A.device)
    # above 28 joints a problem runs on chip in a block or a cluster
    # (csrc/sweep_warp.cuh: RicChipPlan), its inputs first copied
    # problem-major, a record a problem (no workspace)
    per = build.lib(n).gridtorch_riccati_inputs(
        build.DTYPE_CODES[A.dtype], n, N, int(stationary))
    rec = (torch.empty(B * per, dtype=A.dtype, device=A.device) if per > 0
           else None)
    err = build.lib(n).gridtorch_riccati(
        build.DTYPE_CODES[A.dtype], n, build.ptr(A), build.ptr(Bm),
        build.ptr(lx), build.ptr(lu), build.ptr(lxx), build.ptr(luu),
        build.ptr(lux), int(stationary), build.ptr(Vx0), build.ptr(Vxx0),
        build.ptr(ks), build.ptr(Ks), N, B, float(reg),
        build.stream_ptr(A.device), build.ptr(rec), 0 if rec is None
        else rec.numel())
    build.check(err, RICCATI_DENSE)
    build.LAUNCHES[RICCATI_DENSE] += 1
    return ks, Ks


def _check_riccati_key(what, n, dtype):
    build.check_joints(n, what)
    if dtype not in build.DTYPE_CODES:
        raise NotImplementedError(f"{what}: no CUDA kernel for {dtype}")


def _check_shapes(what, expect, given):
    for name, shp in expect.items():
        if tuple(given[name].shape) != shp:
            raise ValueError(f"{what}: {name} is "
                             f"{tuple(given[name].shape)}, expected {shp}")
