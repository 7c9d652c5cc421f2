"""Per-lane dynamics kernels of the GRiD API: CUDA kernels and plain versions.

Lane-major tensors, L lanes on the trailing axis:

* ``fd_du(model, q, qd, u)`` -> (df_du (n, 2n, L), qdd (n, L),
  Minv (n, n, L)): the fused forward-dynamics gradient (in the solver
  L = N*B knots, knot-major). Replaces
  ``gridcodegenerator_tpu/ops/pallas/kernels.py:fd_du_pallas``
  (``with_extras=True``).
* ``rnea(model, q, qd, qdd=None)`` -> c (n, L); without qdd the bias force.
  Replaces ``kernels.py:rnea_pallas``.
* ``id_du(model, q, qd, qdd)`` -> dc_du (n, 2n, L). Replaces
  ``kernels.py:id_du_pallas``.
* ``aba(model, q, qd, u)`` -> qdd (n, L). Replaces ``kernels.py:aba_pallas``.
* ``minv(model, q, dense=True)`` -> Minv (n, n, L), dense or the upper
  factor (exact zeros below the diagonal). Replaces
  ``kernels.py:minv_pallas``.
* ``fd(model, q, qd, u)`` -> qdd (n, L), the Minv route. Replaces
  ``kernels.py:fd_pallas``.
* ``crba(model, q)`` -> M (n, n, L). Replaces ``kernels.py:crba_pallas``.
* ``eepos(model, q, targets=None)`` -> (6 ne, L) EE poses [xyz, rpy].
  Replaces ``kernels.py:eepos_pallas``.
* ``deepos(model, q, targets=None)`` -> (6 ne, n, L) EE pose Jacobians.
  Replaces ``kernels.py:deepos_pallas``.
* ``d2eepos(model, q, targets=None)`` -> (6 ne, n, n, L) EE pose Hessians.
  Replaces ``kernels.py:d2eepos_pallas``.
* ``idsva_so(model, q, qd, qdd)`` -> (4, n, n, n, L) IDSVA-SO
  [d2tau/dq2, d2tau/dqd2, d2tau/dqd dq, dM/dq]. Replaces
  ``kernels.py:idsva_so_pallas``.
* ``fdsva_so(model, q, qd, u)`` -> (4, n, n, n, L) FDSVA-SO
  [d2qdd/dq2, d2qdd/dqd2, d2qdd/dqd dq, dMinv/dq] (in the solver L = N*B
  knots, knot-major). Replaces ``kernels.py:fdsva_so_pallas``: the fused
  kernel where one knot fits a block, else (``fdsva_so_route``) the JAX
  package's composed route, ``fdsva_so_composed``: the fd_du kernel with
  extras, the idsva_so kernel at its qdd, then ``ops/so.py``'s
  contractions in torch (``fdsva_compose_lanes``).

Kernels: ``csrc/<name>.cu``, a thread group per lane (knot), its state in
shared memory, G knots a block (``fd_du``, ``fdsva_so``, ``idsva_so``,
``id_du``, ``rnea``, ``fd`` (fd_du's bias and Minv passes), ``minv`` (fd's
Minv passes), ``crba`` (a level of the tree a phase), ``eepos``,
``deepos`` and ``d2eepos`` (one EE chain's twist phases) on
``csrc/warp.cuh``; ``aba`` on the rollouts' ABA phases,
``csrc/sweep_warp.cuh``).
Inputs are read and outputs written along the lane axis, G consecutive
lanes a row. What bounds them on the card: the phases' latency and
arithmetic — not device memory, since a 7-DoF lane reads at most 21
values and writes at most 154 (deepos: 42 per EE) — but for the
second-order outputs (4 n^3 values a lane; d2eepos 6 n^2 per EE), whose
writes are the least time.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. The kernels are fixed-base (``build.kernel_key`` refuses a
floating-base model, as the JAX Pallas kernels do); the plain versions
take one, on any device, and ``GRiD`` routes a floating robot to them: every kernel checks its instance's block plan first, and
refuses, before any launch, one whose knot does not fit a block
(``build.fits``).
Every fixed-base robot of 1 to ``build.MAX_JOINTS`` = 64 one-dof joints
has a kernel for each function: from 29 joints fd_du and id_du keep one
knot on chip, in a block or a thread-block cluster (csrc/warp.cuh:
FDChipPlan, IDUChipPlan); where a knot does not fit a block, minv and fd
in float64 keep it in device memory (a workspace from
``build.workspace``, one knot a block); idsva_so runs its tile in
bands of rows, or in device memory where bands would not do
(``idsva_so_route``); fdsva_so takes the composed route
(``fdsva_so_route``).
"""

from __future__ import annotations

import torch

from ...models.model import RobotModel
from ..aba import aba as _aba
from ..common import DEFAULT_GRAVITY
from ..crba import crba as _crba
from ..eepose import d2eepos as _d2eepos
from ..eepose import deepos as _deepos
from ..eepose import eepos as _eepos
from ..fd import forward_dynamics
from ..fd_grad import fd_grad
from ..id_grad import id_grad
from ..minv import minv as _minv
from ..rnea import rnea as _rnea
from ..so import fdsva_compose_lanes
from ..so import fdsva_so as _fdsva_so
from ..so import idsva_so as _idsva_so
from . import build

FD_DU, RNEA, ID_DU, ABA, MINV = "fd_du", "rnea", "id_du", "aba", "minv"
FD, CRBA, EEPOS, DEEPOS = "fd", "crba", "eepos", "deepos"
IDSVA_SO, FDSVA_SO, D2EEPOS = "idsva_so", "fdsva_so", "d2eepos"
SOURCES = {k: f"gridcodegenerator_tpu_torch/csrc/{k}.cu"
           for k in (FD_DU, RNEA, ID_DU, ABA, MINV, FD, CRBA, EEPOS, DEEPOS,
                     IDSVA_SO, FDSVA_SO, D2EEPOS)}
REPLACES = {k: f"gridcodegenerator_tpu/ops/pallas/kernels.py:{line}"
            for k, line in ((FD_DU, 171), (RNEA, 77), (ID_DU, 156),
                            (ABA, 141), (MINV, 98), (FD, 126), (CRBA, 112),
                            (EEPOS, 375), (DEEPOS, 390), (IDSVA_SO, 264),
                            (FDSVA_SO, 303), (D2EEPOS, 407))}


def _lanes(model: RobotModel, what: str, inputs):
    """Check the (n, L) inputs of kernel ``what`` (None entries skipped) ->
    (dtype code, joint count, L)."""
    first = inputs["q"]
    dcode, nj = build.kernel_key(model, first, what)
    n, L = model.n, first.shape[-1]
    for name, t in inputs.items():
        if t is not None and tuple(t.shape) != (n, L):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, "
                             f"expected {(n, L)}")
    build.require(inputs, first.dtype, first.device, what)
    return dcode, nj, L


def _empty(like: torch.Tensor, *shape):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _launched(what: str, err: int):
    build.check(err, what)
    build.LAUNCHES[what] += 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fd_du_plain(model: RobotModel, q, qd, u, gravity=DEFAULT_GRAVITY):
    """Plain PyTorch version: ``fd_grad(return_extras=True)``."""
    build.PLAIN_CALLS[FD_DU] += 1
    return fd_grad(model, q, qd, u, gravity, return_extras=True)


def rnea_plain(model: RobotModel, q, qd, qdd=None, gravity=DEFAULT_GRAVITY):
    build.PLAIN_CALLS[RNEA] += 1
    return _rnea(model, q, qd, qdd, gravity)


def id_du_plain(model: RobotModel, q, qd, qdd, gravity=DEFAULT_GRAVITY):
    build.PLAIN_CALLS[ID_DU] += 1
    return id_grad(model, q, qd, qdd, gravity)


def aba_plain(model: RobotModel, q, qd, u, gravity=DEFAULT_GRAVITY):
    build.PLAIN_CALLS[ABA] += 1
    return _aba(model, q, qd, u, gravity)


def minv_plain(model: RobotModel, q, dense: bool = True):
    build.PLAIN_CALLS[MINV] += 1
    return _minv(model, q, dense)


def fd_plain(model: RobotModel, q, qd, u, gravity=DEFAULT_GRAVITY):
    build.PLAIN_CALLS[FD] += 1
    return forward_dynamics(model, q, qd, u, gravity)


def crba_plain(model: RobotModel, q):
    build.PLAIN_CALLS[CRBA] += 1
    return _crba(model, q)


def eepos_plain(model: RobotModel, q, targets=None):
    build.PLAIN_CALLS[EEPOS] += 1
    return _eepos(model, q, targets)


def deepos_plain(model: RobotModel, q, targets=None):
    build.PLAIN_CALLS[DEEPOS] += 1
    return _deepos(model, q, targets)


def d2eepos_plain(model: RobotModel, q, targets=None):
    build.PLAIN_CALLS[D2EEPOS] += 1
    return _d2eepos(model, q, targets)


def idsva_so_plain(model: RobotModel, q, qd, qdd, gravity=DEFAULT_GRAVITY):
    build.PLAIN_CALLS[IDSVA_SO] += 1
    return _idsva_so(model, q, qd, qdd, gravity)


def fdsva_so_plain(model: RobotModel, q, qd, u, gravity=DEFAULT_GRAVITY):
    build.PLAIN_CALLS[FDSVA_SO] += 1
    return _fdsva_so(model, q, qd, u, gravity)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def fd_du(model: RobotModel, q, qd, u, gravity=DEFAULT_GRAVITY):
    if not q.is_cuda:
        return fd_du_plain(model, q, qd, u, gravity)
    dcode, nj, L = _lanes(model, FD_DU, dict(q=q, qd=qd, u=u))
    build.fits(FD_DU, nj, q.dtype)
    n = model.n
    df_du = _empty(q, n, 2 * n, L)
    qdd, Mi = _empty(q, n, L), _empty(q, n, n, L)
    # no workspace: above 28 joints a knot runs on chip in a block or a
    # cluster (csrc/warp.cuh: FDChipPlan, CHIP_FROM)
    _launched(FD_DU, build.lib(nj).gridtorch_fd_du(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(q),
        build.ptr(qd), build.ptr(u), build.ptr(df_du), build.ptr(qdd),
        build.ptr(Mi), L, float(gravity), build.stream_ptr(q.device), None,
        0))
    return df_du, qdd, Mi


def rnea(model: RobotModel, q, qd, qdd=None, gravity=DEFAULT_GRAVITY):
    if not q.is_cuda:
        return rnea_plain(model, q, qd, qdd, gravity)
    dcode, nj, L = _lanes(model, RNEA, dict(q=q, qd=qd, qdd=qdd))
    build.fits(RNEA, nj, q.dtype)
    c = _empty(q, model.n, L)
    _launched(RNEA, build.lib(nj).gridtorch_rnea(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(q),
        build.ptr(qd), build.ptr(qdd), build.ptr(c), L, float(gravity),
        build.stream_ptr(q.device)))
    return c


def id_du(model: RobotModel, q, qd, qdd, gravity=DEFAULT_GRAVITY):
    if not q.is_cuda:
        return id_du_plain(model, q, qd, qdd, gravity)
    if qdd is None:
        raise ValueError(f"{ID_DU}: qdd is required")
    dcode, nj, L = _lanes(model, ID_DU, dict(q=q, qd=qd, qdd=qdd))
    build.fits(ID_DU, nj, q.dtype)
    dc_du = _empty(q, model.n, 2 * model.n, L)
    # no workspace: above 28 joints a knot runs on chip in a block or a
    # cluster (csrc/warp.cuh: IDUChipPlan, CHIP_FROM)
    _launched(ID_DU, build.lib(nj).gridtorch_id_du(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(q),
        build.ptr(qd), build.ptr(qdd), build.ptr(dc_du), L, float(gravity),
        build.stream_ptr(q.device)))
    return dc_du


def aba(model: RobotModel, q, qd, u, gravity=DEFAULT_GRAVITY):
    if not q.is_cuda:
        return aba_plain(model, q, qd, u, gravity)
    dcode, nj, L = _lanes(model, ABA, dict(q=q, qd=qd, u=u))
    build.fits(ABA, nj, q.dtype)
    qdd = _empty(q, model.n, L)
    _launched(ABA, build.lib(nj).gridtorch_aba(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(q),
        build.ptr(qd), build.ptr(u), build.ptr(qdd), L, float(gravity),
        build.stream_ptr(q.device)))
    return qdd


def minv(model: RobotModel, q, dense: bool = True):
    if not q.is_cuda:
        return minv_plain(model, q, dense)
    dcode, nj, L = _lanes(model, MINV, dict(q=q))
    build.fits(MINV, nj, q.dtype)
    Mi = _empty(q, model.n, model.n, L)
    ws, nws = build.workspace(MINV, nj, q, L)
    _launched(MINV, build.lib(nj).gridtorch_minv(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(q),
        build.ptr(Mi), L, int(bool(dense)), build.stream_ptr(q.device),
        build.ptr(ws), nws))
    return Mi


def fd(model: RobotModel, q, qd, u, gravity=DEFAULT_GRAVITY):
    if not q.is_cuda:
        return fd_plain(model, q, qd, u, gravity)
    dcode, nj, L = _lanes(model, FD, dict(q=q, qd=qd, u=u))
    build.fits(FD, nj, q.dtype)
    qdd = _empty(q, model.n, L)
    ws, nws = build.workspace(FD, nj, q, L)
    _launched(FD, build.lib(nj).gridtorch_fd(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(q),
        build.ptr(qd), build.ptr(u), build.ptr(qdd), L, float(gravity),
        build.stream_ptr(q.device), build.ptr(ws), nws))
    return qdd


def crba(model: RobotModel, q):
    if not q.is_cuda:
        return crba_plain(model, q)
    dcode, nj, L = _lanes(model, CRBA, dict(q=q))
    build.fits(CRBA, nj, q.dtype)
    M = _empty(q, model.n, model.n, L)
    _launched(CRBA, build.lib(nj).gridtorch_crba(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(q),
        build.ptr(M), L, build.stream_ptr(q.device)))
    return M


def _ee_launch(what: str, model: RobotModel, q, targets, *cols):
    """Launch EE kernel ``what`` over the EE rows of ``targets``: output
    (6 ne, *cols, L)."""
    dcode, nj, L = _lanes(model, what, dict(q=q))
    build.fits(what, nj, q.dtype)
    ee = build.ee_buffer(model, targets)
    out = _empty(q, 6 * ee.shape[0], *cols, L)
    _launched(what, getattr(build.lib(nj), f"gridtorch_{what}")(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(ee),
        ee.shape[0], build.ptr(q), build.ptr(out), L,
        build.stream_ptr(q.device)))
    return out


def eepos(model: RobotModel, q, targets=None):
    if not q.is_cuda:
        return eepos_plain(model, q, targets)
    return _ee_launch(EEPOS, model, q, targets)


def deepos(model: RobotModel, q, targets=None):
    if not q.is_cuda:
        return deepos_plain(model, q, targets)
    return _ee_launch(DEEPOS, model, q, targets, model.n)


def d2eepos(model: RobotModel, q, targets=None):
    if not q.is_cuda:
        return d2eepos_plain(model, q, targets)
    return _ee_launch(D2EEPOS, model, q, targets, model.n, model.n)


WHOLE, BANDS, DEVICE = "whole", "bands", "device"
IDSO_ROUTES = (WHOLE, BANDS, DEVICE)   # csrc/warp.cuh: IDSO_WHOLE, ...


def idsva_so_route(nj: int, dtype) -> str:
    """The route of ``idsva_so`` at ``nj`` joints in ``dtype``
    (``csrc/warp.cuh:idso_route``): WHOLE, each knot's whole tile in a
    block's shared memory, where it fits (float32 up to 23 joints, float64
    up to 18); else, up to 28 joints, BANDS, the tile in bands of rows, a
    band a block, each running the knot's whole program; else DEVICE, the
    tile accumulated in the output in device memory, each knot's program
    run once (on an H100 7.7-12.4x faster than the bands at 28 and 34
    joints: PERF.md, Findings)."""
    p = build.plan(IDSVA_SO, nj, dtype)
    return DEVICE if p["device_tile"] else BANDS if p["bands"] > 1 else WHOLE


def idsva_so(model: RobotModel, q, qd, qdd, gravity=DEFAULT_GRAVITY):
    """Each knot's IDSVA-SO tensors stay in the kernel's shared memory
    until written, the whole tile or one band of its rows a block, or
    accumulate in the output in device memory (``idsva_so_route``)."""
    if not q.is_cuda:
        return idsva_so_plain(model, q, qd, qdd, gravity)
    if qdd is None:
        raise ValueError(f"{IDSVA_SO}: qdd is required")
    dcode, nj, L = _lanes(model, IDSVA_SO, dict(q=q, qd=qd, qdd=qdd))
    build.fits(IDSVA_SO, nj, q.dtype)
    n = model.n
    lists, ntrip, npair = build.so_lists(model)
    out = _empty(q, 4, n, n, n, L)
    _launched(IDSVA_SO, build.lib(nj).gridtorch_idsva_so(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(q),
        build.ptr(qd), build.ptr(qdd), build.ptr(out), L, float(gravity),
        build.stream_ptr(q.device), build.ptr(lists), ntrip, npair))
    return out


FUSED, COMPOSED = "fused", "composed"


def fdsva_so_route(nj: int, dtype) -> str:
    """The route of ``fdsva_so`` at ``nj`` joints in ``dtype``: FUSED, the
    fdsva_so kernel, where one knot fits a block (float32 up to 22 joints,
    float64 up to 17; where both routes run, at gym_humanoid's 17 joints
    and the 20-joint chain's in float32, the fused one was the faster on
    an H100: PERF.md, Findings), else COMPOSED."""
    fits = build.plan(FDSVA_SO, nj, dtype)["knots_per_block"] >= 1
    return FUSED if fits else COMPOSED


def fdsva_so_composed(model: RobotModel, q, qd, u, gravity=DEFAULT_GRAVITY):
    """FDSVA-SO on the composed route: fd_du (df/du, qdd, Minv), idsva_so
    at (q, qd, qdd), then ``ops/so.py:fdsva_compose_lanes`` in place on
    idsva_so's output. On the card it launches fd_du and idsva_so once
    each; on CPU tensors it runs their plain versions."""
    df_du, qdd, Mi = fd_du(model, q, qd, u, gravity)
    return fdsva_compose_lanes(idsva_so(model, q, qd, qdd, gravity), df_du,
                               Mi)


def fdsva_so(model: RobotModel, q, qd, u, gravity=DEFAULT_GRAVITY):
    """The fused kernel keeps each knot's IDSVA-SO tensors and their
    contractions in shared memory; where one knot does not fit a block
    the composed route runs (``fdsva_so_route``)."""
    if not q.is_cuda:
        return fdsva_so_plain(model, q, qd, u, gravity)
    dcode, nj, L = _lanes(model, FDSVA_SO, dict(q=q, qd=qd, u=u))
    if fdsva_so_route(nj, q.dtype) == COMPOSED:
        return fdsva_so_composed(model, q, qd, u, gravity)
    build.fits(FDSVA_SO, nj, q.dtype)
    n = model.n
    out = _empty(q, 4, n, n, n, L)
    _launched(FDSVA_SO, build.lib(nj).gridtorch_fdsva_so(
        dcode, nj, build.ptr(build.model_buffer(model)), build.ptr(q),
        build.ptr(qd), build.ptr(u), build.ptr(out), L, float(gravity),
        build.stream_ptr(q.device)))
    return out
