"""Public API: the per-robot dynamics suite on PyTorch and CUDA.

The counterpart of ``gridcodegenerator_tpu/api.py``. Two tiers:

* **kernel** — the wrappers in ``ops/cuda/kernels.py``, on lane-major
  ``(dim, B)`` tensors: a CUDA tensor launches the hand-written kernel (any
  B; the ragged last block is masked) or raises, a CPU tensor runs the plain
  PyTorch version;
* **host** — the methods below: accept and return batch-major ``(B, dim)``
  (or unbatched ``(dim,)``) numpy arrays or tensors, handle layout, dtype,
  device and the packed ``q_qd_u`` inputs.

Example::

    from gridcodegenerator_tpu_torch import GRiD
    grid = GRiD("iiwa")                       # or a URDF path/XML/topology
    c     = grid.id(q, qd, qdd)               # RNEA         (B, n)
    Minv  = grid.minv(q)                      # (B, n, n)
    qdd   = grid.fd(q, qd, u)                 # Minv route
    qdd   = grid.aba(q, qd, u)                # ABA route
    M     = grid.crba(q)                      # (B, n, n)
    dc_du = grid.id_du(q, qd, qdd)            # (B, n, 2n)
    df_du = grid.fd_du(q, qd, u)              # (B, n, 2n)
    pose  = grid.eepos(q)                     # (B, 6*num_ees)
    J     = grid.deepos(q)                    # (B, 6*num_ees, n)
    H     = grid.d2eepos(q)                   # (B, 6*num_ees, n, n)
    Tw    = grid.fk(q)                        # (B, n, 4, 4), plain torch
    d2tau = grid.idsva_so(q, qd, qdd)         # (B, 4, n, n, n)
    d2qdd = grid.fdsva_so(q, qd, u)           # (B, 4, n, n, n)

``GRiD`` runs on the card unless ``device="cpu"`` is asked for.

A floating-base robot (``GRiD("atlas", floating_base=True)`` or
``GRiD("atlas_floating")``: q is num_pos = num_vel + 1 wide, the root's
[x, y, z, qx, qy, qz, qw] first) is served by every first-order method on
the plain twins, on whatever device was asked for: the CUDA kernels are
fixed-base, as the JAX package's Pallas kernels are. The route is fixed at
construction by ``model.floating_base``: ``use_kernels=True`` on such a
robot raises ``NotImplementedError``, and so do ``idsva_so`` and
``fdsva_so`` (second order is fixed-base, as in the JAX package).

A fixed-base robot of 1 to 64 one-dof joints runs every method on the
card, the second order too (above 28 joints, where the JAX package leaves
its Pallas kernels for its XLA tier, ``idsva_so`` accumulates its tile in
device memory and ``fdsva_so`` is composed from it); on the CPU, or with
``use_kernels=False``, the plain versions run.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .models.model import RobotModel, build_model, resolve_device
from .models.zoo import list_robots, load_robot
from .ops import eepose as _eepose
from .ops.common import DEFAULT_GRAVITY
from .ops.cuda import kernels as _k
from .topology.robot import RobotTopology
from .topology.urdf import parse_urdf

def init_robot(source: Union[str, RobotTopology],
               floating_base: bool = False) -> RobotTopology:
    """Load a robot: zoo name, URDF path, URDF XML string, or a topology."""
    if isinstance(source, RobotTopology):
        return source
    if "<robot" in source:
        return parse_urdf(source, floating_base=floating_base)
    if source.replace("_floating", "") in [
            n.replace("_floating", "") for n in list_robots()]:
        return load_robot(source + ("_floating" if floating_base
                                    and not source.endswith("_floating")
                                    else ""))
    return parse_urdf(source, floating_base=floating_base)


class GRiD:
    """Per-robot dynamics suite on one device."""

    def __init__(
        self,
        robot: Union[str, RobotTopology],
        dtype=torch.float32,
        gravity: float = DEFAULT_GRAVITY,
        floating_base: bool = False,
        device="cuda",
        use_kernels: Optional[bool] = None,
        ee_targets: Optional[Sequence[str]] = None,
    ):
        """``device``: the card by default; without a CUDA device this
        raises unless ``device="cpu"`` is asked for.

        ``use_kernels``: None runs the CUDA kernels iff ``device`` is a
        CUDA device (the wrappers dispatch on the tensors' device); False
        runs the plain PyTorch versions on any device; True insists on a
        CUDA device. A floating-base robot runs the plain versions (None
        or False) and refuses True: the kernels are fixed-base.

        ``ee_targets``: fixed-joint frame names to treat as end effectors
        (default: every fixed joint, or the leaf links without any); an
        unknown name raises ``ValueError``."""
        self.device = resolve_device(device)
        self.topology = init_robot(robot, floating_base=floating_base)
        if use_kernels and self.topology.floating_base:
            raise NotImplementedError(
                f"use_kernels=True: the CUDA kernels are fixed-base and "
                f"{self.topology.name!r} has a floating base")
        if use_kernels and self.device.type != "cuda":
            raise ValueError(f"use_kernels=True needs a CUDA device, "
                             f"got {self.device}")
        self.model: RobotModel = build_model(self.topology, dtype=dtype,
                                             device=self.device)
        self.dtype = dtype
        self.gravity = float(gravity)
        self.n = self.model.n
        self.num_pos = self.model.num_pos
        self.num_vel = self.model.num_vel
        self.ee_targets = None if ee_targets is None else tuple(ee_targets)
        self.num_ees = _eepose.num_ees(self.model, self.ee_targets)
        self.use_kernels = use_kernels
        # the route, fixed here: a floating base takes the plain twins
        plain = use_kernels is False or self.model.floating_base
        self._fd_du = _k.fd_du_plain if plain else _k.fd_du
        self._rnea = _k.rnea_plain if plain else _k.rnea
        self._id_du = _k.id_du_plain if plain else _k.id_du
        self._aba = _k.aba_plain if plain else _k.aba
        self._minv = _k.minv_plain if plain else _k.minv
        self._fd = _k.fd_plain if plain else _k.fd
        self._crba = _k.crba_plain if plain else _k.crba
        self._eepos = _k.eepos_plain if plain else _k.eepos
        self._deepos = _k.deepos_plain if plain else _k.deepos
        self._d2eepos = _k.d2eepos_plain if plain else _k.d2eepos
        self._idsva_so = _k.idsva_so_plain if plain else _k.idsva_so
        self._fdsva_so = _k.fdsva_so_plain if plain else _k.fdsva_so

    # ------------------------------------------------------------------
    # layout shims: user (B, dim) <-> kernel (dim, B)
    # ------------------------------------------------------------------
    def _in(self, x, dim):
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if x.ndim not in (1, 2) or x.shape[-1] != dim:
            raise ValueError(f"expected ({dim},) or (B, {dim}), got "
                             f"{tuple(x.shape)}")
        if x.ndim == 1:
            return x[:, None].contiguous(), True
        return x.T.contiguous(), False

    @staticmethod
    def _out(x, unbatched):
        # kernel output (..., B) -> user (B, ...) or unbatched (...)
        x = x.movedim(-1, 0)
        return x[0] if unbatched else x

    # ------------------------------------------------------------------
    # host tier
    # ------------------------------------------------------------------
    def id(self, q, qd, qdd=None):
        """RNEA inverse dynamics c(q, qd[, qdd]): (B, nv)."""
        qk, ub = self._in(q, self.num_pos)
        qdk, _ = self._in(qd, self.num_vel)
        qddk = None if qdd is None else self._in(qdd, self.num_vel)[0]
        return self._out(self._rnea(self.model, qk, qdk, qddk, self.gravity),
                         ub)

    def minv(self, q, dense: bool = True):
        """M(q)^-1: (B, nv, nv); ``dense=False`` gives the upper factor."""
        qk, ub = self._in(q, self.num_pos)
        return self._out(self._minv(self.model, qk, dense), ub)

    def aba(self, q, qd, u):
        """Forward dynamics qdd via the articulated-body algorithm: (B, nv)."""
        qk, ub = self._in(q, self.num_pos)
        qdk, _ = self._in(qd, self.num_vel)
        uk, _ = self._in(u, self.num_vel)
        return self._out(self._aba(self.model, qk, qdk, uk, self.gravity), ub)

    def id_du(self, q, qd, qdd=None):
        """Analytical dc/d[q|qd]: (B, nv, 2*nv); ``qdd`` defaults to zeros."""
        qk, ub = self._in(q, self.num_pos)
        qdk, _ = self._in(qd, self.num_vel)
        qddk = (torch.zeros_like(qdk) if qdd is None
                else self._in(qdd, self.num_vel)[0])
        return self._out(self._id_du(self.model, qk, qdk, qddk,
                                     self.gravity), ub)

    def fd_du(self, q, qd, u):
        """Analytical dqdd/d[q|qd]: (B, nv, 2*nv). dqdd/dtau is minv(q)."""
        qk, ub = self._in(q, self.num_pos)
        qdk, _ = self._in(qd, self.num_vel)
        uk, _ = self._in(u, self.num_vel)
        df_du, _, _ = self._fd_du(self.model, qk, qdk, uk, self.gravity)
        return self._out(df_du, ub)

    def fd(self, q, qd, u):
        """Forward dynamics qdd via the Minv route: (B, nv)."""
        qk, ub = self._in(q, self.num_pos)
        qdk, _ = self._in(qd, self.num_vel)
        uk, _ = self._in(u, self.num_vel)
        return self._out(self._fd(self.model, qk, qdk, uk, self.gravity), ub)

    def crba(self, q):
        """Mass matrix M(q): (B, nv, nv)."""
        qk, ub = self._in(q, self.num_pos)
        return self._out(self._crba(self.model, qk), ub)

    def idsva_so(self, q, qd, qdd=None):
        """Second-order ID tensors [d2tau/dq2, d2tau/dqd2, cross, dM/dq]:
        (B, 4, nv, nv, nv), cross[i, j, k] = d2tau_i / dqd_j dq_k.

        ``qdd`` defaults to zeros, as the JAX API's does; pass the realized
        accelerations (e.g. from :meth:`fd`) whenever the tensors must be
        consistent with a trajectory."""
        qk, ub = self._in(q, self.num_pos)
        qdk, _ = self._in(qd, self.num_vel)
        qddk = (torch.zeros_like(qdk) if qdd is None
                else self._in(qdd, self.num_vel)[0])
        return self._out(self._idsva_so(self.model, qk, qdk, qddk,
                                        self.gravity), ub)

    def fdsva_so(self, q, qd, u):
        """Second-order FD tensors [d2qdd/dq2, d2qdd/dqd2, cross,
        dMinv/dq]: (B, 4, nv, nv, nv)."""
        qk, ub = self._in(q, self.num_pos)
        qdk, _ = self._in(qd, self.num_vel)
        uk, _ = self._in(u, self.num_vel)
        return self._out(self._fdsva_so(self.model, qk, qdk, uk,
                                        self.gravity), ub)

    def eepos(self, q):
        """End-effector poses [xyz, rpy] per EE: (B, 6*num_ees)."""
        qk, ub = self._in(q, self.num_pos)
        return self._out(self._eepos(self.model, qk, self.ee_targets), ub)

    def deepos(self, q):
        """EE pose Jacobians: (B, 6*num_ees, num_pos)."""
        qk, ub = self._in(q, self.num_pos)
        return self._out(self._deepos(self.model, qk, self.ee_targets), ub)

    def d2eepos(self, q):
        """EE pose Hessians, symmetric: (B, 6*num_ees, num_pos, num_pos)."""
        qk, ub = self._in(q, self.num_pos)
        return self._out(self._d2eepos(self.model, qk, self.ee_targets), ub)

    def fk(self, q):
        """World homogeneous transforms of every joint frame: (B, n, 4, 4).
        Plain PyTorch on any device (it has no kernel)."""
        qk, ub = self._in(q, self.num_pos)
        return self._out(_eepose.fk(self.model, qk), ub)

    # -- packed-input convenience (gridData q_qd_u layout parity) ---------
    def _unpack3(self, q_qd_u):
        np_, nv = self.num_pos, self.num_vel
        return (q_qd_u[..., :np_], q_qd_u[..., np_:np_ + nv],
                q_qd_u[..., np_ + nv:])

    def fd_du_packed(self, q_qd_u):
        """Packed (B, num_pos + 2*num_vel) input, as the reference's
        ``d_q_qd_u`` stride-3n buffer."""
        return self.fd_du(*self._unpack3(q_qd_u))

    def id_packed(self, q_qd_qdd):
        return self.id(*self._unpack3(q_qd_qdd))

    def aba_packed(self, q_qd_u):
        return self.aba(*self._unpack3(q_qd_u))

    def fd_packed(self, q_qd_u):
        return self.fd(*self._unpack3(q_qd_u))

    def idsva_so_packed(self, q_qd_qdd):
        return self.idsva_so(*self._unpack3(q_qd_qdd))

    def fdsva_so_packed(self, q_qd_u):
        return self.fdsva_so(*self._unpack3(q_qd_u))

    # ------------------------------------------------------------------
    def joint_limits(self) -> np.ndarray:
        return self.model.joint_limits.cpu().numpy()

    def __repr__(self):
        return (f"GRiD({self.model.name!r}, n={self.n}, dtype={self.dtype}, "
                f"device={self.device}, "
                f"floating={self.model.floating_base})")
