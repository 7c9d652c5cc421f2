"""RobotModel: the per-robot constants every op and kernel reads.

The counterpart of ``gridcodegenerator_tpu/models/model.py``. Spatial
inertias, tree transforms and limits are tensors on one ``device``: the
card by default (``"cuda"``), the CPU only when asked (``device="cpu"``);
the topology (parents, BFS waves, ancestor and subtree sets, joint axes) is
static Python data, so every op unrolls over it in Python.

Layout convention: the batch of problems or knots is the TRAILING axis;
per-joint 6-vectors are ``(6, B)`` and 6x6 operators ``(6, 6, B)``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from ..topology.robot import RobotTopology

# tensor fields, in the order of the JAX model's array leaves
ARRAY_FIELDS = ("Xtree", "Imat", "damping", "joint_limits", "effort_limit",
                "velocity_limit", "Ttree", "Tfixed", "subtree_mask")
STATIC_FIELDS = ("name", "n", "num_pos", "num_vel", "parent", "S_ind",
                 "jtype", "bfs_levels", "ancestors", "subtree", "leaves",
                 "floating_base", "fixed_parent", "fixed_names")


def _tt(x):
    """Nested list -> nested tuple."""
    if isinstance(x, (list, tuple)):
        return tuple(_tt(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class RobotModel:
    Xtree: torch.Tensor          # (n, 6, 6) fixed parent->joint motion transforms
    Imat: torch.Tensor           # (n, 6, 6) spatial inertias in link frames
    damping: torch.Tensor        # (n,)
    joint_limits: torch.Tensor   # (n, 2) lower/upper (±inf where unset)
    effort_limit: torch.Tensor   # (num_vel,) max |tau| (+inf where unset)
    velocity_limit: torch.Tensor  # (num_vel,) max |qd| (+inf where unset)
    Ttree: torch.Tensor          # (n, 4, 4) fixed homogeneous transforms (FK)
    Tfixed: torch.Tensor         # (n_fixed, 4, 4) fixed-joint target frames
    subtree_mask: torch.Tensor   # (n, nv) 0/1 over velocity columns
    name: str
    n: int
    num_pos: int
    num_vel: int
    parent: Tuple[int, ...]
    S_ind: Tuple[int, ...]
    jtype: Tuple[str, ...]
    bfs_levels: Tuple[Tuple[int, ...], ...]
    ancestors: Tuple[Tuple[int, ...], ...]
    subtree: Tuple[Tuple[int, ...], ...]
    leaves: Tuple[int, ...]
    floating_base: bool
    fixed_parent: Tuple[int, ...]
    fixed_names: Tuple[str, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.Imat.dtype

    @property
    def device(self) -> torch.device:
        return self.Imat.device

    def to(self, device=None, dtype=None) -> "RobotModel":
        """A copy with every tensor moved to ``device`` and/or ``dtype``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device=device, dtype=dtype)
            for f in ARRAY_FIELDS})


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without one present
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but no CUDA device is present: "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def build_model(topo: RobotTopology, dtype=torch.float32,
                device="cuda") -> RobotModel:
    """Bake a RobotTopology into a RobotModel on ``device``."""
    n = topo.get_num_joints()
    nv = topo.get_num_vel()
    voff, off = [], 0
    for i in range(n):
        d = 6 if topo.joints[i].jtype == "floating" else 1
        voff.append((off, d))
        off += d
    sub_mask = np.zeros((n, nv))
    for i in range(n):
        for j in topo.get_subtree_by_id(i):
            o, d = voff[j]
            sub_mask[i, o:o + d] = 1.0
    if topo.fixed_joints:
        Tfixed = np.stack([f.Ttree for f in topo.fixed_joints])
    else:
        Tfixed = np.zeros((0, 4, 4))
    arrays = dict(
        Xtree=np.stack([topo.joints[i].Xtree for i in range(n)]),
        Imat=np.stack([topo.get_Imat_by_id(i) for i in range(n)]),
        damping=np.array([topo.get_damping_by_id(i) for i in range(n)]),
        joint_limits=topo.get_joint_limits(),
        effort_limit=topo.get_effort_limits(),
        velocity_limit=topo.get_velocity_limits(),
        Ttree=np.stack([topo.joints[i].Ttree for i in range(n)]),
        Tfixed=Tfixed,
        subtree_mask=sub_mask,
    )
    levels = [tuple(topo.get_ids_by_bfs_level(l))
              for l in range(topo.get_max_bfs_level() + 1)]
    static = dict(
        name=topo.name,
        n=n,
        num_pos=topo.get_num_pos(),
        num_vel=nv,
        parent=tuple(int(p) for p in topo.get_parent_id_array()),
        S_ind=tuple(topo.get_S_ind_by_id(i) for i in range(n)),
        jtype=tuple(topo.joints[i].jtype for i in range(n)),
        bfs_levels=levels,
        ancestors=[topo.get_ancestors_by_id(i) for i in range(n)],
        subtree=[topo.get_subtree_by_id(i) for i in range(n)],
        leaves=topo.get_leaf_nodes(),
        floating_base=topo.floating_base,
        fixed_parent=tuple(f.parent_jid for f in topo.fixed_joints),
        fixed_names=tuple(f.name for f in topo.fixed_joints),
    )
    return model_from_numpy(arrays, static, dtype=dtype, device=device)


def model_from_numpy(arrays: Mapping[str, np.ndarray], static: Mapping,
                     dtype=None, device="cuda") -> RobotModel:
    """RobotModel from numpy array leaves and static topology fields.

    ``arrays`` holds every name in :data:`ARRAY_FIELDS` (for instance
    ``np.asarray`` of a JAX ``RobotModel``'s leaves) and ``static`` every
    name in :data:`STATIC_FIELDS`. ``dtype=None`` keeps each array's own
    floating type.
    """
    device = resolve_device(device)
    tensors = {f: torch.as_tensor(np.array(arrays[f]), device=device)
               for f in ARRAY_FIELDS}
    if dtype is not None:
        tensors = {f: t.to(dtype) for f, t in tensors.items()}
    return RobotModel(**tensors, **{f: _tt(static[f]) for f in STATIC_FIELDS})
