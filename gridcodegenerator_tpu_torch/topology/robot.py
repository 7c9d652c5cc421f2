"""RobotTopology: the static robot structure every op is specialized over.

A numpy-only copy of ``gridcodegenerator_tpu/topology/robot.py``. It is
carried here rather than imported because importing anything under the JAX
package imports jax, and the GPU machine the port runs on has no jax.

Conventions (Featherstone spatial algebra):
  * spatial vectors are 6-vectors ``[angular; linear]``;
  * ``X_i(q_i)`` is the 6x6 motion transform taking parent-link-frame motion
    vectors into link-i frame coordinates; ``X = X_joint(q) @ X_tree``;
  * ``S_i`` is a one-hot 6-vector selecting the joint's free axis
    (0/1/2 = revolute x/y/z, 3/4/5 = prismatic x/y/z);
  * link spatial inertia ``I = [[Ibar, m*cx],[m*cx^T, m*1]]`` with
    ``Ibar = I_com_in_link_frame + m*cx*cx^T``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# small 3D / spatial helpers (numpy, float64)
# ---------------------------------------------------------------------------

def skew(p: np.ndarray) -> np.ndarray:
    """3x3 skew-symmetric matrix such that skew(p) @ x == cross(p, x)."""
    return np.array(
        [[0.0, -p[2], p[1]],
         [p[2], 0.0, -p[0]],
         [-p[1], p[0], 0.0]], dtype=np.float64)


def rot_axis(axis: int, theta: float) -> np.ndarray:
    """Rotation matrix rotating vectors by ``theta`` about world axis 0/1/2."""
    c, s = np.cos(theta), np.sin(theta)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def rpy_to_R(rpy: Sequence[float]) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw to a rotation matrix (vectors child->parent)."""
    r, p, y = rpy
    return rot_axis(2, y) @ rot_axis(1, p) @ rot_axis(0, r)


def xform_from_E_p(E: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Spatial motion transform ``[[E,0],[-E*skew(p),E]]``.

    ``E`` is the coordinate rotation (E = R^T where R rotates child vectors
    into the parent frame) and ``p`` the child origin in the parent frame.
    """
    X = np.zeros((6, 6), dtype=np.float64)
    X[:3, :3] = E
    X[3:, 3:] = E
    X[3:, :3] = -E @ skew(p)
    return X


def xform_hom_from_R_p(R: np.ndarray, p: np.ndarray) -> np.ndarray:
    """4x4 homogeneous transform child->parent (points): [[R,p],[0,1]]."""
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = p
    return T


def spatial_inertia(mass: float, com: np.ndarray, I_com: np.ndarray) -> np.ndarray:
    """6x6 spatial inertia about the link frame origin, angular-first."""
    C = skew(com)
    I6 = np.zeros((6, 6), dtype=np.float64)
    I6[:3, :3] = I_com + mass * (C @ C.T)
    I6[:3, 3:] = mass * C
    I6[3:, :3] = mass * C.T
    I6[3:, 3:] = mass * np.eye(3)
    return I6


# ---------------------------------------------------------------------------
# joint / fixed-joint records
# ---------------------------------------------------------------------------

REVOLUTE_AXIS_TO_S = {0: 0, 1: 1, 2: 2}
PRISMATIC_AXIS_TO_S = {0: 3, 1: 4, 2: 5}


@dataclasses.dataclass
class Joint:
    """A movable joint (revolute, prismatic, or the synthetic floating joint)."""
    name: str
    jid: int
    parent_id: int          # -1 for joints whose parent link is the base
    jtype: str              # 'revolute' | 'prismatic' | 'floating'
    S_ind: int              # 0..5 for 1-dof joints; -1 for floating
    Xtree: np.ndarray       # (6,6) fixed motion transform parent-link -> joint frame
    Ttree: np.ndarray       # (4,4) fixed homogeneous transform joint frame -> parent-link
    damping: float = 0.0
    limit_lower: float = -np.inf
    limit_upper: float = np.inf
    effort_limit: float = np.inf      # max |tau| (URDF <limit effort>)
    velocity_limit: float = np.inf    # max |qd|  (URDF <limit velocity>)
    parent_link: str = ""
    child_link: str = ""

    @property
    def S(self) -> np.ndarray:
        S = np.zeros(6, dtype=np.float64)
        if self.S_ind >= 0:
            S[self.S_ind] = 1.0
        return S

    def num_pos(self) -> int:
        return 7 if self.jtype == "floating" else 1

    def num_vel(self) -> int:
        return 6 if self.jtype == "floating" else 1

    def Xmat(self, q) -> np.ndarray:
        """6x6 motion transform parent-link-frame -> link frame at position
        q: (7,) [x, y, z, qx, qy, qz, qw] for the floating joint."""
        if self.jtype == "floating":
            q = np.asarray(q, dtype=np.float64)
            return xform_from_E_p(quat_to_R(q[3:7]).T, q[:3])
        q = float(np.asarray(q).reshape(()))
        ax = self.S_ind % 3
        if self.jtype == "revolute":
            Xj = np.zeros((6, 6), dtype=np.float64)
            E = rot_axis(ax, q).T
            Xj[:3, :3] = E
            Xj[3:, 3:] = E
            return Xj @ self.Xtree
        # prismatic: translate q along the joint axis in the joint frame
        p = np.zeros(3)
        p[self.S_ind - 3] = q
        return xform_from_E_p(np.eye(3), p) @ self.Xtree

    def Tmat(self, q) -> np.ndarray:
        """4x4 homogeneous transform link frame -> parent-link frame."""
        if self.jtype == "floating":
            q = np.asarray(q, dtype=np.float64)
            return xform_hom_from_R_p(quat_to_R(q[3:7]), q[:3])
        q = float(np.asarray(q).reshape(()))
        Tj = np.eye(4)
        if self.jtype == "revolute":
            Tj[:3, :3] = rot_axis(self.S_ind % 3, q)
        else:
            Tj[self.S_ind - 3, 3] = q
        return self.Ttree @ Tj


def quat_to_R(quat: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w), normalized here, to the rotation matrix that
    takes child vectors to the parent frame."""
    x, y, z, w = quat
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


@dataclasses.dataclass
class FixedJoint:
    """A fixed URDF joint, kept as a kinematic target for end-effector code."""
    name: str
    fid: int
    parent_jid: int         # movable joint id of the parent link (-1 = base)
    Ttree: np.ndarray       # (4,4) homogeneous: fixed frame -> parent-link frame
    parent_link: str = ""
    child_link: str = ""


# ---------------------------------------------------------------------------
# RobotTopology
# ---------------------------------------------------------------------------

class RobotTopology:
    """Static robot structure: parents, BFS levels, ancestors and subtrees,
    joint axes, tree transforms, inertias, fixed joints and limits.

    Build one with :func:`gridcodegenerator_tpu_torch.topology.urdf.parse_urdf`
    or the model zoo.
    """

    def __init__(
        self,
        name: str,
        joints: List[Joint],
        Imats: List[np.ndarray],          # per movable joint/link, in link frame
        base_inertia: Optional[np.ndarray] = None,
        fixed_joints: Optional[List[FixedJoint]] = None,
        floating_base: bool = False,
    ):
        self.name = name
        self.joints = joints
        self.floating_base = floating_base
        self.fixed_joints = fixed_joints or []
        self._Imats = [np.asarray(I, dtype=np.float64) for I in Imats]
        self._base_inertia = (
            np.zeros((6, 6)) if base_inertia is None
            else np.asarray(base_inertia, dtype=np.float64))

        n = len(joints)
        self._n = n
        self._parent = np.array([j.parent_id for j in joints], dtype=np.int64)
        # ids are topologically ordered (parent < child)
        for j in joints:
            assert j.jid < n and j.parent_id < j.jid, (j.name, j.jid, j.parent_id)

        self._bfs_level = np.zeros(n, dtype=np.int64)
        for i in range(n):
            p = self._parent[i]
            self._bfs_level[i] = 0 if p == -1 else self._bfs_level[p] + 1
        self._max_bfs = int(self._bfs_level.max()) if n else 0
        self._ids_by_level = [
            [i for i in range(n) if self._bfs_level[i] == lvl]
            for lvl in range(self._max_bfs + 1)
        ]

        self._ancestors: List[List[int]] = []
        for i in range(n):
            anc, p = [], self._parent[i]
            while p != -1:
                anc.append(int(p))
                p = self._parent[p]
            self._ancestors.append(sorted(anc))
        self._subtree: List[List[int]] = [[] for _ in range(n)]
        for i in range(n):
            self._subtree[i].append(i)
            for a in self._ancestors[i]:
                self._subtree[a].append(i)
        for i in range(n):
            self._subtree[i] = sorted(self._subtree[i])
        self._leaves = [i for i in range(n) if len(self._subtree[i]) == 1]

        self._num_pos = sum(j.num_pos() for j in joints)
        self._num_vel = sum(j.num_vel() for j in joints)

    def get_num_joints(self) -> int:
        return self._n

    def get_num_pos(self) -> int:
        return self._num_pos

    def get_num_vel(self) -> int:
        return self._num_vel

    def get_parent_id(self, jid: int) -> int:
        return int(self._parent[jid])

    def get_parent_id_array(self) -> np.ndarray:
        return self._parent.copy()

    def get_max_bfs_level(self) -> int:
        return self._max_bfs

    def get_ids_by_bfs_level(self, level: int) -> List[int]:
        return list(self._ids_by_level[level]) if level <= self._max_bfs else []

    def get_ancestors_by_id(self, jid: int) -> List[int]:
        return list(self._ancestors[jid])

    def get_subtree_by_id(self, jid: int) -> List[int]:
        return list(self._subtree[jid])

    def get_leaf_nodes(self) -> List[int]:
        return list(self._leaves)

    def get_S_by_id(self, jid: int) -> np.ndarray:
        return self.joints[jid].S

    def get_S_ind_by_id(self, jid: int) -> int:
        return self.joints[jid].S_ind

    def get_Xmat_Func_by_id(self, jid: int):
        return self.joints[jid].Xmat

    def get_damping_by_id(self, jid: int) -> float:
        return self.joints[jid].damping

    def get_joint_limits(self) -> np.ndarray:
        """(n, 2) array of [lower, upper] per joint (±inf where unset)."""
        return np.array(
            [[j.limit_lower, j.limit_upper] for j in self.joints], dtype=np.float64)

    def get_effort_limits(self) -> np.ndarray:
        """(num_vel,) max |tau| per velocity dof (+inf where unset)."""
        out = []
        for j in self.joints:
            out.extend([j.effort_limit] * j.num_vel())
        return np.array(out, dtype=np.float64)

    def get_velocity_limits(self) -> np.ndarray:
        """(num_vel,) max |qd| per velocity dof."""
        out = []
        for j in self.joints:
            out.extend([j.velocity_limit] * j.num_vel())
        return np.array(out, dtype=np.float64)

    def get_Imat_by_id(self, jid: int) -> np.ndarray:
        return self._Imats[jid].copy()

    def get_Imats_ordered_by_id(self) -> List[np.ndarray]:
        """[base_inertia, I_0, I_1, ...] — index 0 is the base."""
        return [self._base_inertia.copy()] + [I.copy() for I in self._Imats]

    def __repr__(self) -> str:
        return (f"RobotTopology({self.name!r}, n={self._n}, "
                f"floating={self.floating_base}, max_bfs={self._max_bfs})")
