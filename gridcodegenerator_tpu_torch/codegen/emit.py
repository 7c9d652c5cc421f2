"""Per-robot code generation: the ``gen_all_code()`` analog.

The counterpart of ``gridcodegenerator_tpu/codegen/emit.py``. It writes one
standalone module ``<namespace>.py`` per robot with

* every robot constant and the topology as literals (the ``init_XImats`` /
  ``init_topology_helpers`` analog), rebuilt by ``init_robot()`` with the
  port's own ``topology/robot.py`` — no URDF is read at import time;
* the 12 algorithms of :data:`ALGORITHMS`, batch-major host calls on the
  port's ``GRiD``;
* ``<name>_kernel()``: the lane-major kernel wrapper of
  ``ops/cuda/kernels.py`` bound to the module's model (the
  ``ALGORITHM_kernel`` analog; a CUDA tensor launches the kernel, a CPU
  tensor runs its plain version). A floating-base robot's module binds
  the plain twins instead (``<wrapper>_plain``: the kernels are
  fixed-base), as its ``GRiD`` routes, and leaves the second-order
  algorithms, which raise there, out of its timing table;
* ``<name>_single_timing`` (device seconds per call, CUDA events),
  ``single_timing_table`` and ``compile_all``.

The module imports ``torch``, ``numpy`` and ``gridcodegenerator_tpu_torch``
only, and builds its ``GRiD`` at first use: on the card unless
``configure(device="cpu")`` asked for the CPU, so importing it never needs a
card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..topology.robot import RobotTopology


def _arr(a: np.ndarray, indent: int = 4) -> str:
    """Render a numpy array as a nested-list literal (full precision)."""
    text = np.array2string(
        np.asarray(a), separator=", ", threshold=int(1e9),
        floatmode="unique", max_line_width=79 - indent)
    pad = " " * indent
    return text.replace("\n", "\n" + pad)


ALGORITHMS = [
    # (api name, reference kernel name, args)
    ("id", "inverse_dynamics", "q, qd, qdd=None"),
    ("minv", "direct_minv", "q"),
    ("fd", "forward_dynamics", "q, qd, u"),
    ("aba", "aba", "q, qd, u"),
    ("crba", "crba", "q"),
    ("id_du", "inverse_dynamics_gradient", "q, qd, qdd=None"),
    ("fd_du", "forward_dynamics_gradient", "q, qd, u"),
    ("idsva_so", "idsva_so", "q, qd, qdd=None"),
    ("fdsva_so", "fdsva_so", "q, qd, u"),
    ("eepos", "end_effector_positions", "q"),
    ("deepos", "end_effector_position_gradients", "q"),
    ("d2eepos", "end_effector_position_hessians", "q"),
]

# (algorithm, number of inputs) in the reference's timing-table order
TIMING_SET = [
    ("id", 3), ("minv", 1), ("fd", 3), ("aba", 3), ("crba", 1),
    ("id_du", 3), ("fd_du", 3), ("idsva_so", 3), ("fdsva_so", 3),
    ("eepos", 1), ("deepos", 1), ("d2eepos", 1),
]
SECOND_ORDER = ("idsva_so", "fdsva_so")

# api name -> (its kernel wrapper in ops/cuda/kernels.py, takes gravity);
# the wrapper's name is also the kernel's name in build.LAUNCHES
KERNELS = {
    "id": ("rnea", True), "minv": ("minv", False), "fd": ("fd", True),
    "aba": ("aba", True), "crba": ("crba", False), "id_du": ("id_du", True),
    "fd_du": ("fd_du", True), "idsva_so": ("idsva_so", True),
    "fdsva_so": ("fdsva_so", True), "eepos": ("eepos", False),
    "deepos": ("deepos", False), "d2eepos": ("d2eepos", False),
}


def gen_all_code(
    topo: RobotTopology,
    file_namespace: str = "grid_torch",
    path: Optional[str] = None,
    gravity: float = -9.81,
) -> str:
    """Emit the robot's standalone module; returns the file path.

    Mirrors ``GRiDCodeGenerator(robot).gen_all_code()``: writes
    ``<file_namespace>.py`` to the working directory (or ``path``).
    """
    n = topo.get_num_joints()
    api_doc = "\n".join(f"#   {name}({args})  ->  batched {ref}"
                        for name, ref, args in ALGORITHMS)
    joints_doc = "\n".join(
        f"#   [{j.jid:2d}] {j.name:24s} type={j.jtype:9s} "
        f"parent={j.parent_id:2d} S_ind={j.S_ind}" for j in topo.joints)
    fixed = topo.fixed_joints
    # a floating base runs the plain twins (the kernels are fixed-base)
    twin = "_plain" if topo.floating_base else ""
    # the timing table leaves out the second order where the card has no
    # kernel for it: on a floating base
    timed = [a for a in TIMING_SET
             if not (topo.floating_base and a[0] in SECOND_ORDER)]

    code = f'''"""Generated PyTorch/CUDA dynamics suite for robot {topo.name!r}.

Generated by gridcodegenerator_tpu_torch.codegen.gen_all_code. The robot's
constants below are literals; gridcodegenerator_tpu_torch is the runtime.

API (batch-major (B, dim) or unbatched (dim,) arrays or tensors; see
gridcodegenerator_tpu_torch.api.GRiD):
{api_doc}

Each also has:
#   <name>_kernel()   the lane-major (dim, B) kernel wrapper bound to the
#                     model: a CUDA tensor launches the kernel
#   <name>_single_timing(*args, iters)  device seconds per call

The GRiD behind them is built at first use, on the card unless
configure(device="cpu") asks for the CPU; importing this module touches no
device.

Joints:
{joints_doc}
"""

import functools as _functools

import numpy as _np
import torch as _torch

from gridcodegenerator_tpu_torch.api import GRiD as _GRiD
from gridcodegenerator_tpu_torch.ops.cuda import build as _build
from gridcodegenerator_tpu_torch.ops.cuda import kernels as _k
from gridcodegenerator_tpu_torch.topology.robot import (
    FixedJoint as _FixedJoint, Joint as _Joint,
    RobotTopology as _RobotTopology)
from gridcodegenerator_tpu_torch.utils.timing import time_cuda as _time_cuda

ROBOT_NAME = {topo.name!r}
NUM_JOINTS = {n}
NUM_POS = {topo.get_num_pos()}
NUM_VEL = {topo.get_num_vel()}
NUM_EES = {len(fixed) or len(topo.get_leaf_nodes())}
FLOATING_BASE = {topo.floating_base}
GRAVITY = {gravity}

# ---- robot constants (init_XImats / init_topology_helpers analog) ----
inf = float("inf")  # unset limits render as +/-inf literals
_PARENT = {tuple(int(j.parent_id) for j in topo.joints)}
_S_IND = {tuple(int(j.S_ind) for j in topo.joints)}
_JTYPE = {tuple(j.jtype for j in topo.joints)}
_JNAMES = {tuple(j.name for j in topo.joints)}
_LINKS = {tuple((j.parent_link, j.child_link) for j in topo.joints)}
_DAMPING = {tuple(float(j.damping) for j in topo.joints)}
_LIMITS = _np.array(
    {_arr(topo.get_joint_limits())})
_EFFORT = _np.array(
    {_arr(np.array([j.effort_limit for j in topo.joints]))})
_VELOCITY = _np.array(
    {_arr(np.array([j.velocity_limit for j in topo.joints]))})
_XTREE = _np.array(
    {_arr(np.stack([j.Xtree for j in topo.joints]))})
_TTREE = _np.array(
    {_arr(np.stack([j.Ttree for j in topo.joints]))})
_IMATS = _np.array(
    {_arr(np.stack([topo.get_Imat_by_id(i) for i in range(n)]))})
_BASE_INERTIA = _np.array(
    {_arr(topo.get_Imats_ordered_by_id()[0])})
_FIXED = {tuple((f.name, int(f.parent_jid), f.parent_link, f.child_link)
                for f in fixed)}
_TFIXED = _np.array(
    {_arr(np.stack([f.Ttree for f in fixed]) if fixed
          else np.zeros((0, 4, 4)))})


def init_robot() -> _RobotTopology:
    """Rebuild the topology from the literals (init_robotModel analog)."""
    joints = [
        _Joint(name=_JNAMES[i], jid=i, parent_id=_PARENT[i], jtype=_JTYPE[i],
               S_ind=_S_IND[i], Xtree=_XTREE[i], Ttree=_TTREE[i],
               damping=_DAMPING[i], limit_lower=float(_LIMITS[i, 0]),
               limit_upper=float(_LIMITS[i, 1]),
               effort_limit=float(_EFFORT[i]),
               velocity_limit=float(_VELOCITY[i]),
               parent_link=_LINKS[i][0], child_link=_LINKS[i][1])
        for i in range(NUM_JOINTS)]
    fixed = [
        _FixedJoint(name=nm, fid=k, parent_jid=pj, Ttree=_TFIXED[k],
                    parent_link=pl, child_link=cl)
        for k, (nm, pj, pl, cl) in enumerate(_FIXED)]
    return _RobotTopology(
        name=ROBOT_NAME, joints=joints,
        Imats=[_IMATS[i] for i in range(NUM_JOINTS)],
        base_inertia=_BASE_INERTIA, fixed_joints=fixed,
        floating_base=FLOATING_BASE)


joint_limits = _LIMITS
_CONFIG = {{"device": "cuda", "dtype": _torch.float32}}
_GRID = None


def configure(device="cuda", dtype=_torch.float32):
    """Where and in which dtype the module's GRiD runs, from its next use
    on: the card by default, ``device="cpu"`` for the plain versions."""
    global _GRID
    _CONFIG.update(device=device, dtype=dtype)
    _GRID = None


def grid() -> _GRiD:
    """The module's GRiD, built at first use; without a CUDA device this
    raises unless ``configure(device="cpu")`` came first."""
    global _GRID
    if _GRID is None:
        _GRID = _GRiD(init_robot(), dtype=_CONFIG["dtype"], gravity=GRAVITY,
                      device=_CONFIG["device"])
    return _GRID


def _single_timing(name, args, iters):
    fn = globals()[name + "_kernel"]()
    lanes = tuple(grid()._in(a, _np.shape(a)[-1])[0] for a in args)
    return _time_cuda(lambda: fn(*lanes), iters=iters) / 1e3
'''

    for name, ref, args in ALGORITHMS:
        argnames = ", ".join(a.split("=")[0] for a in args.split(", "))
        wrapper, grav = KERNELS[name]
        bind = ", gravity=GRAVITY" if grav else ""
        code += f'''

def {name}({args}):
    """Batched {ref} (gridcodegenerator_tpu_torch.api.GRiD.{name})."""
    return grid().{name}({argnames})


def {name}_kernel():
    """Kernel tier of {ref} (the ALGORITHM_kernel analog): the lane-major
    wrapper ops/cuda/kernels.py:{wrapper}{twin} bound to the model, over
    (dim, B) tensors of the model's dtype and device."""
    return _functools.partial(_k.{wrapper}{twin}, grid().model{bind})


def {name}_single_timing(*args, iters: int = 100):
    """Device seconds per call of {name}_kernel() on the batch-major
    ``args`` (the _single_timing analog; CUDA events, so the card only)."""
    return _single_timing("{name}", args, iters)
'''

    code += f'''

# (algorithm, number of inputs) in the reference's table order
_TIMING_SET = {timed!r}
'''
    code += '''


def _inputs(batch_size):
    rng = _np.random.default_rng(0)
    q = rng.uniform(-0.5, 0.5, (batch_size, NUM_POS))
    v = rng.uniform(-0.5, 0.5, (batch_size, NUM_VEL))
    return q, v


def single_timing_table(batch_size: int = 256, iters: int = 100):
    """Run every ``*_single_timing`` harness and print the reference's
    "Single Call ..." lines. Returns {name: seconds}."""
    q, v = _inputs(batch_size)
    out = {}
    for name, nargs in _TIMING_SET:
        args = (q,) if nargs == 1 else (q, v, v)
        sec = globals()[name + "_single_timing"](*args, iters=iters)
        out[name] = sec
        print(f"Single Call {name.upper()} {sec * 1e6:.3f}us "
              f"(batch {batch_size}: {sec * 1e6 / batch_size:.4f}us/sample)",
              flush=True)
    return out


def compile_all(batch_size: int = 256):
    """Build the kernels (on the card) and run every algorithm once at
    ``batch_size``; returns the module's GRiD."""
    g = grid()
    if g.device.type == "cuda" and not FLOATING_BASE:
        _build.lib(NUM_JOINTS)
    q, v = _inputs(batch_size)
    for name, nargs in _TIMING_SET:
        globals()[name](*((q,) if nargs == 1 else (q, v, v)))
    if g.device.type == "cuda":
        _torch.cuda.synchronize()
    return g
'''

    out_path = path or (file_namespace + ".py")
    with open(out_path, "w") as fh:
        fh.write(code)
    return out_path
