"""Operation counts and roofline bounds of the port's CUDA kernels.

``ops_per_lane(kernel, model, ...)`` runs one lane of the kernel's lane
code (``csrc/*.cu``) on the host over a counting number type
(``csrc/opcount.cpp``, built with the host C++ compiler at first use into
``build/opcount/<hash of the sources>/``) and returns its floating-point
operations: +, -, *, / and each sin, cos, sqrt, atan2 count one. For the
sweeps a "lane" is one problem over all N knots (the line search: one step
size of one problem). The lane code's work depends on the topology and the
shapes, not on the values, so one lane counts what every lane of a launch
does. By default it counts the arithmetic the function needs: constants
(literals, the robot's constants) folded, IDSVA-SO's D1-D4 formed once
per joint with each product D x computed once, as the reference algorithm
does, and d2eepos and deepos by the cheaper of the chain form and the
kernel's twist form; ``executed=True`` counts every operation the kernel's
lane code does (the thread-group kernels, fd_du, fdsva_so, idsva_so, id_du,
rnea, aba, fd, minv, crba, eepos, deepos, d2eepos, the Riccati sweeps and
the rollouts: every thread of the knot's, lane's, problem's or rollout's
group, phase by phase, as ``HostPar`` runs them),
by the route the card takes in the model's dtype: idsva_so in every band
on its banded route, once on its device-memory tile, fdsva_so's composed
route (fd_du, idsva_so, the contractions) where its fused knot does not
fit. Counted for the zoo's joint counts, a 20-joint chain and atlas with
grippers and with two hands (34 and 52 joints,
``tests/torch_big_robots.py``).

``bound_ms(ops, nbytes, dtype)`` is the least time one NVIDIA H100 SXM could
take for that work: the larger of the bytes over the memory rate and the
operations over the peak rate for the type outside the tensor cores
(NVIDIA's data sheet), with which of the two limits it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

from ..models.model import RobotModel
from ..ops.cuda import build
from ..ops.cuda.sweeps import COST_KINDS

SOURCE = "opcount.cpp"
BUILD_ROOT = build.BUILD_ROOT.parent / "opcount"
# kernel ids of csrc/opcount.cpp
KERNELS = ("rnea", "id_du", "aba", "minv", "fd", "crba", "eepos", "deepos",
           "fd_du", "rollout", "linesearch_rollout", "riccati_factored",
           "riccati", "idsva_so", "fdsva_so", "d2eepos", "feedback_rollout")
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

_lib = None
_lock = threading.Lock()


def _build() -> Path:
    h = hashlib.sha256()
    for name in (SOURCE,) + build.HEADERS + build.SOURCES:
        h.update((build.CSRC / name).read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libopcount.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler: operations cannot be "
                           "counted")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    res = subprocess.run([cxx, "-O0", "-std=c++17", "-shared", "-fPIC", "-I",
                          str(build.CSRC), str(build.CSRC / SOURCE), "-o",
                          str(tmp / lib.name)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"opcount build failed:\n{res.stdout}{res.stderr}")
    try:
        os.replace(tmp, out_dir)
    except OSError:
        if not lib.exists():
            raise
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(_build()))
            fn = handle.gridtorch_opcount
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [I, I, P, P, I, P, I, I, I, I, I, P, P, I]
            fn.restype = ctypes.c_longlong
            _lib = handle
    return _lib


def _host(t):
    return np.ascontiguousarray(t.detach().double().cpu().numpy())


def _count(kernel, model, cost=None, N=0, rank=3, stationary=True,
           executed=False, inputs=None, nout=0):
    model_buf = _host(build.model_buffer(model, 0 if cost is None else
                                         cost.kernel_weights["ee_index"]))
    ee = _host(build.ee_buffer(model))
    flag = int(stationary)
    cbuf = np.zeros(1)
    if kernel == "linesearch_rollout" and cost is None:   # no cost
        flag = COST_KINDS["none"]
    elif kernel == "linesearch_rollout":
        w = cost.kernel_weights
        flag = COST_KINDS[w["kind"]]
        cbuf = np.asarray(w["values"], np.float64)
    elif kernel in ("idsva_so", "fdsva_so"):   # the plan of model's dtype
        flag = int(model.dtype == torch.float32)
    ins = None if inputs is None else np.ascontiguousarray(
        np.concatenate([np.asarray(v, np.float64) for v in inputs]))
    out = np.zeros(max(nout, 1))
    ptr = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    n = lib().gridtorch_opcount(KERNELS.index(kernel), model.n,
                                ptr(model_buf), ptr(ee), ee.shape[0],
                                ptr(cbuf), cbuf.size, N, rank, flag,
                                int(not executed), ptr(ins), ptr(out), nout)
    if n < 0:
        raise ValueError(f"no operation count for {kernel} at {model.n} "
                         f"joints")
    return int(n), out[:nout]


def ops_per_lane(kernel: str, model: RobotModel, cost=None, N: int = 0,
                 rank: int = 3, stationary: bool = True,
                 executed: bool = False) -> int:
    """Floating-point operations of one lane of ``kernel`` (one problem
    over N knots for the sweeps; the EE kernels over every EE of the
    model, the line search with ``cost``, or without a cost where it is
    None): the function's arithmetic, or
    with ``executed`` the lane code's own."""
    return _count(kernel, model, cost, N, rank, stationary, executed)[0]


def so_lane_values(kernel: str, model: RobotModel, q, qd, x,
                   executed: bool = False) -> np.ndarray:
    """The (4, n, n, n) output of the counted ``idsva_so`` or ``fdsva_so``
    lane at one (q, qd, qdd or u), each (n,): what the counted algorithm
    computes, to hold against the plain version."""
    n = model.n
    return _count(kernel, model, executed=executed, inputs=(q, qd, x),
                  nout=4 * n ** 3)[1].reshape(4, n, n, n)


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor among ``objs`` (tuples and lists flattened)."""
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(*o)
    return total


def bound_ms(ops: float, nbytes: float, dtype) -> tuple:
    """(least milliseconds, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
