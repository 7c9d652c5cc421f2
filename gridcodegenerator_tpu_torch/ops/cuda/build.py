"""Build, load and launch the port's hand-written CUDA kernels.

The counterpart of ``gridcodegenerator_tpu/ops/pallas/fuse.py``: where the
JAX package tiles a batch axis over a Pallas grid and keeps the robot
constants resident in VMEM, the port runs a group of threads per problem
lane (fd_du, fdsva_so, idsva_so, id_du, rnea, aba, fd, minv, crba, eepos,
deepos and d2eepos: a warp or a part of one per lane; the Riccati sweeps a
warp per problem; linesearch_rollout, rollout and feedback_rollout a group
of threads per rollout; the constants copied into shared memory once a
block), masks the ragged last block, and
hands the robot constants over in one packed device buffer
(:func:`model_buffer`; the end-effector kernels also take one row per EE,
:func:`ee_buffer`).

The sources under ``gridcodegenerator_tpu_torch/csrc/`` are compiled with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface per
joint count (``-DGT_NJ=<n>``; float and double), at first use, into
``build/torch_kernels/nj<n>-<hash of the sources>/`` at the root of the
checkout, and loaded with ``ctypes``. Every C entry point launches on the
stream it is given, allocates nothing, and returns ``cudaGetLastError()``.
Nothing here is imported or built until a kernel is launched on a CUDA
tensor.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ...models.model import RobotModel
from ..eepose import ee_chains

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = ("fd_du.cu", "rollout.cu", "linesearch.cu", "riccati.cu", "rnea.cu",
           "id_du.cu", "aba.cu", "minv.cu", "fd.cu", "crba.cu", "eepos.cu",
           "deepos.cu", "idsva_so.cu", "fdsva_so.cu", "d2eepos.cu",
           "feedback_rollout.cu")
HEADERS = ("dynamics.cuh", "so.cuh", "warp.cuh", "sweep_warp.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
LIB_NAME = "libgridtorch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# One library per joint count (csrc/dynamics.cuh: GT_DISPATCH, GT_NJ), float
# and double. build() prebuilds SUPPORTED_JOINTS, the zoo's counts of the
# configs; lib(nj) builds any count from 1 to MAX_JOINTS at its first use.
# Every kernel runs at every count up to it: where a knot or problem does
# not fit a block's shared memory (id_du, riccati_factored; minv and fd in
# float64), its state goes to device memory (warp.cuh: WsPlan), fd_du's
# knot and the dense riccati's problem stay on chip in a block or a
# thread-block cluster (warp.cuh: FDChipPlan, sweep_warp.cuh: RicChipPlan),
# the rollouts' tiles too where theirs do not fit (sweep_warp.cuh:
# TILES_WS), and idsva_so's tile where bands would not do (warp.cuh:
# IDSOTilePlan; fdsva_so is composed there). 64 bounds the plans'
# constants: a joint set is one 64-bit word (warp.cuh: JointBits), and at
# 64 joints in float64 the rollouts' head and one rollout (177 KB) still
# fit a block beside nothing else.
SUPPORTED_JOINTS = (2, 7, 8, 12, 16, 17, 28)
MAX_JOINTS = 64
DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

# launches per kernel since the last reset: each wrapper adds one right after
# its kernel launched, and nowhere else
LAUNCHES = collections.Counter()
# calls of each kernel's plain PyTorch version
PLAIN_CALLS = collections.Counter()
# seconds of nvcc (its compile jobs summed) of each library built by this
# process, by joint count
NVCC_SECONDS = {}

_libs = {}
_lib_lock = threading.Lock()


def reset_counters():
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def _flags(nj: int) -> tuple:
    return NVCC_FLAGS + (f"-DGT_NJ={nj}",)


def _lib_path(nj: int) -> Path:
    """Where the library of ``nj`` joints lives: keyed by the sources and
    the flags."""
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(_flags(nj)).encode())
    return BUILD_ROOT / f"nj{nj}-{h.hexdigest()[:16]}" / LIB_NAME


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(joints=SUPPORTED_JOINTS, verbose: bool = False) -> dict:
    """Compile the library of each joint count in ``joints`` that is not
    built for the current sources yet; ``{joint count: library path}``.

    Every (joint count, source) pair is one ``nvcc -c``, and all of them
    run in one pool of ``os.cpu_count()`` processes, the most joints
    first; then each library links from its objects and moves into place
    atomically. Each built library's seconds go into ``NVCC_SECONDS``.
    """
    libs = {nj: _lib_path(nj) for nj in joints}
    todo = sorted((nj for nj, lib in libs.items() if not lib.exists()),
                  reverse=True)
    if not todo:
        return libs
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = {nj: Path(tempfile.mkdtemp(prefix=f"build-nj{nj}-", dir=BUILD_ROOT))
           for nj in todo}
    extra = ("-Xptxas", "-v") if verbose else ()

    def run(cmd):
        t = time.perf_counter()
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        return res, time.perf_counter() - t

    def compile_one(job):
        nj, src = job
        return run([nvcc, *_flags(nj), *extra, "-I", str(CSRC), "-c",
                    str(CSRC / src), "-o", str(tmp[nj] / (src + ".o"))])

    def link(nj):
        return run([nvcc, *_flags(nj), "-shared",
                    *(str(tmp[nj] / (src + ".o")) for src in SOURCES), "-o",
                    str(tmp[nj] / LIB_NAME)])

    jobs = [(nj, src) for nj in todo for src in SOURCES]
    took = collections.Counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for (nj, src), (res, sec) in zip(jobs, pool.map(compile_one, jobs)):
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({nj} joints):\n"
                                   f"{res.stdout}")
            if verbose and res.stdout:
                print(f"[nvcc {src}, {nj} joints]\n{res.stdout}", flush=True)
            took[nj] += sec
        for nj, (res, _) in zip(todo, pool.map(link, todo)):
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({nj} joints):\n"
                                   f"{res.stdout}")
            NVCC_SECONDS[nj] = took[nj]
    for nj in todo:
        try:
            os.replace(tmp[nj], libs[nj].parent)
        except OSError:
            if not libs[nj].exists():   # another process finished first
                raise
            shutil.rmtree(tmp[nj], ignore_errors=True)
    return libs


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# the kernels with a device-memory route (minv, fd, the line search, the
# feedback rollout) take its workspace and blocks last (workspace(); None,
# 0 on the shared-memory route); fd_du takes the two and ignores them;
# the Riccati sweeps take there the problem-major copy of their
# inputs and its values where they run on chip
_SIGNATURES = {
    "gridtorch_model_size": (_I,),
    "gridtorch_fd_du": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _L, _D, _P, _P,
                        _L),
    "gridtorch_rnea": (_I, _I, _P, _P, _P, _P, _P, _L, _D, _P),
    "gridtorch_id_du": (_I, _I, _P, _P, _P, _P, _P, _L, _D, _P),
    "gridtorch_aba": (_I, _I, _P, _P, _P, _P, _P, _L, _D, _P),
    "gridtorch_minv": (_I, _I, _P, _P, _P, _L, _I, _P, _P, _L),
    "gridtorch_fd": (_I, _I, _P, _P, _P, _P, _P, _L, _D, _P, _P, _L),
    "gridtorch_crba": (_I, _I, _P, _P, _P, _L, _P),
    "gridtorch_eepos": (_I, _I, _P, _P, _I, _P, _P, _L, _P),
    "gridtorch_deepos": (_I, _I, _P, _P, _I, _P, _P, _L, _P),
    "gridtorch_rollout": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _L, _D, _D, _P),
    "gridtorch_linesearch": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _I, _L, _I, _D, _D, _I, _P, _P,
                             _P, _L),
    "gridtorch_riccati_factored": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _I, _L, _I, _D, _D, _D, _P, _P, _L),
    "gridtorch_riccati": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                          _P, _I, _L, _D, _P, _P, _L),
    "gridtorch_riccati_inputs": (_I, _I, _I, _I),
    "gridtorch_riccati_factored_inputs": (_I, _I, _I),
    "gridtorch_idsva_so": (_I, _I, _P, _P, _P, _P, _P, _L, _D, _P, _P, _I,
                           _I),
    "gridtorch_so_lists": (_I, _P, _P, _P),
    "gridtorch_fdsva_so": (_I, _I, _P, _P, _P, _P, _P, _L, _D, _P),
    "gridtorch_fd_du_info": (_I, _I, _P),
    "gridtorch_fdsva_so_info": (_I, _I, _P),
    "gridtorch_riccati_factored_info": (_I, _I, _P),
    "gridtorch_linesearch_info": (_I, _I, _P),
    "gridtorch_riccati_info": (_I, _I, _P),
    "gridtorch_riccati_stacked_info": (_I, _I, _P),
    "gridtorch_rollout_info": (_I, _I, _P),
    "gridtorch_idsva_so_info": (_I, _I, _P),
    "gridtorch_feedback_rollout_info": (_I, _I, _P),
    "gridtorch_id_du_info": (_I, _I, _P),
    "gridtorch_d2eepos_info": (_I, _I, _P),
    "gridtorch_rnea_info": (_I, _I, _P),
    "gridtorch_aba_info": (_I, _I, _P),
    "gridtorch_fd_info": (_I, _I, _P),
    "gridtorch_eepos_info": (_I, _I, _P),
    "gridtorch_minv_info": (_I, _I, _P),
    "gridtorch_crba_info": (_I, _I, _P),
    "gridtorch_deepos_info": (_I, _I, _P),
    "gridtorch_d2eepos": (_I, _I, _P, _P, _I, _P, _P, _L, _P),
    "gridtorch_feedback_rollout": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _I, _L, _D, _D, _P, _P, _L),
}

# the entry points that return a count, not a cudaError
_RESTYPES = {"gridtorch_riccati_inputs": _L,
             "gridtorch_riccati_factored_inputs": _L}


def check_joints(nj: int, what: str = "CUDA kernels"):
    """Raise NotImplementedError, before any nvcc, for a joint count no
    library can be built for."""
    if not 1 <= nj <= MAX_JOINTS:
        raise NotImplementedError(
            f"{what}: no CUDA kernel library for {nj} joints (1 to "
            f"{MAX_JOINTS}: the kernels' plans hold a joint set in one 64-bit "
            f"word, and at {MAX_JOINTS} joints in float64 a rollout block's "
            f"robot constants and one rollout fill most of a block's shared "
            f"memory)")


def lib(nj: int) -> ctypes.CDLL:
    """The loaded kernel library of ``nj`` joints, built on first use (its
    nvcc seconds go into ``NVCC_SECONDS``)."""
    check_joints(nj)
    with _lib_lock:
        if nj not in _libs:
            handle = ctypes.CDLL(str(build((nj,))[nj]))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _libs[nj] = handle
    return _libs[nj]


INFO_FIELDS = ("knots_per_block", "threads_per_knot", "smem_bytes_per_block",
               "registers", "local_bytes", "static_smem_bytes",
               "max_threads_per_block", "max_dynamic_smem_bytes",
               "rows_per_block", "blocks_per_sm", "bands", "workspace_bytes",
               "device_tile", "cluster_blocks")
# the kernels of a thread group per knot, problem or rollout, by the name of
# their C info entry point (riccati: the dense sweep's stationary instance,
# riccati_stacked: its instance with a block per knot)
WARP_KERNELS = ("fd_du", "fdsva_so", "riccati_factored", "linesearch",
                "riccati", "riccati_stacked", "rollout", "idsva_so",
                "feedback_rollout", "id_du", "d2eepos", "rnea", "aba", "fd",
                "eepos", "minv", "crba", "deepos")


def warp_kernel_info(what: str, nj: int, dtype) -> dict:
    """The block plan and ``cudaFuncGetAttributes`` of the ``nj``-joint
    ``dtype`` instance of the thread-group kernel ``what`` (one of
    ``WARP_KERNELS``): {knots_per_block (problems a block; 0: one knot does
    not fit), threads_per_knot, smem_bytes_per_block (the line search: at
    the most rows), registers, local_bytes, ..., rows_per_block (the line
    search's step-size rows a block at most; 1 for the others),
    blocks_per_sm (the occupancy calculator's, at the plan's block), bands
    (blocks a lane: idsva_so's bands where one knot's whole tile does not
    fit; else 1), workspace_bytes (device memory a block takes on the
    device-memory route: its knot, or the rollouts' tiles; 0 where all of
    it sits in shared memory), device_tile (1 where each knot's output
    tile accumulates in device memory, in the output itself: idsva_so
    where bands would not do), cluster_blocks (blocks a problem: a
    thread-block cluster's where one problem's state sits on chip across
    the cluster's shared memory, csrc/warp.cuh: ChipPack; else 1)}.
    fdsva_so's plan where its knot does not fit a block comes without its
    kernel's attributes: that kernel is not built."""
    if what not in WARP_KERNELS:
        raise ValueError(f"no block plan for {what!r}")
    out = (ctypes.c_int * len(INFO_FIELDS))()
    err = getattr(lib(nj), f"gridtorch_{what}_info")(DTYPE_CODES[dtype], nj,
                                                     out)
    check(err, f"{what} info")
    return dict(zip(INFO_FIELDS, out))


_plans = {}


def plan(what: str, nj: int, dtype) -> dict:
    """``warp_kernel_info(what, nj, dtype)``, read once a process."""
    key = what, nj, dtype
    if key not in _plans:
        _plans[key] = warp_kernel_info(what, nj, dtype)
    return _plans[key]


def fits(what: str, nj: int, dtype, kernel: str = None):
    """Raise, before any launch, if one knot (problem, rollout) of the
    thread-group kernel ``what`` (one of ``WARP_KERNELS``; its plan read once
    a process) does not fit a block's shared memory at ``nj`` joints in
    ``dtype`` and the kernel has no device-memory route there. ``kernel``
    names the kernel in the message."""
    p = plan(what, nj, dtype)
    if p["knots_per_block"] < 1 and not p.get("workspace_bytes"):
        raise RuntimeError(
            f"{kernel or what}: one {nj}-joint {dtype} knot needs "
            f"{p['smem_bytes_per_block']} B of shared memory, more than "
            f"a block may use")


def workspace(what: str, nj: int, like: torch.Tensor, units: int):
    """The device-memory workspace of the thread-group kernel ``what`` at
    ``nj`` joints for ``units`` lanes, problems or blocks, in the dtype and
    on the device of ``like``: (tensor, blocks), sized by the blocks in
    flight (the occupancy calculator's blocks an SM times the card's SMs,
    at most ``units``), a block's workspace_bytes each; (None, 0) where the
    plan keeps everything in shared memory. The caller holds the tensor
    until the kernel is launched."""
    p = plan(what, nj, like.dtype)
    per = p["workspace_bytes"]
    if per == 0 or units == 0:
        return None, 0
    sms = torch.cuda.get_device_properties(like.device).multi_processor_count
    blocks = min(units, max(1, p["blocks_per_sm"]) * sms)
    ws = torch.empty(blocks * per // like.element_size(), dtype=like.dtype,
                     device=like.device)
    return ws, blocks


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def require(tensors, dtype, device, what: str):
    """Kernels take contiguous tensors of one dtype on one CUDA device."""
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{what}: {name} must be on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def kernel_key(model: RobotModel, like: torch.Tensor, what: str):
    """(dtype code, joint count) of the kernel instance for ``model`` and
    tensors like ``like``, or raise."""
    dtype = like.dtype
    if model.dtype != dtype or model.device != like.device:
        raise ValueError(f"{what}: model is {model.dtype} on {model.device}, "
                         f"inputs are {dtype} on {like.device}")
    if model.floating_base:
        raise NotImplementedError(f"{what}: CUDA kernels are fixed-base")
    if any(j not in ("revolute", "prismatic") for j in model.jtype):
        raise NotImplementedError(f"{what}: CUDA kernels take 1-dof joints "
                                  f"(revolute, prismatic) only")
    check_joints(model.n, f"{what} ({model.name!r})")
    if dtype not in DTYPE_CODES:
        raise NotImplementedError(f"{what}: no CUDA kernel for {dtype}")
    return DTYPE_CODES[dtype], model.n


def _ee_row(model: RobotModel, chain, fid):
    """(Tfixed (16,), chain mask (n,)) of one EE, float64 on the host."""
    Tfix = (model.Tfixed[fid].double().cpu().numpy() if fid is not None
            else np.eye(4))
    mask = np.zeros(model.n)
    mask[list(chain)] = 1.0
    return Tfix.ravel(), mask


def _cached(cache: dict, model: RobotModel, key, make):
    """``make()`` once per (model, key); the model is held so that its id
    cannot be reused while the entry lives."""
    hit = cache.get((id(model), key))
    if hit is not None and hit[0] is model:
        return hit[1]
    buf = make()
    cache[id(model), key] = (model, buf)
    return buf


_model_buffers = {}
_ee_buffers = {}
_cost_buffers = {}


def model_buffer(model: RobotModel, ee_index: int = 0) -> torch.Tensor:
    """The robot constants in the packed layout of ``csrc/dynamics.cuh``
    (``Layout<NJ>``), on the model's device and in its dtype.

    Xtree (n,6,6) | Imat (n,6,6) | damping (n) | Ttree (n,4,4) | Tfixed of
    EE ``ee_index`` (4,4; identity without one) | parent (n) | S_ind (n) |
    joint type (n; 0 revolute, 1 prismatic) | EE chain mask (n) |
    subtree mask (n,n).
    """
    def make():
        Tfix, mask = _ee_row(model, *ee_chains(model)[ee_index])
        host = lambda t: t.detach().double().cpu().numpy().ravel()
        parts = [host(model.Xtree), host(model.Imat), host(model.damping),
                 host(model.Ttree), Tfix,
                 np.asarray(model.parent, np.float64),
                 np.asarray(model.S_ind, np.float64),
                 np.asarray([0.0 if j == "revolute" else 1.0
                             for j in model.jtype]),
                 mask, host(model.subtree_mask)]
        flat = np.concatenate(parts)
        if model.device.type == "cuda":
            expect = lib(model.n).gridtorch_model_size(model.n)
            if flat.size != expect:
                raise RuntimeError(f"packed model has {flat.size} values, "
                                   f"the kernels expect {expect}")
        return torch.as_tensor(flat, dtype=model.dtype, device=model.device)
    return _cached(_model_buffers, model, ee_index, make)


def ee_buffer(model: RobotModel, targets=None) -> torch.Tensor:
    """One row per EE of ``ee_chains(model, targets)`` in the layout of
    ``csrc/dynamics.cuh`` (``EERow<NJ>``): its Tfixed (4,4; identity
    without a fixed frame) | its chain mask (n). (num_ees, 16 + n), on the
    model's device and in its dtype."""
    targets = None if targets is None else tuple(targets)

    def make():
        rows = [np.concatenate(_ee_row(model, chain, fid))
                for chain, fid in ee_chains(model, targets)]
        flat = np.asarray(rows, np.float64).reshape(len(rows), 16 + model.n)
        return torch.as_tensor(flat, dtype=model.dtype, device=model.device)
    return _cached(_ee_buffers, model, targets, make)


_so_lists = {}


def so_lists(model: RobotModel):
    """The robot's IDSVA-SO work lists for the idsva_so kernel's
    device-memory tile (``csrc/warp.cuh``: ``SOListView``): (int32 tensor on
    the model's device, ntrip, npair), the (j, a, st) triples packed
    j | a << 8 | st << 16, then the (j, a) pairs packed j | a << 8, as
    ``SOLists`` builds them (the library's ``gridtorch_so_lists``, on the
    host, from the packed model); cached per model."""
    def make():
        n = model.n
        flat = model_buffer(model).detach().to("cpu", torch.float64)
        out = torch.empty(n * (n + 1) * (n + 2) // 6 + n * (n + 1) // 2,
                          dtype=torch.int32)
        counts = torch.zeros(2, dtype=torch.int32)
        check(lib(n).gridtorch_so_lists(n, ptr(flat), ptr(out), ptr(counts)),
              "so_lists")
        ntrip, npair = map(int, counts)
        return out[:ntrip + npair].to(model.device), ntrip, npair
    return _cached(_so_lists, model, None, make)


def cost_buffer(cost, like: torch.Tensor) -> torch.Tensor:
    """The line-search kernel's cost constants (``cost.kernel_weights``
    values, in the layout of ``csrc/linesearch.cu``) in the dtype and on the
    device of ``like``; cached per cost, dtype and device."""
    def make():
        return torch.as_tensor(cost.kernel_weights["values"], dtype=like.dtype,
                               device=like.device)
    return _cached(_cost_buffers, cost, (like.dtype, like.device), make)
