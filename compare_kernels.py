"""fd_du and fdsva_so of this checkout against those of another, on one card.

    python3 compare_kernels.py --other DIR [--other DIR2 ...]
                               [--out build/compare_kernels.json]

Each DIR is another checkout of this repository (for example the parent
commit, unpacked with ``git archive``), named by its directory. Every
tree's ``csrc/fd_du.cu`` and
``csrc/fdsva_so.cu`` are compiled with nvcc for sm_90a, one library per
joint count and tree, every nvcc at once, with ``-Xptxas -v``; the script
prints each kernel instance's registers, stack, spills and static shared
memory as ptxas reports them, this tree's block plans and
``cudaFuncGetAttributes`` (``build.warp_kernel_info``), and then each
kernel's device time per launch (CUDA events) at the main paths' shapes in
float32, every tree on the same inputs ~ U(-1, 1), in turns: the others,
this, this, the others in reverse. It also checks this tree on every shape
by the float32 rule of ``chip_smoke.py``: against a float64 plain run on
the first 1024 lanes, within 10 x the first other tree's own error plus
1e-5 of the scale. And it clocks this tree's knot programs phase by phase
(csrc/warp.cuh, built into a kernel that wraps each phase in clock64()):
at each shape, the cycles of every phase of knot 0 of block 0, in program
order, and of the whole knot, while the other blocks run as in a launch.
Needs one NVIDIA GPU and nvcc.
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
JOINTS = (2, 7, 8, 12, 16)
SOURCES = ("fd_du.cu", "fdsva_so.cu")
# (kernel, robot, lanes): config 3 and the GRiD API (iiwa 131072 and 1024
# lanes), config 4's N*B lanes (iiwa 32768, the others 16384)
SHAPES = [("fd_du", "iiwa", 131072), ("fd_du", "iiwa", 1024),
          ("fd_du", "iiwa", 32768), ("fd_du", "gym_ant", 16384),
          ("fd_du", "hyq", 16384), ("fd_du", "dm_quadruped", 16384),
          ("fdsva_so", "iiwa", 32768), ("fdsva_so", "iiwa", 1024),
          ("fdsva_so", "gym_ant", 16384), ("fdsva_so", "hyq", 16384),
          ("fdsva_so", "dm_quadruped", 16384)]


# the knot programs with a clock around each phase; knot 0 of block 0 keeps
# its phases' cycles
PHASE_CLOCK_CU = r"""
#include <type_traits>

#include "warp.cuh"

extern __shared__ double gt_smem[];

template <int N>
struct ClockPar {
  static constexpr int LANES = N;
  int lane, bar;
  long long* rec;
  int* count;
  template <class F>
  __device__ void operator()(F&& f) const {
    const long long t0 = clock64();
    f(lane);
    if (N <= 32) __syncwarp();
    else asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(N) : "memory");
    if (rec && lane == 0 && *count < 4096) rec[*count] = clock64() - t0;
    ++*count;
  }
};

template <typename T, int NJ, bool SO>
__global__ void clocked(const T* model, const T* q, const T* qd, const T* u,
                        long long L, T gravity, long long* rec, int* phases,
                        long long* knot) {
  using P = typename std::conditional<SO, gt::SOPlan<T, NJ>,
                                      gt::FDPlan<T, NJ>>::type;
  constexpr int N = P::LANES, S = P::STRIDE;
  auto& H = *reinterpret_cast<gt::SOHead<T, NJ>*>(gt_smem);
  T* knots = reinterpret_cast<T*>(reinterpret_cast<char*>(gt_smem) + P::HEAD);
  const int tid = threadIdx.x, G = blockDim.x / N;
  const long long c0 = clock64();
  H.R.load(model, tid, blockDim.x);
  gt::load_inputs<T, NJ, S>(q, qd, u, L, (long long)blockIdx.x * G, G, knots,
                            tid, blockDim.x);
  __syncthreads();
  if (SO && tid == 0) H.lists.build(H.R);
  __syncthreads();
  const bool first = blockIdx.x == 0 && tid < N;
  int count = 0;
  const ClockPar<N> par{tid % N, 1 + tid / N, first ? rec : nullptr, &count};
  T* k = knots + (long long)(tid / N) * S;
  if (SO) gt::fdsva_so_knot<T, NJ>(par, H.R, H.lists, k, gravity);
  else gt::fd_du_knot<T, NJ>(par, H.R, k, gravity);
  if (first && tid == 0) {
    *phases = count;
    *knot = clock64() - c0;
  }
}

extern "C" int phase_clock(int so, int nj, const void* model, const void* q,
                           const void* qd, const void* u, long long L,
                           long long* rec, int* phases, long long* knot) {
  constexpr int NJ = GT_NJ;
  if (nj != NJ) return (int)cudaErrorInvalidValue;
  using FP = gt::FDPlan<float, NJ>;
  using SP = gt::SOPlan<float, NJ>;
  auto fn = so ? clocked<float, NJ, true> : clocked<float, NJ, false>;
  const int G = so ? SP::G : FP::G, lanes = so ? SP::LANES : FP::LANES;
  const int bytes = (int)(so ? SP::BYTES : FP::BYTES);
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  fn<<<(unsigned)((L + G - 1) / G), lanes * G, bytes>>>(
      (const float*)model, (const float*)q, (const float*)qd,
      (const float*)u, L, -9.81f, rec, phases, knot);
  return (int)cudaGetLastError();
}
"""


def nvcc():
    from gridcodegenerator_tpu_torch.ops.cuda import build
    return build._nvcc(), build.NVCC_FLAGS


def compile_tree(tree: Path, out: Path, clocked: bool = False):
    """{nj: library path}, and the ptxas report of every object; with
    `clocked`, also {nj: phase-clock library path} of the joint counts the
    shapes use."""
    exe, flags = nvcc()
    csrc = tree / "gridcodegenerator_tpu_torch" / "csrc"
    jobs = [(nj, csrc / src) for nj in JOINTS for src in SOURCES]
    clock_joints = (7, 8, 12, 16) if clocked else ()
    if clocked:
        (out / "phase_clock.cu").write_text(PHASE_CLOCK_CU)
        jobs += [(nj, out / "phase_clock.cu") for nj in clock_joints]

    def one(job):
        nj, src = job
        clock = src.name == "phase_clock.cu"
        obj = out / (f"phase_clock{nj}.so" if clock else f"{src.name}.nj{nj}.o")
        r = subprocess.run([exe, *flags, f"-DGT_NJ={nj}", "-Xptxas", "-v",
                            "-I", str(csrc), "-shared" if clock else "-c",
                            str(src), "-o", str(obj)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc {tree.name}/{src.name} nj={nj}:\n"
                               f"{r.stderr}")
        return "" if clock else r.stdout + r.stderr

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        reports = list(pool.map(one, jobs))
    clocks = {nj: out / f"phase_clock{nj}.so" for nj in clock_joints}
    libs = {}
    for nj in JOINTS:
        lib = out / f"lib_nj{nj}.so"
        subprocess.run([exe, *flags, "-shared",
                        *(str(out / f"{src}.nj{nj}.o") for src in SOURCES),
                        "-o", str(lib)], check=True, capture_output=True)
        libs[nj] = lib
    return libs, "\n".join(reports), clocks


def parse_ptxas(text: str) -> dict:
    """{"fd_du f32 nj7": {registers, stack, spill_stores, spill_loads,
    smem}} for the fd_du and fdsva_so kernel instances in ptxas's report."""
    def key(mangled):
        m = re.match(r"_Z\d+(\w+?_kernel)I([fd])Li(\d+)E", mangled)
        if not m or m.group(1) not in ("fd_du_kernel", "fdsva_so_kernel"):
            return None
        return (f"{m.group(1)[:-7]} {'f32' if m.group(2) == 'f' else 'f64'} "
                f"nj{m.group(3)}")

    stats, cur, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = key(m.group(1))
            if cur:
                stats.setdefault(cur, {})
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:   # the entry's own frame, not those of functions it calls
            props = key(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props:
            stats.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            props = None
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            stats[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            stats[cur]["smem"] = int(s.group(1)) if s else 0
            # the entry's frame plus those of the functions it calls
            s = re.search(r"(\d+) bytes cumulative stack size", line)
            if s:
                stats[cur]["cumulative_stack"] = int(s.group(1))
    return stats


def bind(libs: dict, scratch: bool) -> dict:
    P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
    out = {}
    for nj, path in libs.items():
        h = ctypes.CDLL(str(path))
        h.gridtorch_fd_du.argtypes = [I, I, P, P, P, P, P, P, P, L, D, P]
        h.gridtorch_fdsva_so.argtypes = ([I, I, P, P, P, P, P, P, L, D, P]
                                         if scratch else
                                         [I, I, P, P, P, P, P, L, D, P])
        h.gridtorch_fd_du.restype = h.gridtorch_fdsva_so.restype = I
        out[nj] = h
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path, action="append")
    ap.add_argument("--out", default="build/compare_kernels.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("compare_kernels.py needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from gridcodegenerator_tpu_torch.models.model import build_model
    from gridcodegenerator_tpu_torch.models.zoo import load_robot
    from gridcodegenerator_tpu_torch.ops.cuda import build
    from gridcodegenerator_tpu_torch.ops.cuda import kernels as K
    from gridcodegenerator_tpu_torch.utils.timing import time_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"this": ROOT} | {d.resolve().name: d.resolve()
                              for d in args.other}
    others = list(trees)[1:]
    work = Path(tempfile.mkdtemp(prefix="compare-", dir=ROOT / "build"))
    result = {"device": smi, "ptxas": {}, "info": {}, "times": []}
    libs = {}
    for name, tree in trees.items():
        (work / name).mkdir()
        built, report, clocks = compile_tree(tree, work / name,
                                             clocked=name == "this")
        if name == "this":
            clock_libs = {nj: ctypes.CDLL(str(p)) for nj, p in clocks.items()}
        result["ptxas"][name] = parse_ptxas(report)
        scratch = "void* scratch" in (tree / "gridcodegenerator_tpu_torch"
                                      / "csrc" / "fdsva_so.cu").read_text()
        libs[name] = (bind(built, scratch), scratch)
    for nj in JOINTS:
        for dtype in (torch.float32, torch.float64):
            for what in ("fd_du", "fdsva_so"):
                result["info"][f"{what} {str(dtype)[6:]} nj{nj}"] = \
                    build.warp_kernel_info(what, nj, dtype)
    print("ptxas: " + json.dumps(result["ptxas"]), flush=True)
    print("info: " + json.dumps(result["info"]), flush=True)

    dev = torch.device("cuda:0")
    models = {}
    for what, robot, lanes in SHAPES:
        if robot not in models:
            models[robot] = build_model(load_robot(robot),
                                        dtype=torch.float32, device=dev)
        m = models[robot]
        n = m.n
        rng = np.random.default_rng(0)
        q, qd, u = (torch.as_tensor(rng.uniform(-1, 1, (n, lanes)),
                                    dtype=torch.float32, device=dev)
                    for _ in range(3))
        mb = build.model_buffer(m)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = lambda t: t.data_ptr()

        def runner(tree):
            h, scratch = libs[tree]
            lib = h[n]
            if what == "fd_du":
                outs = (torch.empty(n, 2 * n, lanes, device=dev),
                        torch.empty(n, lanes, device=dev),
                        torch.empty(n, n, lanes, device=dev))

                def fn():
                    build.check(lib.gridtorch_fd_du(
                        0, n, ptr(mb), ptr(q), ptr(qd), ptr(u),
                        *map(ptr, outs), lanes, -9.81, stream), what)
                return fn, outs
            outs = (torch.empty(4, n, n, n, lanes, device=dev),)
            extra = ((torch.empty(4, n, n, n, lanes, device=dev),)
                     if scratch else ())

            def fn():
                build.check(lib.gridtorch_fdsva_so(
                    0, n, ptr(mb), ptr(q), ptr(qd), ptr(u), ptr(outs[0]),
                    *map(ptr, extra), lanes, -9.81, stream), what)
            return fn, outs

        run = {tree: runner(tree) for tree in trees}
        for fn, _ in run.values():
            fn()
        torch.cuda.synchronize()
        m64 = m.to(dtype=torch.float64)
        plain = getattr(K, f"{what}_plain")
        sub = slice(0, min(lanes, 1024))
        ref64 = plain(m64, q[:, sub].double(), qd[:, sub].double(),
                      u[:, sub].double())
        ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        err = {tree: max(float((o[..., sub].double() - r).abs().max())
                         for o, r in zip(outs, ref64))
               for tree, (_, outs) in run.items()}
        scale = max(1.0, max(float(r.abs().max()) for r in ref64))
        if not err["this"] <= 10 * err[others[0]] + 1e-5 * scale:
            raise AssertionError(f"{what} {robot} L={lanes}: this tree's "
                                 f"error vs float64 {err}")
        iters = 20 if lanes <= 32768 else 10
        order = others + ["this", "this"] + others[::-1]
        ms = {tree: [] for tree in trees}
        for tree in order:
            ms[tree].append(time_cuda(run[tree][0], iters=iters))
        rec = torch.zeros(4096, dtype=torch.int64, device=dev)
        phases = torch.zeros(1, dtype=torch.int32, device=dev)
        knot = torch.zeros(1, dtype=torch.int64, device=dev)
        build.check(clock_libs[n].phase_clock(
            ctypes.c_int(what == "fdsva_so"), ctypes.c_int(n),
            ctypes.c_void_p(ptr(mb)), ctypes.c_void_p(ptr(q)),
            ctypes.c_void_p(ptr(qd)), ctypes.c_void_p(ptr(u)),
            ctypes.c_longlong(lanes), ctypes.c_void_p(ptr(rec)),
            ctypes.c_void_p(ptr(phases)), ctypes.c_void_p(ptr(knot))),
            "phase clock")
        torch.cuda.synchronize()
        nph = int(phases.item())
        row = {"kernel": what, "robot": robot, "joints": n, "lanes": lanes,
               "ms": ms, "err_vs_f64_first_1024": err,
               "knot_cycles": int(knot.item()),
               "phase_cycles": rec[:min(nph, 4096)].tolist()}
        result["times"].append(row)
        print("time: " + json.dumps(row), flush=True)
        del run
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
