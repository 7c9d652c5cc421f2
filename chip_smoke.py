"""On-card smoke test of the PyTorch/CUDA port: configs 3, 1 and 2 end to end,
and the rest of the GRiD API's first-order calls.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one line each:
  0. device: fail without CUDA; print the card's name and power limit;
  1. build: compile the CUDA kernels from gridcodegenerator_tpu_torch/csrc;
  2. each kernel against its plain PyTorch version on the same CUDA inputs,
     iiwa at small B and N (37 lanes: a ragged block), float64: max abs
     error <= 1e-9; and every GRiD kernel case on hyq (12 joints, branched,
     4 EEs);
  3. the same in float32 (tolerances below), with each kernel's and plain
     version's device time from CUDA events: the config-3 kernels at
     config-3 shapes, the GRiD kernels (rnea, id_du, aba, minv, fd, crba,
     eepos, deepos) at 1024 and 131072 lanes;
  4. config 3 (iiwa, N=64, 5 iterations, B=2048, float32, EE reach) through
     the port's make_ilqr with kernels: every kernel of the path launched,
     nothing plain ran, costs finite and decreasing, final costs agree with
     a plain solve of the same inputs; solves/s over 10 solves;
  5. configs 1 and 2 (iiwa, float32) through the port's GRiD: id and id_du
     unbatched and at B=1024, aba, fd_du and minv at B=1024; then fd, crba,
     eepos and deepos unbatched and at B=1024, and hyq's eepos at B=1024;
     each call launched exactly its kernel and nothing plain ran; outputs
     agree with a float64 plain GRiD on the same inputs; fk (plain torch,
     no kernel) agrees too; µs per call and evals/s.
Then a JSON line of per-kernel results, and last the device line.
Any failure raises, so the exit code is non-zero and no result is printed.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

N, ITERS, B, DT = 64, 5, 2048, 0.01
GRAVITY = -9.81
DEVICE = torch.device("cuda:0")

# Phase 3 judges each float32 kernel against a float64 run of its plain
# version on the same inputs and the same (float32-rounded) robot constants:
# per output (and per step-size row of the line search), the kernel's error
# must stay within F32_FACTOR times the plain float32 version's own error,
# plus F32_FLOOR of the output's scale max(1, max|ref|). A direct kernel-vs-plain bound would measure how well
# conditioned the inputs are, not the kernel: at config 3 the alpha = 1
# line-search row is an unstable closed loop (rounding grows ~1e9-fold over
# the 64 steps even in float64), and the Riccati gains come from
# Gauss-Jordan on Quu + reg I with luu = w_u I = 1e-4 I, where float32
# pivots lose about log10(cond(Quu)) digits. Both sides round in float32 but
# sum in other orders (and the card contracts into FMAs).
F32_FACTOR = 10.0
F32_FLOOR = 1e-5


def line(tag, obj):
    print(f"{tag}: {json.dumps(obj)}", flush=True)


def max_err(out, ref):
    """Max abs difference over paired outputs."""
    return max(float((o.double() - r.double()).abs().max())
               for o, r in zip(out, ref))


def main():
    # -- phase 0: device ---------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = DEVICE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gridcodegenerator_tpu_torch.api import GRiD
    from gridcodegenerator_tpu_torch.models.model import build_model
    from gridcodegenerator_tpu_torch.models.zoo import load_robot
    from gridcodegenerator_tpu_torch.ops import eepose
    from gridcodegenerator_tpu_torch.ops.cuda import build
    from gridcodegenerator_tpu_torch.ops.cuda import kernels as K
    from gridcodegenerator_tpu_torch.ops.cuda import sweeps as S
    from gridcodegenerator_tpu_torch.trajopt.cost import EEReachCost
    from gridcodegenerator_tpu_torch.trajopt.ilqr import (
        ILQRConfig, make_ilqr, resolve_control_bounds)
    from gridcodegenerator_tpu_torch.utils.timing import time_cuda

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    build.lib()
    line("build", {"seconds": round(time.perf_counter() - t0, 3),
                   "library": str(build.build().relative_to(
                       build.BUILD_ROOT.parents[1]))})

    topo = load_robot("iiwa")

    def path_inputs(model, n_knots, batch, seed):
        """Each kernel's inputs as the solver's first iteration makes them,
        from x0 ~ U(-0.2, 0.2) and U0 = 0 (computed with the plain ops)."""
        n = model.n
        goal = eepose.eepos(model, torch.full((n, 1), 0.5, dtype=model.dtype,
                                              device=dev))[:3, 0]
        cost = EEReachCost(model=model, goal_xyz=goal, w_pos=0.5,
                           w_pos_f=200.0)
        cfg = ILQRConfig(N=n_knots, dt=DT, iters=ITERS, use_kernels=False)
        _, parts = make_ilqr(model, cost, cfg, expose_parts=True)
        rng = np.random.default_rng(seed)
        x0 = torch.as_tensor(rng.uniform(-0.2, 0.2, (2 * n, batch)),
                             dtype=model.dtype, device=dev)
        U0 = torch.zeros((n_knots, n, batch), dtype=model.dtype, device=dev)
        X = parts["rollout"](x0, U0)
        fold = lambda Z: Z.transpose(0, 1).reshape(Z.shape[1], -1)
        q, qd, u = fold(X[:n_knots, :n]), fold(X[:n_knots, n:]), fold(U0)
        A, Bm = parts["linearize"](X[:n_knots], U0)
        _, Vx0, Vxx0 = cost.terminal_expansion(X[n_knots])
        Jw, lx, lu = cost.gn_stage_factor(fold(X[:n_knots]), fold(U0))
        ric = [A, Bm, lx.contiguous(), lu.contiguous(), Jw.contiguous(),
               Vx0.contiguous(), Vxx0.contiguous(), cfg.reg, *cost.gn_factor_diags]
        ks, Ks = S.riccati_factored_plain(*ric)
        lo, hi = resolve_control_bounds(model, cfg)
        al = torch.tensor(cfg.alphas, dtype=model.dtype, device=dev)[:, None]
        al = al.repeat(1, batch)
        return {
            "fd_du": (model, q, qd, u, GRAVITY),
            "rollout": (model, x0, U0, DT, GRAVITY, lo, hi),
            "riccati_factored": tuple(ric),
            "linesearch_rollout": (model, X[0].contiguous(), U0,
                                   X[:n_knots].contiguous(), ks, Ks, al, DT,
                                   GRAVITY, lo, hi, cost),
        }

    kernels = {
        "fd_du": (K.fd_du, K.fd_du_plain, K.SOURCES[K.FD_DU],
                  K.REPLACES[K.FD_DU]),
        "rollout": (S.rollout, S.rollout_plain, S.SOURCES[S.ROLLOUT],
                    S.REPLACES[S.ROLLOUT]),
        "riccati_factored": (S.riccati_factored, S.riccati_factored_plain,
                             S.SOURCES[S.RICCATI], S.REPLACES[S.RICCATI]),
        "linesearch_rollout": (S.linesearch_rollout,
                               S.linesearch_rollout_plain,
                               S.SOURCES[S.LINESEARCH],
                               S.REPLACES[S.LINESEARCH]),
    }

    # the GRiD API's kernels, and their cases: rnea with and without qdd,
    # minv dense and upper; fd_du's cases (config 3's kernel) run in phase
    # 2 on hyq only
    grid_kernels = {name: (getattr(K, name), getattr(K, name + "_plain"),
                           K.SOURCES[name], K.REPLACES[name])
                    for name in (K.RNEA, K.ID_DU, K.ABA, K.MINV, K.FD,
                                 K.CRBA, K.EEPOS, K.DEEPOS)}
    case_kernel = {"rnea": "rnea", "rnea_bias": "rnea", "id_du": "id_du",
                   "aba": "aba", "minv": "minv", "minv_upper": "minv",
                   "fd": "fd", "crba": "crba", "eepos": "eepos",
                   "deepos": "deepos", "fd_du": "fd_du"}
    case_fns = {name: fns[:2] for name, fns in grid_kernels.items()} | {
        "fd_du": (K.fd_du, K.fd_du_plain)}

    def lane_cases(model, lanes, seed, with_fd_du=False):
        """Each GRiD kernel case on (n, lanes) inputs ~ U(-1, 1), as
        bench.py makes them."""
        rng = np.random.default_rng(seed)
        q, qd, x = (torch.as_tensor(rng.uniform(-1, 1, (model.n, lanes)),
                                    dtype=model.dtype, device=dev)
                    for _ in range(3))
        cases = {"rnea": (model, q, qd, x, GRAVITY),
                 "rnea_bias": (model, q, qd, None, GRAVITY),
                 "id_du": (model, q, qd, x, GRAVITY),
                 "aba": (model, q, qd, x, GRAVITY),
                 "minv": (model, q, True),
                 "minv_upper": (model, q, False),
                 "fd": (model, q, qd, x, GRAVITY),
                 "crba": (model, q),
                 "eepos": (model, q),
                 "deepos": (model, q)}
        if with_fd_du:
            cases["fd_du"] = (model, q, qd, x, GRAVITY)
        return cases

    def as_tuple(o):
        return tuple(t for t in (o if isinstance(o, tuple) else (o,))
                     if t is not None)

    # -- phase 2: small float64 --------------------------------------------
    m64 = build_model(topo, dtype=torch.float64, device=dev)
    ins = path_inputs(m64, 8, 37, seed=1)
    small = {}
    for name, (kern, plain, _, _) in kernels.items():
        args = ins[name]
        out, ref = as_tuple(kern(*args)), as_tuple(plain(*args))
        torch.cuda.synchronize()
        if len(out) != len(ref) or any(o.shape != r.shape
                                       for o, r in zip(out, ref)):
            raise AssertionError(f"{name}: kernel and plain outputs differ "
                                 f"in number or shape")
        err = max_err(out, ref)
        small[name] = err
        if not err <= 1e-9:
            raise AssertionError(f"{name} float64: max abs err {err} > 1e-9")
    hyq64 = build_model(load_robot("hyq"), dtype=torch.float64, device=dev)
    small_hyq = {}
    for errs, cases in ((small, lane_cases(m64, 37, seed=1)),
                        (small_hyq, lane_cases(hyq64, 37, seed=1,
                                               with_fd_du=True))):
        for case, args in cases.items():
            kern, plain = case_fns[case_kernel[case]]
            out, ref = as_tuple(kern(*args)), as_tuple(plain(*args))
            torch.cuda.synchronize()
            what = f"{args[0].name} {case}"
            if len(out) != len(ref) or any(o.shape != r.shape
                                           for o, r in zip(out, ref)):
                raise AssertionError(f"{what}: kernel and plain outputs "
                                     f"differ in number or shape")
            err = max_err(out, ref)
            errs[case] = err
            if not err <= 1e-9:
                raise AssertionError(f"{what} float64: max abs err {err} "
                                     f"> 1e-9")
            if case == "minv_upper" and bool(
                    out[0].permute(2, 0, 1).tril(-1).any()):
                raise AssertionError(f"{what}: nonzero below the diagonal")
    line("small_f64", {"robot": "iiwa", "N": 8, "B": 37,
                       "max_abs_err": small, "tol": 1e-9})
    line("small_f64_hyq", {"robot": "hyq", "joints": hyq64.n,
                           "ees": build.ee_buffer(hyq64).shape[0],
                           "B": 37, "max_abs_err": small_hyq, "tol": 1e-9})

    # -- phase 3: config-3 shapes, float32 ----------------------------------
    m32 = build_model(topo, dtype=torch.float32, device=dev)
    m32_64 = m32.to(dtype=torch.float64)

    def to64(a):
        if isinstance(a, torch.Tensor):
            return a.double()
        if isinstance(a, EEReachCost):
            return dataclasses.replace(a, model=m32_64,
                                       goal_xyz=a.goal_xyz.double())
        return m32_64 if a is m32 else a

    def per_row(t, rows):
        """Max over all but the lane axis, the lanes cut into ``rows``."""
        return t.reshape(-1, rows, t.shape[-1] // rows).amax(dim=(0, 2))

    ins = path_inputs(m32, N, B, seed=0)
    results = {}
    for name, (kern, plain, src, repl) in kernels.items():
        args = ins[name]
        out, ref = as_tuple(kern(*args)), as_tuple(plain(*args))
        ref64 = as_tuple(plain(*map(to64, args)))
        torch.cuda.synchronize()
        # line-search lanes are judged per step-size row, so that rows the
        # float64 run itself sends off to huge values bound only themselves
        rows = ins["linesearch_rollout"][6].shape[0] \
            if name == "linesearch_rollout" else 1
        for k, (o, p, r) in enumerate(zip(out, ref, ref64)):
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{name} float32: non-finite output {k}")
            ek = per_row((o.double() - r).abs(), rows)
            ep = per_row((p.double() - r).abs(), rows)
            bound = F32_FACTOR * ep + F32_FLOOR * per_row(r.abs(), rows).clamp(
                min=1.0)
            if not bool((ek <= bound).all()):
                raise AssertionError(
                    f"{name} float32 output {k}: error vs float64 "
                    f"{ek.tolist()} > {bound.tolist()} ({F32_FACTOR} x "
                    f"plain float32's {ep.tolist()} + floor)")
        ms = time_cuda(lambda: kern(*args), iters=20)
        plain_ms = time_cuda(lambda: plain(*args), iters=3)
        results[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "max_abs_err": max_err(out, ref),
            "kernel_err_vs_f64": max_err(out, ref64),
            "plain_err_vs_f64": max_err(ref, ref64),
            "ms": ms, "plain_ms": plain_ms}
    line("config3_f32", {k: {f: v[f] for f in (
        "max_abs_err", "kernel_err_vs_f64", "plain_err_vs_f64", "ms",
        "plain_ms")} for k, v in results.items()})

    def check_f32(what, out, ref, ref64):
        """The float32 rule above, for one output."""
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{what} float32: non-finite output")
        ek = float((out.double() - ref64).abs().max())
        ep = float((ref.double() - ref64).abs().max())
        bound = F32_FACTOR * ep + F32_FLOOR * max(1.0, float(
            ref64.abs().max()))
        if not ek <= bound:
            raise AssertionError(f"{what} float32: error vs float64 {ek} > "
                                 f"{bound} ({F32_FACTOR} x plain float32's "
                                 f"{ep} + floor)")
        return ek, ep

    grid_f32 = {}
    for lanes in (1024, N * B):
        for case, args in lane_cases(m32, lanes, seed=0).items():
            kern, plain = case_fns[case_kernel[case]]
            out, ref = kern(*args), plain(*args)
            ref64 = plain(*map(to64, args))
            torch.cuda.synchronize()
            ek, ep = check_f32(f"{case} L={lanes}", out, ref, ref64)
            grid_f32[case, lanes] = {
                "max_abs_err": max_err((out,), (ref,)),
                "kernel_err_vs_f64": ek, "plain_err_vs_f64": ep,
                "ms": time_cuda(lambda: kern(*args), iters=20),
                "plain_ms": time_cuda(lambda: plain(*args), iters=3)}
    line("grid_kernels_f32", {f"{case} L={lanes}": v
                              for (case, lanes), v in grid_f32.items()})
    for name, (_, _, src, repl) in grid_kernels.items():
        results[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "max_abs_err": max(v["max_abs_err"] for (c, lanes), v
                               in grid_f32.items()
                               if case_kernel[c] == name and lanes == 1024),
            "ms": grid_f32[name, 1024]["ms"],
            "plain_ms": grid_f32[name, 1024]["plain_ms"]}

    # -- phase 4: the slice ------------------------------------------------
    n = m32.n
    goal = eepose.eepos(m32, torch.full((n, 1), 0.5, device=dev))[:3, 0]
    cost = EEReachCost(model=m32, goal_xyz=goal, w_pos=0.5, w_pos_f=200.0)
    cfg = ILQRConfig(N=N, dt=DT, iters=ITERS)
    solve, parts = make_ilqr(m32, cost, cfg, expose_parts=True)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.uniform(-0.2, 0.2, (2 * n, B)),
                         dtype=torch.float32, device=dev)
    U0 = torch.zeros((N, n, B), dtype=torch.float32, device=dev)

    build.reset_counters()
    res = solve(x0, U0)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    plain_calls = dict(build.PLAIN_CALLS)
    expect = {"rollout": 1, "fd_du": ITERS, "riccati_factored": ITERS,
              "linesearch_rollout": ITERS}
    if launches != expect or plain_calls:
        raise AssertionError(f"main path launches {launches} (expected "
                             f"{expect}), plain calls {plain_calls}")
    if (res.X.shape != (N + 1, 2 * n, B) or res.U.shape != (N, n, B)
            or res.cost_trace.shape != (ITERS + 1, B)):
        raise AssertionError("solve returned the wrong shapes")
    tr = res.cost_trace
    if not bool(torch.isfinite(tr).all()):
        raise AssertionError("non-finite cost")
    if not bool((tr[-1] < tr[0]).all()):
        raise AssertionError("cost did not decrease for every problem")

    # Final costs against plain solves of the same inputs. The float32 solve
    # amplifies rounding: alpha = 1 line-search rows are unstable closed
    # loops, so two correct float32 solves part ways on a share of the
    # problems (the plain float32 solve itself does against float64). So:
    #  * float64, kernels vs plain: within rel 1e-3 on >= 99% of problems;
    #  * float32: the kernel solve agrees with the float64 plain solve on no
    #    fewer problems than the plain float32 solve does, less 5 points;
    #  * the kernel-vs-plain float32 disagreements are counted and printed.
    def solve_with(model, use_kernels):
        c = dataclasses.replace(cost, model=model,
                                goal_xyz=cost.goal_xyz.to(model.dtype))
        return make_ilqr(model, c, ILQRConfig(
            N=N, dt=DT, iters=ITERS, use_kernels=use_kernels))(
                x0.to(model.dtype), U0.to(model.dtype)).cost.double().cpu()

    def rel(a, b):
        return (a - b).abs() / b.abs()

    def share(r):
        return float((r <= 1e-3).float().mean())

    c_k32 = res.cost.double().cpu()
    c_p32 = solve_with(m32, False)
    c_k64 = solve_with(m32_64, None)
    c_p64 = solve_with(m32_64, False)
    agree = {"f32_kernel_vs_plain": share(rel(c_k32, c_p32)),
             "f64_kernel_vs_plain": share(rel(c_k64, c_p64)),
             "f32_kernel_vs_f64_plain": share(rel(c_k32, c_p64)),
             "f32_plain_vs_f64_plain": share(rel(c_p32, c_p64))}
    if not agree["f64_kernel_vs_plain"] >= 0.99:
        raise AssertionError(f"float64 final costs agree within rel 1e-3 on "
                             f"only {agree['f64_kernel_vs_plain']:.4f}")
    if not (agree["f32_kernel_vs_f64_plain"]
            >= agree["f32_plain_vs_f64_plain"] - 0.05):
        raise AssertionError(f"float32 kernel solve less accurate than the "
                             f"plain float32 solve: {agree}")
    r32 = rel(c_k32, c_p32)

    ms = time_cuda(lambda: solve(x0, U0), iters=10, warmup=1)
    X = parts["rollout"](x0, U0)
    A, Bm = parts["linearize"](X[:N], U0)
    ks, Ks = parts["backward"](X, U0, A, Bm)
    phases = {
        "rollout_ms": time_cuda(lambda: parts["rollout"](x0, U0)),
        "linearize_ms": time_cuda(lambda: parts["linearize"](X[:N], U0)),
        "backward_ms": time_cuda(lambda: parts["backward"](X, U0, A, Bm)),
        "forward_ms": time_cuda(lambda: parts["forward"](X, U0, ks, Ks)),
    }
    line("slice", {
        "config": 3, "robot": "iiwa", "N": N, "iters": ITERS, "B": B,
        "dtype": "float32", "device": smi,
        "solve_ms": ms, "solves_per_s": B / (ms / 1e3),
        "cost_first_mean": float(tr[0].mean()),
        "cost_last_mean": float(tr[-1].mean()),
        "final_cost_rel_1e-3_share": agree,
        "f32_kernel_vs_plain_disagree": int((r32 > 1e-3).sum()),
        "f32_kernel_vs_plain_median_rel": float(r32.median()),
        "f32_mean_final_cost": {"kernel": float(c_k32.mean()),
                                "plain": float(c_p32.mean()),
                                "plain_f64": float(c_p64.mean())},
        "launches": launches, "phases": phases})

    # -- phase 5: configs 1 and 2 and the rest of the API through GRiD -----
    grids = {robot: (GRiD(robot, dtype=torch.float32, device=dev),
                     GRiD(robot, dtype=torch.float32, device=dev,
                          use_kernels=False),
                     GRiD(robot, dtype=torch.float64, device=dev,
                          use_kernels=False))
             for robot in ("iiwa", "hyq")}
    g = grids["iiwa"][0]
    n, BG = g.num_vel, 1024
    rng = np.random.default_rng(0)                      # config 1 (bench.py)
    x1 = tuple(rng.uniform(-1, 1, n) for _ in range(3))
    xb = (rng.uniform(-1, 1, (BG, n)),) * 3
    rng = np.random.default_rng(0)                      # config 2 (bench.py)
    x2 = tuple(rng.uniform(-1, 1, (BG, n)) for _ in range(3))
    xh = (np.random.default_rng(0).uniform(-1, 1, (BG, 12)),)
    calls = {   # label -> (robot, method, numpy inputs, kernel it launches)
        "c1_id_B1": ("iiwa", "id", x1, "rnea"),
        "c1_id_du_B1": ("iiwa", "id_du", x1, "id_du"),
        "c1_id_B1024": ("iiwa", "id", xb, "rnea"),
        "c1_id_du_B1024": ("iiwa", "id_du", xb, "id_du"),
        "c2_aba": ("iiwa", "aba", x2, "aba"),
        "c2_fd_du": ("iiwa", "fd_du", x2, "fd_du"),
        "c2_minv": ("iiwa", "minv", x2[:1], "minv"),
        "hyq_eepos_B1024": ("hyq", "eepos", xh, "eepos"),
    }
    for method, nargs in (("fd", 3), ("crba", 1), ("eepos", 1),
                          ("deepos", 1)):
        calls[f"api_{method}_B1"] = ("iiwa", method, x1[:nargs], method)
        calls[f"api_{method}_B1024"] = ("iiwa", method, x2[:nargs], method)
    ref64 = {k: getattr(grids[r][2], m)(*x).double()
             for k, (r, m, x, _) in calls.items()}
    ref32 = {k: getattr(grids[r][1], m)(*x) for k, (r, m, x, _) in calls.items()}
    torch.cuda.synchronize()

    build.reset_counters()
    outs = {}
    for label, (robot, method, x, kernel) in calls.items():
        before = dict(build.LAUNCHES)
        outs[label] = getattr(grids[robot][0], method)(*x)
        torch.cuda.synchronize()
        added = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                 if v != before.get(k, 0)}
        if added != {kernel: 1}:
            raise AssertionError(f"GRiD.{method} ({label}) launched "
                                 f"{added}, expected {{{kernel!r}: 1}}")
    grid_launches = dict(build.LAUNCHES)
    # fk has no kernel: plain torch on the card, no launch and no plain call
    outs["api_fk_B1024"] = g.fk(x2[0])
    torch.cuda.synchronize()
    ref64["api_fk_B1024"] = grids["iiwa"][2].fk(x2[0]).double()
    ref32["api_fk_B1024"] = grids["iiwa"][1].fk(x2[0])
    if dict(build.LAUNCHES) != grid_launches:
        raise AssertionError("GRiD.fk launched a kernel")
    if build.PLAIN_CALLS:
        raise AssertionError(f"GRiD path ran plain versions: "
                             f"{dict(build.PLAIN_CALLS)}")
    errs = {}
    for label, out in outs.items():
        ref = ref64[label]
        if out.shape != ref.shape or out.dtype != torch.float32:
            raise AssertionError(f"{label}: {tuple(out.shape)} {out.dtype}, "
                                 f"expected {tuple(ref.shape)} float32")
        if label.startswith("c1_"):   # bench.py config 1's thresholds
            err = max_err((out,), (ref,))
            tol = 1e-3 if "id_du" in label else 1e-4
            if not err < tol:
                raise AssertionError(f"{label}: error vs float64 {err} "
                                     f">= {tol}")
        else:
            err, _ = check_f32(label, out, ref32[label], ref)
        errs[label] = err

    def on_card(x):
        return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in x)

    def us(fn, iters):
        return time_cuda(fn, iters=iters) * 1e3

    t1, tb, t2 = on_card(x1), on_card(xb), on_card(x2)
    k1 = tuple(t[:, None].contiguous() for t in t1)     # kernel layout, B=1
    c1 = {
        "id_us": us(lambda: g.id(*t1), 200),
        "id_du_us": us(lambda: g.id_du(*t1), 200),
        "id_bare_kernel_us": us(lambda: K.rnea(g.model, *k1, GRAVITY), 200),
        "id_du_bare_kernel_us": us(lambda: K.id_du(g.model, *k1, GRAVITY),
                                   200),
        "id_us_per_sample_B1024": us(lambda: g.id(*tb), 100) / BG,
        "id_du_us_per_sample_B1024": us(lambda: g.id_du(*tb), 100) / BG,
    }
    c2 = {
        "aba_us_per_call": us(lambda: g.aba(*t2), 100),
        "aba_us_per_call_repeat": us(lambda: g.aba(*t2), 100),
        "fd_du_us_per_call": us(lambda: g.fd_du(*t2), 100),
        "minv_us_per_call": us(lambda: g.minv(t2[0]), 100),
    }
    for k in ("aba", "fd_du", "minv"):
        c2[f"{k}_evals_per_s"] = BG / (c2[f"{k}_us_per_call"] / 1e6)
    api = {}
    for method, nargs in (("fd", 3), ("crba", 1), ("eepos", 1),
                          ("deepos", 1), ("fk", 1)):
        fn = getattr(g, method)
        api[f"{method}_us_B1"] = us(lambda: fn(*t1[:nargs]), 200)
        api[f"{method}_us_B1024"] = us(lambda: fn(*t2[:nargs]), 100)
    th = on_card(xh)
    api["hyq_eepos_us_B1024"] = us(lambda: grids["hyq"][0].eepos(*th), 100)
    line("grid", {"configs": [1, 2], "robot": "iiwa", "dtype": "float32",
                  "B": BG, "device": smi, "config1": c1, "config2": c2,
                  "api": api, "max_err_vs_f64_plain": errs,
                  "launches": grid_launches})

    path_launches = {k: launches.get(k, 0) + grid_launches.get(k, 0)
                     for k in results}
    print(json.dumps({"kernels": [
        {k: results[name][k] for k in ("name", "route", "source",
                                       "replaces")}
        | {"launches": path_launches[name]}
        | {k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms")}
        for name in results]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
