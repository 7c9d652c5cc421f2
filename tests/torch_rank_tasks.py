"""What the ranks of the port's multi-device tests run (CPU, gloo).

Imported by spawned ranks (``parallel/launch.py:RankGroup``), so it
imports only numpy, torch and the port, never JAX: the tests build the
inputs and the JAX references in the parent and pass numpy arrays. Every
function runs on every rank of the group and returns numpy arrays (or
None on a rank outside its mesh).
"""

import numpy as np
import torch

from gridcodegenerator_tpu_torch.models.model import model_from_numpy
from gridcodegenerator_tpu_torch.ops.cuda import build
from gridcodegenerator_tpu_torch.parallel import collectives
from gridcodegenerator_tpu_torch.parallel.knot_riccati import \
    sharded_lqr_gains
from gridcodegenerator_tpu_torch.parallel.mesh import (gather_along,
                                                       make_hybrid_mesh,
                                                       make_mesh,
                                                       shard_along)
from gridcodegenerator_tpu_torch.parallel.scenario import (
    ScenarioMPCConfig, closed_loop, make_scenario_step)
from gridcodegenerator_tpu_torch.trajopt.cost import EEReachCost, QuadCost
from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig, make_ilqr


def loaded_modules():
    """The top-level packages this rank has imported."""
    import sys
    return sorted({m.split(".")[0] for m in sys.modules})


def mesh_of(kind, size=None):
    """"flat": dp over ``size`` ranks (default all); "hybrid": (dp, kp)
    with kp = 2; "kp": a ("kp",) mesh over ``size`` ranks."""
    if kind == "flat":
        return make_mesh(size, ("dp",), device="cpu")
    if kind == "hybrid":
        return make_hybrid_mesh(("dp", "kp"), 2, size, device="cpu")
    return make_mesh(size, ("kp",), device="cpu")


def collectives_probe():
    """psum, pmin, ppermute and all_gather over a (2, 2) mesh."""
    mesh = make_hybrid_mesh(("dp", "kp"), 2, device="cpu")
    r = float(mesh.rank)
    x = torch.tensor([r, 10 * r], dtype=torch.float64)
    out = {"coords": (mesh.coords["dp"], mesh.coords["kp"]),
           "psum_all": collectives.psum(x, mesh.axis(("dp", "kp"))),
           "psum_kp": collectives.psum(x, mesh.axis("kp")),
           "pmin_dp": collectives.pmin(x, mesh.axis("dp")),
           "gather_kp": collectives.all_gather(x[None], mesh.axis("kp"))}
    got = collectives.ppermute([x, 2 * x], mesh.axis(("dp", "kp")), 1)
    out["ppermute"] = None if got is None else torch.stack(got)
    full = torch.arange(8.0).reshape(2, 4)
    out["shard"] = shard_along(full, mesh, 1)
    out["unshard"] = gather_along(out["shard"], mesh, 1)
    return out


def lqr_gains(D, args, reg=0.0):
    """``sharded_lqr_gains`` over a ("kp",) mesh of the first D ranks on
    the full knot stacks ``args``."""
    mesh = mesh_of("kp", D)
    if mesh.coords is None:
        return None
    fn = sharded_lqr_gains(mesh, "kp", reg)
    return fn(*(torch.as_tensor(a) for a in args))


def _model(spec):
    arrays, static = spec
    return model_from_numpy(arrays, static, device="cpu")


def _cost(kind, weights, model=None):
    if kind == "quad":
        return QuadCost(**{k: torch.as_tensor(v) for k, v in weights.items()})
    return EEReachCost(model=model, **{
        k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
        for k, v in weights.items()})


def knot_solve(spec, cost_kind, weights, cfg_kw, kp, x0, U0):
    """The knot-sharded solve over a ("kp",) mesh of the first kp ranks,
    every rank of the axis on the same inputs; also the kernels' and plain
    versions' call counts of the solve."""
    mesh = mesh_of("kp", kp)
    if mesh.coords is None:
        return None
    model = _model(spec)
    cost = _cost(cost_kind, weights, model)
    cfg = ILQRConfig(knot_axis="kp", knot_axis_size=kp, **cfg_kw)
    build.reset_counters()
    res = make_ilqr(model, cost, cfg, mesh=mesh)(torch.as_tensor(x0),
                                                 torch.as_tensor(U0))
    return {"X": res.X, "U": res.U, "cost": res.cost,
            "cost_trace": res.cost_trace, "ks": res.k, "Ks": res.K,
            "plain_calls": dict(build.PLAIN_CALLS)}


def scenario_steps(spec, weights, cfg_kw, S, kind, x0s_steps, U):
    """Scenario steps on the ``kind`` mesh, each warm-started by the last:
    every rank solves its shard of the global (2n, S) states; the shards
    are gathered back (u0, the global U_next and costs per step)."""
    mesh = mesh_of(kind)
    model = _model(spec)
    cost = _cost("quad", weights)
    step = make_scenario_step(model, cost, ScenarioMPCConfig(
        ILQRConfig(**cfg_kw), S), mesh)
    ax = step.scenario_axes
    U = shard_along(torch.as_tensor(U), mesh, -1, ax)
    out = []
    for x0s in x0s_steps:
        build.reset_counters()
        u0, U, costs = step(shard_along(torch.as_tensor(x0s), mesh, -1, ax),
                            U)
        out.append({"u0": u0, "U_next": gather_along(U, mesh, -1, ax),
                    "costs": gather_along(costs, mesh, -1, ax),
                    "local_scenarios": step.local_scenarios,
                    "scenario_axes": ax,
                    "plain_calls": dict(build.PLAIN_CALLS)})
    return out


def mesh_closed_loop(spec, weights, cfg_kw, S, kind, x0, steps, seed):
    mesh = mesh_of(kind)
    model = _model(spec)
    cfg = ScenarioMPCConfig(ILQRConfig(**cfg_kw), S)
    xs, us = closed_loop(model, _cost("quad", weights), cfg,
                         torch.as_tensor(x0), steps,
                         torch.Generator().manual_seed(seed), 0.01, mesh)
    return xs, us


def refusals(spec, weights, cfg_kw):
    """The mesh cases that raise, by name -> the exception's type name."""
    mesh = mesh_of("flat")
    model = _model(spec)
    cost = _cost("quad", weights)
    n = model.num_vel
    got = {}

    def expect(name, fn):
        try:
            fn()
            got[name] = None
        except Exception as e:              # noqa: BLE001 - reported
            got[name] = type(e).__name__

    # S = 6 scenarios do not split over 4 ranks
    expect("scenarios_not_divisible", lambda: make_scenario_step(
        model, cost, ScenarioMPCConfig(ILQRConfig(**cfg_kw), 6), mesh))
    step = make_scenario_step(model, cost, ScenarioMPCConfig(
        ILQRConfig(**cfg_kw), 8), mesh)
    N = cfg_kw["N"]
    # the step takes this rank's 2 scenarios, not all 8
    expect("global_arrays_to_the_step", lambda: step(
        torch.zeros((2 * n, 8), dtype=torch.float64),
        torch.zeros((N, n, 8), dtype=torch.float64)))
    # a knot axis the mesh lacks, and one of another size
    for name, kw in (("axis_not_in_mesh", dict(knot_axis="kp",
                                               knot_axis_size=2)),
                     ("axis_size_differs", dict(knot_axis="dp",
                                                knot_axis_size=2))):
        expect(name, lambda kw=kw: make_ilqr(model, cost, ILQRConfig(
            **cfg_kw, **kw), mesh=mesh))
    return got


def raises(task, *args):
    """The type name of what the task ``task`` raises, or None."""
    try:
        globals()[task](*args)
    except Exception as e:                  # noqa: BLE001 - reported
        return type(e).__name__
    return None


def cuda_collectives_probe():
    """psum, ppermute and all_gather on CUDA tensors over a gloo ("kp",)
    mesh of ranks that share card 0, with the bytes staged through host
    memory; then an NCCL mesh over the same ranks, which must raise."""
    mesh = make_mesh(None, ("kp",), device="cuda:0", backend="gloo")
    ax = mesh.axis("kp")
    x = torch.tensor([1.0, 10.0], dtype=torch.float64,
                     device="cuda:0") * (mesh.rank + 1)
    collectives.reset_staged()
    got = collectives.ppermute([x, 2 * x], ax, 1)
    out = {"psum": collectives.psum(x, ax),
           "ppermute": None if got is None else torch.stack(got),
           "all_gather": collectives.all_gather(x[None], ax),
           "on_card": all(t.is_cuda for t in [x] + (got or []))}
    out["staged"] = dict(collectives.STAGED)
    try:
        make_mesh(None, ("kp",), device="cuda:0", backend="nccl")
        out["nccl_refused"] = False
    except RuntimeError:
        out["nccl_refused"] = True
    return out
