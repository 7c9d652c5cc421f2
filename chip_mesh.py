"""Config 5 on a mesh alone: ``chip_smoke.py``'s phase 12 without the other
phases.

Builds the 17- and 28-joint kernel libraries, runs phase 8's one-card
scenario step and closed loop on atlas and gym_humanoid (the references),
their float64 counterparts, then ``chip_smoke.phase12``: 4 spawned ranks
on the flat dp=4 and the hybrid (dp 2, kp 2) mesh, then one NCCL rank in
this process. Run from the root of a checkout:

    python3 chip_mesh.py                    # 4 gloo ranks on card 0
    python3 chip_mesh.py --backend nccl     # rank r on card r (4 cards)

Prints the reference steps' ms, then ``config5_mesh:`` (phase 12's result)
and the card's name and power limit; raises on any failed check.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

import chip_smoke as cs


def check_f32(what, out, ref, ref64):
    """``chip_smoke.py``'s float32 rule for one output."""
    ek = float((out.double() - ref64).abs().max())
    ep = float((ref.double() - ref64).abs().max())
    bound = cs.F32_FACTOR * ep + cs.F32_FLOOR * max(1.0, float(
        ref64.abs().max()))
    if not (bool(torch.isfinite(out).all()) and ek <= bound):
        raise AssertionError(f"{what} float32: error vs float64 {ek} > "
                             f"{bound}")
    return ek, ep


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_mesh.py needs a GPU")
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gridcodegenerator_tpu_torch.models.model import build_model
    from gridcodegenerator_tpu_torch.models.zoo import load_robot
    from gridcodegenerator_tpu_torch.ops.cuda import build
    from gridcodegenerator_tpu_torch.parallel.scenario import (
        ScenarioMPCConfig, closed_loop, make_scenario_step)
    from gridcodegenerator_tpu_torch.trajopt.cost import QuadCost
    from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig
    from gridcodegenerator_tpu_torch.utils.timing import time_cuda
    build.build((17, 28))
    dev, S = torch.device("cuda:0"), cs.S5
    plan = {"device": "cuda" if args.backend == "nccl" else "cuda:0",
            "S": S, "timed": True, "backend": args.backend,
            "robots": {r: cs.DT5.get(r, cs.DT) for r in cs.ROBOTS5}}
    ref5, ref64, one_card = {}, {}, {}
    for robot, dt5 in plan["robots"].items():
        m = build_model(load_robot(robot), dtype=torch.float32, device=dev)
        c = cs.config5_cost(m)
        cfg = ScenarioMPCConfig(ILQRConfig(N=cs.N5, dt=dt5,
                                           iters=cs.ITERS5), S)
        _, x0s = cs.config5_inputs(m.n, S, dev)
        U0 = torch.zeros((cs.N5, m.n, S), device=dev)
        step = make_scenario_step(m, c, cfg)
        ref5[robot] = {f: v.cpu().numpy() for f, v in zip(
            ("u0", "U_next", "costs"), step(x0s, U0))}
        one_card[robot] = time_cuda(lambda: step(x0s, U0), iters=3)
        xs, _ = closed_loop(m, c, cfg, torch.zeros(2 * m.n, device=dev),
                            cs.PERIODS5, torch.Generator(
                                device=dev).manual_seed(0), cs.SPREAD5)
        ref5[robot]["xs"] = xs.cpu().numpy()
        c64 = QuadCost(Q=c.Q.double(), R=c.R.double(), Qf=c.Qf.double(),
                       x_goal=c.x_goal.double())
        ref64[robot] = {f: v.cpu().numpy() for f, v in zip(
            ("u0", "U_next", "costs"), make_scenario_step(
                m.to(dtype=torch.float64), c64, cfg)(x0s.double(),
                                                     U0.double()))}
        ref64[robot]["xs"] = cs.config5_closed_loop64(m, dt5, S).cpu().numpy()
    torch.cuda.empty_cache()
    print(f"one_card_step_ms: {json.dumps(one_card)}", flush=True)
    out, _ = cs.phase12(plan, ref5, ref64, check_f32)
    out |= {"backend": args.backend, "cards": torch.cuda.device_count(),
            "total_s": time.perf_counter() - t0}
    print(f"config5_mesh: {json.dumps(out)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
