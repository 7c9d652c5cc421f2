"""On-card smoke test of the PyTorch/CUDA port: configs 3, 1, 2, 4 and 5 end
to end, the rest of the GRiD API, the per-robot generated modules, the
solver's per-knot cost route, config 3 with the associative-scan Riccati,
GRiD on floating-base robots, config 5 on a mesh, and the first- and
second-order paths above 28 joints (config 5 and config 4 on atlas with
two hands).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one line each:
  0. device: fail without CUDA; print the card's name and power limit;
  1. build: compile the CUDA kernels from gridcodegenerator_tpu_torch/csrc,
     one library per joint count the run loads (the zoo's 2, 7, 8, 12, 16,
     17 and 28; phase 2's 4, 5 and 20; phases 13 and 14's 52 and 34), every
     nvcc at once, the host operation counter's g++ (utils/opcount.py)
     beside them, and print each library's seconds; the block plan
     (knots, problems or rollouts a block, shared bytes, bands) and
     cudaFuncGetAttributes of every instance of the thread-group kernels:
     fd_du, fdsva_so, idsva_so and id_du (a warp per knot), d2eepos, rnea,
     aba, fd, eepos, minv, crba and deepos (a group of threads per lane),
     riccati_factored and riccati (a warp per problem; riccati's
     stationary and per-knot instances), linesearch_rollout, rollout and
     feedback_rollout (a group of threads per rollout); each holds a knot,
     but fdsva_so's fused kernel at 28 joints (20 in
     float64), where the composed route runs, and idsva_so there holds a
     band of a knot;
  2. each kernel against its plain PyTorch version on the same CUDA inputs,
     iiwa at small B and N (37 lanes: a ragged block), float64: max abs
     error <= 1e-9; and every GRiD kernel case on hyq (12 joints, branched,
     4 EEs); idsva_so, fdsva_so (iiwa, hyq) and the line search with
     QuadCost (iiwa) within 1e-9 * max(1, max|ref|); so are d2eepos on
     iiwa, hyq, gym_ant (its welded EEs, and its four feet) and
     dm_quadruped, every GRiD kernel case on gym_ant (8 joints, EEs at the
     feet) and dm_quadruped (16 joints, branched), and riccati (stationary
     and per knot) and rollout on iiwa, hyq, gym_ant and dm_quadruped (dt
     0.002); and all 17 kernels on gym_humanoid (17 joints, dt 0.002),
     atlas (28: idsva_so in bands, fdsva_so composed, also at 128 lanes)
     and on the counts built at first use: pendulum4, mixed5 and a
     20-joint chain (its sweeps at dt 0.002; in float64 idsva_so in bands
     and fdsva_so composed, also at 128 lanes); then minv (dense and the
     upper factor, +0 below its diagonal), crba and deepos on iiwa, hyq,
     gym_humanoid and atlas at 1, G + 1 and 37 lanes (a block's one knot,
     a ragged second block), one launch a call; the line search without a
     cost (the no-cost instance) on every robot of the phase; then rnea,
     minv (dense), crba, aba, fd, id_du and fd_du on 3 lanes of every robot
     of the phase against the float64 oracle (reference/oracle.py), lane
     by lane: within 1e-10 of each output's scale;
  3. the same in float32 (tolerances below): fd_du and fdsva_so at 37
     lanes on iiwa, hyq, gym_ant and dm_quadruped; with each kernel's and
     plain version's device time from CUDA events: the config-3 kernels and the
     feedback rollout at config-3 shapes, the GRiD kernels (rnea, id_du,
     aba, minv, fd, crba, eepos, deepos) at 1024 and 131072 lanes, rnea
     (with qdd and the bias form) and aba at one lane on iiwa, atlas and
     gym_humanoid (config 1's id at B=1, config 5's plant), fd and eepos
     at one lane on iiwa and atlas (config 1's fd and eepos), riccati
     (stationary) at the config-3 QuadCost shapes, idsva_so and fdsva_so at
     1024 lanes and at config 4's N*B lanes (iiwa 32768, hyq 16384),
     fd_du at 1024 lanes and at config 4's N*B lanes on its four robots,
     fdsva_so at config 4's N*B lanes on gym_ant and dm_quadruped (these
     held to the float32 rule on their first 1024 lanes),
     d2eepos at 1024 lanes and at L_HESS lanes (iiwa, hyq, dm_quadruped);
     and, in float64, the feedback rollout (kff = FB_ALPHA k) against the
     line search's alpha = FB_ALPHA row on the same inputs: equal, bit for
     bit;
  4. config 3 (iiwa, N=64, 5 iterations, B=2048, float32, EE reach) through
     the port's make_ilqr with kernels: every kernel of the path launched
     (the EE cost's eepos 2 + 2 I times and deepos 2 I times, I the
     iterations), nothing plain ran, costs finite and decreasing, final
     costs agree with a plain solve of the same inputs (which launches
     nothing); solves/s over 10 solves and each phase's ms (the backward
     phase's beside its ms with the EE cost in plain torch); then the
     solved policy run as a tracking controller through feedback_rollout
     (feedforward 0, the final gains): from x0 it retraces the solve as
     closely as the plain float32 replay does (and meets the float32 rule
     against a float64 plain replay), from a perturbed x0 it stays finite;
  5. configs 1 and 2 (iiwa, float32) through the port's GRiD: id and id_du
     unbatched and at B=1024, aba, fd_du and minv at B=1024; then fd, crba,
     eepos, deepos and d2eepos unbatched and at B=1024, and hyq's eepos at
     B=1024; then idsva_so, fdsva_so and d2eepos unbatched and at B=1024
     (iiwa) and B=512 (hyq); each call launched exactly its kernel and
     nothing plain ran; outputs agree with a float64 plain GRiD on the same
     inputs; fk (plain torch, no kernel) agrees too; µs per call and
     evals/s; then path B: idsva_so and fdsva_so through GRiD on atlas and
     gym_humanoid unbatched and at B=128 and 1024 (float32 rule at 1 and
     128, launches by route, µs a call, evals/s), each step of the
     composed route (fd_du, idsva_so, the contractions) and both fdsva_so
     routes where both run at 128, 1024 and config 4's 16384 lanes, with
     bounds: the faster route must be the one taken;
  6. config 4 (SQP with exact second-order Hessians, QuadCost, N=32, 4
     iterations, float32) on iiwa (B=1024), hyq, gym_ant and dm_quadruped
     (B=512), and path A: atlas and gym_humanoid (B=512, x0 from their own
     seed 0; gym_humanoid at dt 0.002) through make_sqp: rollout, fd_du,
     fdsva_so (atlas: fd_du and idsva_so, the composed route) and the
     line search launched every iteration, nothing plain ran (the DDP backward is plain
     torch by design, not a kernel's plain twin); costs finite and
     non-increasing; on the first 64 problems, final costs against a
     float64 plain solve and a float64 kernel solve against it (after
     iteration 1 for SQP, at the end for the QuadCost task);
     solves/s and the time of each phase; then config 3's QuadCost task
     (first-order iLQR, iiwa, N=64, 5 iterations, B=2048) through the
     riccati kernel, likewise;
  7. codegen: gen_all_code's module for iiwa, hyq and atlas, written to a
     temporary directory and imported: nothing of JAX loaded, each of its
     12 algorithms at B=1024 launched exactly its kernel (atlas's
     fdsva_so: fd_du and idsva_so) and agrees with the port's GRiD; then
     its single_timing_table;
  8. config 5 (scenario-tree MPC, S=4096, N=16, 2 iterations, float32,
     QuadCost) on atlas (dt 0.01) and gym_humanoid (dt 0.002) through
     parallel/scenario.py: the step launched the rollout, fd_du, the
     stationary riccati and the line search (N*S = 65536 fd_du lanes) and
     nothing plain ran; costs finite and non-increasing; the consensus u0
     finite and inside the scenarios' first controls, dof by dof; U_next
     the shifted plan; step ms and scenario solves/s over 5 steps; each
     kernel at the step's shapes by the float32 rule, with its times and
     bound; 3 closed-loop periods (one aba launch each), the state finite;
     a float64 kernel step on the first 64 scenarios against the plain
     one (costs by phase 6's rule; u0, U_next and every scenario's cost
     within U0_REL);
  9. the per-knot cost route (float32, iiwa), each solve's launches
     asserted, nothing plain, its first 64 problems held by phase 6's rule,
     solves/s and each phase's ms: a user CostModel of the knot index
     (RampTracking) at config 3's shapes (six step sizes): the per-knot
     expansions, the stacked riccati and the no-cost line search; config
     3's EE reach task with a goal per problem at one step size (eepos
     (N + 1)(1 + 2 I) and deepos (N + 1) I launches, 2048 lanes each); SQP
     on config 3's EE reach task at config 4's shapes (N=32, 4 iterations,
     B=1024, held after iteration 1); the stacked riccati and the no-cost
     line search at these shapes (float32 rule, times, bound);
 10. config 3 (phase 4's task, x0 and shapes) with parallel_riccati: the
     backward the associative suffix scan in plain torch
     (trajopt/priccati.py), so the rollout, fd_du, the line search and the
     EE cost's eepos and deepos launch (as in phase 4) and neither Riccati
     kernel; costs finite and non-increasing; its first 64 problems held by
     phase 6's rule (float64 kernel vs plain parallel solves at the last
     iteration, float32 vs float64); printed: solves/s over 5 solves, each
     phase's ms, the backward's ms beside phase 4's riccati_factored
     backward on the same inputs (in turns), the scan's rounds, and the
     final costs' gap to phase 4's sequential solve;
 11. GRiD on iiwa_floating (14 q / 13 qd) and atlas_floating (35 q / 34
     qd), float32, unbatched and at B=1024: every first-order method (id
     with and without qdd, minv dense and upper, fd, aba, crba, id_du with
     and without qdd, fd_du, eepos, deepos, d2eepos, fk, the packed forms)
     launched no kernel and ran exactly its plain twin (the kernels are
     fixed-base), finite, against a float64 GRiD on the card by the float32
     rule; a float64 card call against the same call on the CPU within
     1e-10 of scale on 3 lanes; in float64 on the card M Minv = I, id
     linear in qdd with matrix M, fd and aba invert id; idsva_so, fdsva_so
     and use_kernels=True raise; gen_all_code's module for atlas_floating
     imported with nothing of JAX loaded, its algorithms equal GRiD's, its
     timing table run; µs a call and evals/s;
 12. config 5 on a mesh (parallel/: mesh.py, collectives.py,
     knot_riccati.py, the mesh path of scenario.py), phase 8's task, S, x0
     and robots: 4 ranks spawned on the one card over gloo (their CUDA
     tensors staged through host memory), each loading the libraries
     phase 1 built (no nvcc, nothing of JAX); a flat dp=4 mesh (each rank
     1024 scenarios: rollout, fd_du, riccati, the line search) and a
     hybrid (dp 2, kp 2) mesh whose solve is knot-sharded (each rank 2048
     scenarios, fd_du on 8 of the 16 knots, the Riccati reduce in plain
     torch, no Riccati kernel); the flat step's U_next and costs are phase
     8's bit for bit and its u0 within 1e-6 of scale, the kp replicas'
     equal bit for bit, the hybrid step against the flat one by the
     float32 rule (a float64 one-card step the reference); on the hybrid
     mesh 3 closed-loop periods (one aba launch each) against phase 8's
     loop by the float32 rule (the same draws in float64 the reference),
     and the float64 kernel step against the plain one
     on the first 64 scenarios (phase 8's rule); an NCCL mesh over the
     ranks that share the card raises; then one rank in this process on
     NCCL, a (1, 1) mesh, whose step is phase 8's bit for bit. Printed:
     step ms (the slowest rank) and scenario solves/s per mesh, the
     knot-sharded backward's ms beside phase 8's riccati and fd_du, and
     the bytes staged a step (time-sliced ranks: no scaling figure);
 13. above 28 joints: atlas_hands52, atlas with two four-finger hands of
     12 joints each (tests/torch_big_robots.py, loaded by file path; 52
     joints): its library's nvcc seconds (built in phase 1) and every
     thread-group plan at 52 joints (knots a block, shared bytes, the
     device-memory route's workspace bytes: minv and fd in float64; blocks
     a problem), and the on-chip plans of fd_du, id_du and the factored,
     stationary and stacked riccati at 34, 52 and 64 joints (a knot or
     problem a block or a cluster, no workspace); in float64
     every kernel but the second-order pair against its plain version at 1
     lane and 37 (a ragged block), the sweeps at N = 8 (riccati_factored,
     the stationary and stacked riccati, the rollouts, the line search with
     the EE cost, QuadCost and none), within 1e-9 of each output's scale,
     one launch a call, and the on-chip kernels at 34 and 64 joints too
     (atlas_grippers34, atlas_grippers64, their libraries built in phase
     1; riccati_factored and id_du on 1 and 37 lanes, fd_du and the dense
     riccati on 37; at 34 joints riccati_factored (N = 2) and id_du also
     on STRIDE13 problems and lanes, each cluster taking more than one);
     rnea, minv, crba, aba, fd, id_du and fd_du against
     the oracle on 3 lanes (1e-10 of scale); in float32 the Riccati sweeps,
     the feedback rollout and the line search at N = 8 by the float32 rule,
     and riccati_factored at N = 64 on 2048 problems and id_du on 65536
     lanes beside their bounds;
     config 5 (S 4096, N 16, 2 iterations, float32, QuadCost, dt 0.002:
     the fingers' damping makes the Euler step diverge at 0.01, in the JAX
     reference too) through the rollout, fd_du over 65536 lanes, the
     stationary riccati and the line search, nothing plain: costs finite
     and non-increasing, step ms, scenario solves/s, each kernel at the
     step's shapes (fd_du's float32 rule and plain time on its first 1024
     lanes) beside its bound, PERIODS13 closed-loop period (one aba launch)
     and a float64 kernels-against-plain step at S = 64 (phase 8's rule);
     then GRiD's first-order calls at B = 1 and 1024 (one launch each, the
     float32 rule against a float64 plain GRiD), µs a call;
 14. the second order above 28 joints, on atlas_grippers34 (34 joints, its
     library built in phase 1) and atlas_hands52: idsva_so's plan and
     route at 28, 34 and 52 joints (fdsva_so composed above 22 | 17
     joints; idsva_so's tile in device memory at 34 and 52); (a) in
     float64 GRiD.idsva_so and GRiD.fdsva_so at 1 and 37 lanes, and
     GRiD.idsva_so at L_STRIDE14 on atlas_grippers34 (each block more than
     one group of lanes), against their plain versions within 1e-9 of each output's
     scale, each call launching idsva_so (and fd_du for fdsva_so) once and
     nothing plain; float32 GRiD.idsva_so at 34 joints on those L_STRIDE14
     lanes by the float32 rule; (b) in float32 on
     atlas_hands52 GRiD's second order at B = 1, 128 and 1024: µs a call,
     the kernel's ms beside its bound, the float32 rule at 128, the error
     against the float64 kernels; (c) config 4's SQP (QuadCost, N=32, 4
     iterations, B=512, dt 0.002) on atlas_hands52 in float32: rollout,
     fd_du, the composed fdsva_so and the line search launched, nothing
     plain, costs finite and non-increasing, solves/s, each phase's ms and
     the peak device memory; (d) a float64 kernel solve of its first 64
     problems against the plain one after iteration 1 (phase 6's rule),
     beside the kernel solve with fdsva_so's output scaled by 1 + EPS14
     against the unscaled one over all 4 iterations: each pair's share
     within F64_REL at every iteration it ran.
Then each phase's seconds (`phase_seconds:`, phase 1 from the build's
start), a JSON line of per-kernel results (launches on the main paths of
phases 4-14, error, times, and the roofline bound: the larger of the bytes
each call must move over 3.35 TB/s and the operations its function needs,
counted by utils/opcount.py, over 67 TFLOP/s float32; beside them the
operations the kernel's lane code executes), and last the device line.
Any failure raises, so the exit code is non-zero and no result is printed.
"""

import copy
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

N, ITERS, B, DT = 64, 5, 2048, 0.01
# config 4 (bench.py:212-213)
N4, ITERS4 = 32, 4
B4 = {"iiwa": 1024, "hyq": 512, "gym_ant": 512, "dm_quadruped": 512,
      "atlas": 512, "gym_humanoid": 512}
# dm_quadruped's joint damping (30) on its light links makes the
# semi-implicit Euler step diverge at bench.py's dt = 0.01, in the JAX
# reference too (every problem's rollout non-finite by knot 32:
# tests/test_torch_sweeps.py::test_dm_quadruped_euler_step_diverges_at_0_01);
# its config-4 solves run at the largest of 0.01 / 5^k that is stable
# (tests/test_torch_sqp_humanoids.py: from config 4's x0 the JAX
# reference's Euler step stays finite on atlas at 0.01, on gym_humanoid at
# 0.002 only)
DT4 = {"dm_quadruped": 0.002, "gym_humanoid": 0.002}
# the 20-joint chain's sweeps in phase 2 run at 0.002: at 0.01 its
# first-iteration line-search rollouts leave every bound (states 1.2e7,
# costs 1.4e12, the plain version's too), where rounding is all they hold
DT_NEW = {"pendulum20": 0.002}
# path A: config 4's SQP on the zoo's humanoids (28 and 17 joints)
ROBOTS4_SO = ("atlas", "gym_humanoid")
# the joint counts whose libraries are built at first use (phase 1), and
# the robots of phase 2 that run on them: pendulum4, mixed5 (a prismatic
# and a skew-axis joint) and a 20-joint chain (models/zoo.py:pendulum_urdf)
FIRST_USE = (4, 5, 20)
ROBOTS_NEW = ("pendulum4", "mixed5", "pendulum20")
# path B: GRiD's second-order calls on the humanoids (the JAX
# benchmarks/so_bench.py's batch, and L1)
B_SO = (128, 1024)
# config 5 (bench.py:231-272): scenario-tree MPC, S scenarios of the zero
# state (spread 0.02), N knots, ITERS5 iterations, QuadCost Q 0.1, R 1e-3,
# Qf 10, x_goal[0] 0.2, float32, on atlas (28 joints) and gym_humanoid
# (17). gym_humanoid's Euler step diverges at bench.py's dt = 0.01 from
# that spread, in the JAX reference too (some of 64 rollouts non-finite by
# knot 16: tests/test_torch_mpc.py::
# test_gym_humanoid_euler_step_diverges_at_0_01), so it runs at the largest
# of 0.01 / 5^k that is stable
S5, N5, ITERS5, SPREAD5 = 4096, 16, 2, 0.02
DT5 = {"gym_humanoid": 0.002}
ROBOTS5 = ("atlas", "gym_humanoid")
# the closed loop's periods, and the scenarios of the float64 check
PERIODS5, S5_F64 = 3, 64
# phase 13: atlas with a hand of HANDS13 joints a side (52 joints), and its
# step: the fingers' light links under the joint damping (0.1) make the
# semi-implicit Euler step diverge at 0.01 within 13 steps, in the JAX
# reference too (tests/test_torch_big_scenario.py), and stay bounded at
# 0.002, as gym_humanoid's do
HANDS13, DT13 = 12, 0.002
# atlas_grippers64 (an 18-joint gripper a side), and the kernels that keep
# one knot or problem on chip above the block limit, held in float64 at 34,
# 52 and 64 joints (riccati_factored and id_du on 1 and 37 lanes, the others
# on 37); riccati_factored (at N = 2) and id_du also on STRIDE13 problems
# and lanes at 34 joints, more than the card's 132 SMs hold at once (one
# knot or problem an SM there)
GRIPPERS13 = 18
ONCHIP13 = ("fd_du", "id_du", "riccati_factored", "riccati",
            "riccati_stacked")
STRIDE13 = 300
# phase 13's float32 shapes of the on-chip riccati_factored (config 3's N
# and B) and id_du (config 5's N S lanes), timed beside their bounds
RIC13_BIG, IDU13_LANES = (64, 2048), 65536
# one closed-loop period there (phase 8 runs PERIODS5 on atlas): each is a
# 1.3 s step, cut for the run's time limit
PERIODS13 = 1
# phase 14: the second order above 28 joints on atlas_grippers34 (a
# three-joint gripper a side) and atlas_hands52; GRiD's
# batches (path B's, and one lane), the float64 batch at which idsva_so's
# blocks take more than one group of lanes each (the card holds 132 blocks
# of its float64 plan at once, 2 knots a block at 34 joints, 1 at 52), and
# config 4's B there (bench.py:199-228, the humanoids' B of path A) at
# phase 13's dt
GRIPPERS14, B_SO14, L_STRIDE14, B14 = 3, (1, 128, 1024), 300, 512
# phase 14's float64 solves scale fdsva_so's output by 1 + EPS14 to show
# how far the SQP solve itself parts rounding-level differences (as
# tests/test_torch_sqp.py:config4_float64_sensitivity does on the CPU)
EPS14 = 1e-15
# Phase 8 holds the consensus u0, U_next and costs of a float64 kernel step
# on the first S5_F64 scenarios to the plain step's within U0_REL of
# max(1, max|value|):
# the first-order QuadCost solve is well conditioned there (on the CPU,
# scaling the scenario states by 1 + 1e-13 moved u0 by 1.4e-14 on atlas,
# 4.8e-15 on gym_humanoid; float32 and float64 u0 agreed within 1e-7)
U0_REL = 1e-9
# phase 11: GRiD on floating-base robots (14 q / 13 qd and 35 q / 34 qd),
# every first-order method as (GRiD method, the plain twin it runs, its
# inputs); "_nqdd" calls it without qdd, "minv_upper" with dense=False
ROBOTS_FLOATING = ("iiwa_floating", "atlas_floating")
FLOATING_METHODS = (
    ("id", "rnea", "q qd qdd"), ("id_nqdd", "rnea", "q qd"),
    ("minv", "minv", "q"), ("minv_upper", "minv", "q"),
    ("fd", "fd", "q qd u"), ("aba", "aba", "q qd u"), ("crba", "crba", "q"),
    ("id_du", "id_du", "q qd qdd"), ("id_du_nqdd", "id_du", "q qd"),
    ("fd_du", "fd_du", "q qd u"), ("eepos", "eepos", "q"),
    ("deepos", "deepos", "q"), ("d2eepos", "d2eepos", "q"),
    ("fk", None, "q"), ("id_packed", "rnea", "q qd qdd"),
    ("aba_packed", "aba", "q qd u"), ("fd_packed", "fd", "q qd u"),
    ("fd_du_packed", "fd_du", "q qd u"))
FLOATING_METHODS = tuple((m, t, a.split()) for m, t, a in FLOATING_METHODS)
GRAVITY = -9.81
DEVICE = torch.device("cuda:0")
L1 = 1024            # lanes of the GRiD kernels' small case (and of codegen)
# d2eepos's large case: dm_quadruped writes 6144 values a lane (3.2 GB at
# 131072 lanes in float32), so hyq and dm_quadruped run 16384
L_HESS = {"iiwa": N * B, "hyq": 16384, "dm_quadruped": 16384}
# the step size folded into the feedback rollout's feedforward term in
# phases 2 and 3
FB_ALPHA = 0.25
# config 3's backward phase (phase 4) with the EE cost's pose and Jacobian
# in plain torch, ms a call on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md),
# printed beside the phase's ms on the kernels
BACKWARD_MS_PLAIN_EE = 27.2

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
# Phase 6 holds a float64 kernel solve against the plain float64 solve on
# the first 64 problems, at one iteration: at least F64_SHARE of the
# problems within rel F64_REL. Both solves amplify rounding: the alpha = 1
# line-search rollout is an unstable closed loop (rounding-level gains part
# its cost by up to 40% at config 3's N=64), and config 4's exact-Hessian
# backward turns rounding-level input differences into other gains. The
# first-order QuadCost solve converges all the same, so it is held at its
# last iteration. The SQP solve does not: scaling its second-order tensors
# by 1 + 1e-15 parts a share of the problems by the last iteration
# (tests/test_torch_sqp.py, config4_float64_sensitivity), so it is held
# after its first. A wrong kernel moves most problems.
F64_REL = 1e-5
F64_SHARE = 0.9
# Phase 2 holds the float64 dynamics kernels against the float64 oracle on
# ORACLE_LANES lanes of each robot within ORACLE_REL of each output's scale:
# the tolerance at which the oracle anchors the JAX package (README,
# Testing)
ORACLE_LANES, ORACLE_REL = 3, 1e-10


def line(tag, obj):
    print(f"{tag}: {json.dumps(obj)}", flush=True)


def leaf_ees(topo):
    """``topo`` with its fixed frames dropped, so that its EEs are its leaf
    links. gym_ant's fixed frames are all welded to the base (empty chains):
    this way its EE kernels run on its four feet."""
    topo = copy.copy(topo)
    topo.fixed_joints = []
    return topo


def max_err(out, ref):
    """Max abs difference over paired outputs."""
    return max(float((o.double() - r.double()).abs().max())
               for o, r in zip(out, ref))



# Phase 12: config 5 on a mesh. MESH_RANKS gloo ranks share the one card
# (time-sliced, so their times are no scaling figure): a flat dp mesh and
# a hybrid (dp, kp) mesh of kp KP12, whose solve is knot-sharded; each
# rank's launches a step
MESH_RANKS, KP12 = 4, 2
MESH_STEP = {
    "flat": {"rollout": 1, "fd_du": ITERS5, "riccati": ITERS5,
             "linesearch_rollout": ITERS5},
    "hybrid": {"rollout": 1, "fd_du": ITERS5, "linesearch_rollout": ITERS5}}
MESH_NOTE = (f"{MESH_RANKS} ranks time-sliced on one card over gloo: not a "
             f"scaling figure")


def config5_cost(model):
    """Config 5's QuadCost (bench.py:254): Q 0.1, R 1e-3, Qf 10, x_goal
    zero but x_goal[0] = 0.2, in the model's dtype on its device."""
    from gridcodegenerator_tpu_torch.trajopt.cost import QuadCost
    n = model.n
    full = lambda v, k: torch.full((k,), v, dtype=model.dtype,
                                   device=model.device)
    xg = full(0.0, 2 * n)
    xg[0] = 0.2
    return QuadCost(Q=full(0.1, 2 * n), R=full(1e-3, n),
                    Qf=full(10.0, 2 * n), x_goal=xg)


def config5_inputs(n, S, dev):
    """Phase 8's scenario states: the zero state spread by SPREAD5."""
    x0n = SPREAD5 * np.random.default_rng(0).standard_normal((2 * n, S))
    return x0n, torch.as_tensor(x0n, dtype=torch.float32, device=dev)


def config5_closed_loop64(m, dt5, S):
    """Phase 8's closed loop in float64 on the same (float32-rounded)
    robot constants: each period's draws are the float32 loop's (the same
    generator, seed and order), widened; the step and the plant run in
    float64 with kernels."""
    from gridcodegenerator_tpu_torch.parallel.scenario import (
        ScenarioMPCConfig, make_scenario_step)
    from gridcodegenerator_tpu_torch.trajopt.ilqr import (ILQRConfig,
                                                          dynamics_step)
    icfg = ILQRConfig(N=N5, dt=dt5, iters=ITERS5)
    m64, c = m.to(dtype=torch.float64), config5_cost(m)
    step = make_scenario_step(m64, type(c)(
        Q=c.Q.double(), R=c.R.double(), Qf=c.Qf.double(),
        x_goal=c.x_goal.double()), ScenarioMPCConfig(icfg, S))
    gen = torch.Generator(device=m.device).manual_seed(0)
    x = torch.zeros(2 * m.n, dtype=torch.float64, device=m.device)
    U = torch.zeros((N5, m.n, S), dtype=torch.float64, device=m.device)
    xs = [x]
    for _ in range(PERIODS5):
        noise = torch.randn((2 * m.n, S), generator=gen, dtype=torch.float32,
                            device=gen.device)
        u0, U, _ = step(x[:, None] + SPREAD5 * noise.double(), U)
        x = dynamics_step(m64, x[:, None], u0[:, None], dt5,
                          icfg.gravity)[:, 0]
        xs.append(x)
    return torch.stack(xs)


def mesh_rank(plan):
    """Phase 12 on one rank of the gloo group: config 5's step on the flat
    and the hybrid mesh (launches, ms, bytes staged, this rank's u0,
    U_next and costs); on the hybrid mesh also the knot-sharded backward's
    ms, 3 closed-loop periods and the float64 kernel step against the
    plain one on the first S5_F64 scenarios; then, where the ranks share
    the card over gloo, an NCCL mesh over them, which must raise. The
    meshes run ``plan["backend"]`` (gloo unless given; a device of bare
    "cuda" puts rank r on card r). Raises if a check fails, if this rank
    ran nvcc or if it loaded a JAX module."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gridcodegenerator_tpu_torch.models.model import build_model
    from gridcodegenerator_tpu_torch.models.zoo import load_robot
    from gridcodegenerator_tpu_torch.ops.cuda import build
    from gridcodegenerator_tpu_torch.parallel import collectives
    from gridcodegenerator_tpu_torch.parallel.mesh import (make_hybrid_mesh,
                                                           make_mesh,
                                                           shard_along)
    from gridcodegenerator_tpu_torch.parallel.scenario import (
        ScenarioMPCConfig, closed_loop, make_scenario_step, scenario_axes)
    from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig, make_ilqr
    from gridcodegenerator_tpu_torch.utils.timing import time_cuda
    import torch.distributed as dist
    dev = torch.device(plan["device"])
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    backend = plan.get("backend", "gloo")
    # on the card every kernel launches; a CPU rehearsal counts plain calls
    counts = build.LAUNCHES if on_card else build.PLAIN_CALLS

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def check_counts(what, want):
        runs = dict(counts)
        if runs != want or (on_card and build.PLAIN_CALLS):
            raise AssertionError(f"{what}: launches {runs} (expected {want}),"
                                 f" plain calls {dict(build.PLAIN_CALLS)}")
        return runs

    S = plan["S"]
    meshes = {"flat": make_mesh(None, ("dp",), device=dev, backend=backend),
              "hybrid": make_hybrid_mesh(("dp", "kp"), KP12, device=dev,
                                         backend=backend)}
    out = {"rank": meshes["flat"].rank, "robots": {}}
    for robot, dt5 in plan["robots"].items():
        m = build_model(load_robot(robot), dtype=torch.float32, device=dev)
        n = m.n
        cost5 = config5_cost(m)
        cfg5 = ScenarioMPCConfig(ILQRConfig(N=N5, dt=dt5, iters=ITERS5), S)
        x0n, x0_all = config5_inputs(n, S, dev)
        res = {}
        for kind, mesh in meshes.items():
            step = make_scenario_step(m, cost5, cfg5, mesh)
            ax, S_loc = step.scenario_axes, step.local_scenarios
            _, icfg = scenario_axes(cost5, cfg5, mesh)
            x0s = shard_along(x0_all, mesh, -1, ax)
            U0 = torch.zeros((N5, n, S_loc), dtype=torch.float32, device=dev)
            build.reset_counters()
            collectives.reset_staged()
            u0, U_next, costs = step(x0s, U0)
            sync()
            r = {"launches": check_counts(f"{robot} {kind} step",
                                          MESH_STEP[kind]),
                 "staged_bytes": dict(collectives.STAGED),
                 "staged_s": dict(collectives.STAGED_SECONDS),
                 "scenario_axes": ax, "local_scenarios": S_loc,
                 "fd_du_lanes": N5 // icfg.knot_axis_size * S_loc,
                 "u0": u0, "U_next": U_next, "costs": costs}
            if plan["timed"]:
                r["step_ms"] = time_cuda(lambda: step(x0s, U0), iters=3)
            if kind == "hybrid":
                _, parts = make_ilqr(m, cost5, icfg, expose_parts=True,
                                     mesh=mesh)
                X = parts["rollout"](x0s, U0)
                if plan["timed"]:
                    r["kp_backward_ms"] = time_cuda(
                        lambda: parts["backward"](X, U0), iters=3)
                del X, parts
                build.reset_counters()
                xs, _ = closed_loop(
                    m, cost5, cfg5, torch.zeros(2 * n, dtype=torch.float32,
                                                device=dev), PERIODS5,
                    torch.Generator(device=dev).manual_seed(0), SPREAD5,
                    mesh)
                sync()
                r["closed_loop_launches"] = check_counts(
                    f"{robot} {kind} closed loop",
                    {k: PERIODS5 * v for k, v in MESH_STEP[kind].items()}
                    | {"aba": PERIODS5})
                r["xs"] = xs
                r["f64_first64"] = mesh_f64_check(m, cost5, dt5, x0n, mesh)
            res[kind] = r
        out["robots"][robot] = res
    if on_card and backend == "gloo":
        # NCCL runs one rank a card: a mesh over these ranks must refuse it
        try:
            make_mesh(None, ("dp",), device=dev, backend="nccl")
            refused = False
        except RuntimeError:
            refused = True
        if not refused:
            raise AssertionError("an NCCL mesh over ranks that share the "
                                 "card did not raise")
        out["nccl_shared_card_refused"] = refused
    if build.NVCC_SECONDS:
        raise AssertionError(f"rank {out['rank']} ran nvcc: "
                             f"{build.NVCC_SECONDS}")
    jax_loaded = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "gridcodegenerator_tpu"))
    if jax_loaded:
        raise AssertionError(f"rank {out['rank']} loaded {jax_loaded}")
    return out


def mesh_f64_check(m, cost5, dt5, x0n, mesh):
    """Phase 8's float64 check on a mesh: the kernel step against the
    plain step on the first S5_F64 scenarios (u0, U_next and costs within
    U0_REL of their scale; costs by phase 6's QuadCost rule)."""
    from gridcodegenerator_tpu_torch.parallel.mesh import shard_along
    from gridcodegenerator_tpu_torch.parallel.scenario import (
        ScenarioMPCConfig, make_scenario_step)
    from gridcodegenerator_tpu_torch.trajopt.cost import QuadCost
    from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig
    m64 = m.to(dtype=torch.float64)
    cost64 = QuadCost(Q=cost5.Q.double(), R=cost5.R.double(),
                      Qf=cost5.Qf.double(), x_goal=cost5.x_goal.double())
    x64 = torch.as_tensor(x0n[:, :S5_F64], dtype=torch.float64,
                          device=m.device)
    got = {}
    for uk in (None, False):
        step = make_scenario_step(m64, cost64, ScenarioMPCConfig(
            ILQRConfig(N=N5, dt=dt5, iters=ITERS5, use_kernels=uk), S5_F64),
            mesh)
        got[uk] = step(shard_along(x64, mesh, -1, step.scenario_axes),
                       torch.zeros((N5, m.n, step.local_scenarios),
                                   dtype=torch.float64, device=m.device))
    errs = {}
    for what, k_, p_ in zip(("u0", "U_next", "costs"), got[None], got[False]):
        err = float((k_ - p_).abs().max())
        tol = U0_REL * max(1.0, float(p_.abs().max()))
        errs[what] = {"max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"mesh float64: {what} off by {err} "
                                 f"(tol {tol})")
    r = (got[None][2] - got[False][2]).abs() / got[False][2].abs()
    at = float((r <= F64_REL).double().mean())
    if not at >= F64_SHARE:
        raise AssertionError(f"mesh float64: costs within rel {F64_REL} on "
                             f"{at}")
    return {"costs_within_rel": F64_REL, "share": at,
            "max_rel": float(r.max()), **errs}



def nccl_step(plan, ref5, init_method):
    """Config 5's step on a (1, 1) hybrid mesh of this one process over
    NCCL: its launches, and its u0, U_next and costs against phase 8's
    one-card step, bit for bit."""
    import torch.distributed as dist
    from gridcodegenerator_tpu_torch.models.model import build_model
    from gridcodegenerator_tpu_torch.models.zoo import load_robot
    from gridcodegenerator_tpu_torch.ops.cuda import build
    from gridcodegenerator_tpu_torch.parallel.mesh import (
        initialize_distributed, make_hybrid_mesh)
    from gridcodegenerator_tpu_torch.parallel.scenario import (
        ScenarioMPCConfig, make_scenario_step)
    from gridcodegenerator_tpu_torch.trajopt.ilqr import ILQRConfig
    from gridcodegenerator_tpu_torch.utils.timing import time_cuda
    dev = torch.device(plan["device"])
    initialize_distributed(init_method, 1, 0, backend="nccl", timeout_s=120)
    try:
        mesh = make_hybrid_mesh(("dp", "kp"), 1, device=dev)
        if mesh.backend != "nccl":
            raise AssertionError(f"the mesh runs {mesh.backend}, not NCCL")
        out = {}
        for robot, dt5 in plan["robots"].items():
            m = build_model(load_robot(robot), dtype=torch.float32,
                            device=dev)
            step = make_scenario_step(m, config5_cost(m), ScenarioMPCConfig(
                ILQRConfig(N=N5, dt=dt5, iters=ITERS5), plan["S"]), mesh)
            _, x0s = config5_inputs(m.n, plan["S"], dev)
            U0 = torch.zeros((N5, m.n, plan["S"]), dtype=torch.float32,
                             device=dev)
            build.reset_counters()
            got = step(x0s, U0)
            torch.cuda.synchronize()
            runs = dict(build.LAUNCHES)
            if runs != MESH_STEP["flat"] or build.PLAIN_CALLS:
                raise AssertionError(f"{robot} NCCL step launches {runs}, "
                                     f"plain {dict(build.PLAIN_CALLS)}")
            for f, g in zip(("u0", "U_next", "costs"), got):
                if not np.array_equal(g.cpu().numpy(), ref5[robot][f]):
                    raise AssertionError(
                        f"{robot} NCCL step: {f} is not phase 8's (max "
                        f"diff {np.abs(g.cpu().numpy() - ref5[robot][f]).max()})")
            out[robot] = {"launches": runs, "equal_to_phase8": True,
                          "step_ms": time_cuda(lambda: step(x0s, U0),
                                               iters=3)}
        return out
    finally:
        dist.destroy_process_group()


def phase12(plan, ref5, ref64, check_f32):
    """Config 5 on a mesh: the gloo ranks (``mesh_rank``), then one NCCL
    rank in this process, each held against phase 8's one-card step
    (``ref5``: u0, U_next, costs, the closed loop's states xs, numpy) and,
    by the float32 rule, against the float64 one-card step and closed loop
    (``ref64``).
    Returns (the result, every launch dict of the main path)."""
    from gridcodegenerator_tpu_torch.parallel.launch import RankGroup
    t0 = time.perf_counter()
    on_card = plan["device"].startswith("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        with RankGroup(MESH_RANKS, f"file://{tmp}/gloo", "gloo",
                       timeout_s=300) as group:
            start_s = time.perf_counter() - t0
            ranks = group.run(mesh_rank, plan, timeout_s=900)
        nccl = (nccl_step(plan, ref5, f"file://{tmp}/nccl") if on_card
                else None)
    runs, robots = [], {}
    for robot in plan["robots"]:
        rr = [r["robots"][robot] for r in ranks]
        ref = ref5[robot]
        kinds = {}
        for kind in MESH_STEP:
            # the global arrays from each dp shard's first rank (rank
            # dp * kp holds shard dp)
            kp = KP12 if kind == "hybrid" else 1
            firsts = [rr[d * kp][kind] for d in range(MESH_RANKS // kp)]
            kinds[kind] = {"u0": firsts[0]["u0"]} | {
                f: np.concatenate([x[f] for x in firsts], axis=-1)
                for f in ("U_next", "costs")}
            for x in rr:
                runs.append(x[kind]["launches"])
                if not np.array_equal(x[kind]["u0"], firsts[0]["u0"]):
                    raise AssertionError(f"{robot} {kind}: u0 differs "
                                         f"between ranks")
        runs += [x["hybrid"]["closed_loop_launches"] for x in rr]
        flat, hyb = kinds["flat"], kinds["hybrid"]
        # flat: each scenario's cost and U_next are phase 8's, bit for bit
        # (per-lane kernels); u0 sums in another order
        for f in ("U_next", "costs"):
            if not np.array_equal(flat[f], ref[f]):
                raise AssertionError(
                    f"{robot} flat mesh: {f} is not phase 8's (max diff "
                    f"{np.abs(flat[f] - ref[f]).max()})")
        u0_err = float(np.abs(flat["u0"] - ref["u0"]).max())
        u0_tol = 1e-6 * max(1.0, float(np.abs(ref["u0"]).max()))
        if not u0_err <= u0_tol:
            raise AssertionError(f"{robot} flat mesh: u0 off phase 8's by "
                                 f"{u0_err} (tol {u0_tol})")
        # hybrid: the kp replicas of a dp shard are equal, bit for bit
        for d in range(MESH_RANKS // KP12):
            for q in range(1, KP12):
                a, b = rr[d * KP12]["hybrid"], rr[d * KP12 + q]["hybrid"]
                for f in ("U_next", "costs"):
                    if not np.array_equal(a[f], b[f]):
                        raise AssertionError(f"{robot} hybrid: kp replicas "
                                             f"differ in {f}")
        # hybrid against flat by the float32 rule (float64 one-card step)
        rule = {}
        for f in ("u0", "U_next", "costs"):
            ek, ep = check_f32(f"{robot} hybrid mesh {f}",
                               torch.as_tensor(hyb[f]),
                               torch.as_tensor(flat[f]),
                               torch.as_tensor(ref64[robot][f]))
            rule[f] = {"hybrid_err_vs_f64": ek, "flat_err_vs_f64": ep}
        # the closed loop on the hybrid mesh against phase 8's one-card
        # loop by the float32 rule (the same loop in float64 the reference)
        cl_err, cl_one = check_f32(
            f"{robot} hybrid closed loop",
            torch.as_tensor(rr[0]["hybrid"]["xs"]),
            torch.as_tensor(ref["xs"]), torch.as_tensor(ref64[robot]["xs"]))
        timing = {}
        if plan["timed"]:
            for kind in MESH_STEP:
                ms = [x[kind]["step_ms"] for x in rr]
                timing[kind] = {"step_ms": max(ms), "rank_step_ms": ms,
                                "scenario_solves_per_s": plan["S"] / (
                                    max(ms) / 1e3)}
            timing["kp_backward_ms"] = max(
                x["hybrid"]["kp_backward_ms"] for x in rr)
            timing["rank_kp_backward_ms"] = [x["hybrid"]["kp_backward_ms"]
                                             for x in rr]
        robots[robot] = {
            "flat_equal_to_phase8": True, "flat_u0_err": u0_err,
            "hybrid_f32_rule": rule, "closed_loop_err_vs_f64": cl_err,
            "one_card_closed_loop_err_vs_f64": cl_one,
            "fd_du_lanes": {k: rr[0][k]["fd_du_lanes"] for k in MESH_STEP},
            "local_scenarios": {k: rr[0][k]["local_scenarios"]
                                for k in MESH_STEP},
            "staged_bytes_per_step": {k: [x[k]["staged_bytes"] for x in rr]
                                      for k in MESH_STEP},
            "staged_s_per_step": {k: [x[k]["staged_s"] for x in rr]
                                  for k in MESH_STEP},
            "f64_first64": [x["hybrid"]["f64_first64"] for x in rr],
            **timing}
    if nccl is not None:
        runs += [v["launches"] for v in nccl.values()]
    return {"ranks": MESH_RANKS, "kp": KP12, "start_s": start_s,
            "robots": robots, "nccl_one_rank": nccl,
            "nccl_shared_card_refused": all(
                r.get("nccl_shared_card_refused", False) for r in ranks)
            if on_card and plan.get("backend", "gloo") == "gloo" else None,
            "seconds": time.perf_counter() - t0}, runs


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
    from gridcodegenerator_tpu_torch.codegen import ALGORITHMS, gen_all_code
    from gridcodegenerator_tpu_torch.codegen.emit import KERNELS as GEN_KERNELS
    from gridcodegenerator_tpu_torch.models.model import build_model
    from gridcodegenerator_tpu_torch.models.zoo import load_robot as zoo_robot
    from gridcodegenerator_tpu_torch.models.zoo import pendulum_urdf
    from gridcodegenerator_tpu_torch.topology.urdf import parse_urdf

    def load_robot(name):
        """The zoo's robot, or "pendulum20": a 20-joint chain."""
        if name == "pendulum20":
            return parse_urdf(pendulum_urdf(20), name="pendulum20")
        return zoo_robot(name)
    from gridcodegenerator_tpu_torch.ops import eepose
    from gridcodegenerator_tpu_torch.ops.cuda import build
    from gridcodegenerator_tpu_torch.ops.cuda import kernels as K
    from gridcodegenerator_tpu_torch.ops.cuda import sweeps as S
    from gridcodegenerator_tpu_torch.parallel.scenario import (
        ScenarioMPCConfig, closed_loop, make_scenario_step)
    from gridcodegenerator_tpu_torch.reference import oracle
    from gridcodegenerator_tpu_torch.trajopt.cost import (CostModel,
                                                          EEReachCost,
                                                          QuadCost)
    from gridcodegenerator_tpu_torch.trajopt.ilqr import (
        ILQRConfig, make_ilqr, resolve_control_bounds)
    from gridcodegenerator_tpu_torch.trajopt import priccati
    from gridcodegenerator_tpu_torch.trajopt.sqp import SQPConfig, make_sqp
    from gridcodegenerator_tpu_torch.utils import opcount
    from gridcodegenerator_tpu_torch.utils.timing import time_cuda

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()

    def elapsed():
        """Seconds since the build began, for the lines of the phases this
        run added last (where its time goes)."""
        return round(time.perf_counter() - t0, 1)

    # each phase's start (elapsed()), for the phase_seconds line
    phase_start = {1: 0.0}

    # the robots above 28 joints of phases 13 and 14 (tests/
    # torch_big_robots.py): atlas with two hands, atlas with two grippers
    spec = importlib.util.spec_from_file_location(
        "torch_big_robots", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "torch_big_robots.py"))
    hands = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hands)
    topo13 = parse_urdf(hands.atlas_hands_urdf(HANDS13),
                        name=hands.atlas_hands_name(HANDS13))
    topo34 = parse_urdf(hands.atlas_hands_urdf(GRIPPERS14),
                        name=hands.atlas_hands_name(GRIPPERS14))
    topo64 = parse_urdf(hands.atlas_hands_urdf(GRIPPERS13),
                        name=hands.atlas_hands_name(GRIPPERS13))
    nj13, nj34 = topo13.get_num_joints(), topo34.get_num_joints()
    nj64 = topo64.get_num_joints()
    # every library the run loads, in one pool of nvcc jobs (the zoo's
    # counts, phase 2's new counts, phases 13 and 14's), and the host
    # operation counter's g++ beside it
    opcount_build = {}

    def build_opcount():
        t = time.perf_counter()
        opcount.lib()
        opcount_build["seconds"] = round(time.perf_counter() - t, 3)

    counter = threading.Thread(target=build_opcount)
    counter.start()
    libs = build.build(build.SUPPORTED_JOINTS + FIRST_USE
                       + (nj34, nj13, nj64))
    for nj in libs:
        build.lib(nj)
    t1 = time.perf_counter()
    counter.join()
    opcount.lib()
    line("build", {"seconds": round(t1 - t0, 3),
                   "opcount_seconds": opcount_build["seconds"],
                   "opcount_wait_seconds": round(time.perf_counter() - t1,
                                                 3),
                   "sources": len(build.SOURCES), "nvcc_jobs": os.cpu_count(),
                   "libraries": {nj: str(p.relative_to(
                       build.BUILD_ROOT.parents[1])) for nj, p in libs.items()},
                   "library_seconds": {nj: round(sec, 3) for nj, sec in
                                       build.NVCC_SECONDS.items()}})
    # the thread-group kernels: knots (problems, rollouts) a block, shared
    # bytes a block and cudaFuncGetAttributes of every instance; each holds
    # one knot at least, but fdsva_so's where its knot does not fit (28
    # joints, 20 in float64: the composed route runs there); idsva_so's
    # there holds a band of a knot
    plans = {(what, nj, dtype): build.warp_kernel_info(what, nj, dtype)
             for what in build.WARP_KERNELS
             for nj in build.SUPPORTED_JOINTS + FIRST_USE
             for dtype in (torch.float32, torch.float64)}
    line("warp_kernel_plans", {f"{what} {str(dtype)[6:]} nj{nj}": info
                               for (what, nj, dtype), info in plans.items()})
    composed = {(28, torch.float32), (28, torch.float64), (20, torch.float64)}
    for (what, nj, dtype), info in plans.items():
        refused = what == "fdsva_so" and (nj, dtype) in composed
        banded = what == "idsva_so" and (nj, dtype) in composed
        if ((info["knots_per_block"] < 1) != refused
                or (info["bands"] > 1) != banded):
            raise AssertionError(f"{what} {dtype} at {nj} joints: "
                                 f"{info['knots_per_block']} knots a block, "
                                 f"{info['bands']} bands")
        if what == "fdsva_so" and (K.fdsva_so_route(nj, dtype) == K.COMPOSED
                                   ) != refused:
            raise AssertionError(f"fdsva_so {dtype} at {nj} joints: route "
                                 f"{K.fdsva_so_route(nj, dtype)}")

    topo = load_robot("iiwa")

    def path_inputs(model, n_knots, batch, seed, dt=DT):
        """Each kernel's inputs as the solver's first iteration makes them,
        from x0 ~ U(-0.2, 0.2) and U0 = 0 (computed with the plain ops)."""
        n = model.n
        goal = eepose.eepos(model, torch.full((n, 1), 0.5, dtype=model.dtype,
                                              device=dev))[:3, 0]
        cost = EEReachCost(model=model, goal_xyz=goal, w_pos=0.5,
                           w_pos_f=200.0)
        cfg = ILQRConfig(N=n_knots, dt=dt, iters=ITERS, use_kernels=False)
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
        Jw, lx, lu = cost.gn_stage_factor(fold(X[:n_knots]), fold(U0), 0)
        ric = [A, Bm, lx.contiguous(), lu.contiguous(), Jw.contiguous(),
               Vx0.contiguous(), Vxx0.contiguous(), cfg.reg, *cost.gn_factor_diags]
        ks, Ks = S.riccati_factored_plain(*ric)
        lo, hi = resolve_control_bounds(model, cfg)
        al = torch.tensor(cfg.alphas, dtype=model.dtype, device=dev)[:, None]
        al = al.repeat(1, batch)
        return {
            "fd_du": (model, q, qd, u, GRAVITY),
            "rollout": (model, x0, U0, dt, GRAVITY, lo, hi),
            # one step size folded into the feedforward term: alpha = 0.25,
            # the line search's fourth row (alpha = 1 is an unstable closed
            # loop at config 3: float32 overflows on some problems)
            "feedback_rollout": (model, X[0].contiguous(), U0,
                                 X[:n_knots].contiguous(), FB_ALPHA * ks, Ks,
                                 dt, GRAVITY, lo, hi),
            "riccati_factored": tuple(ric),
            "linesearch_rollout": (model, X[0].contiguous(), U0,
                                   X[:n_knots].contiguous(), ks, Ks, al, dt,
                                   GRAVITY, lo, hi, cost),
            # the line search without a cost (a cost that is not
            # time-invariant is summed over its rollouts by the solver)
            "linesearch_nocost": (model, X[0].contiguous(), U0,
                                  X[:n_knots].contiguous(), ks, Ks, al, dt,
                                  GRAVITY, lo, hi, None),
        }

    def quad_cost(model, goal, qf=100.0):
        """bench.py's QuadCost: Q 0.1, R 1e-3, Qf ``qf`` (configs 3 and 4:
        100; config 5: 10), x_goal zero but for ``goal`` ({index:
        value})."""
        n = model.n
        full = lambda v, k: torch.full((k,), v, dtype=model.dtype, device=dev)
        xg = full(0.0, 2 * n)
        for i, v in goal.items():
            xg[i] = v
        return QuadCost(Q=full(0.1, 2 * n), R=full(1e-3, n),
                        Qf=full(qf, 2 * n), x_goal=xg)

    QUAD3 = {0: 1.0, 1: 0.5}    # config 3's QuadCost task (bench.py:187)
    QUAD4 = {0: 0.5}            # config 4 (bench.py:218)
    QUAD5 = {0: 0.2}            # config 5 (bench.py:254)

    def quad_inputs(model, n_knots, batch, seed, dt=DT):
        """The dense Riccati sweep's and the QuadCost line search's inputs as
        config 3's QuadCost task makes them on its first iteration (plain
        ops): the stationary curvature block, and per-knot blocks (scaled
        per knot, so that the knot index matters); and a rollout of
        controls ~ U(-4, 4) under bounds (-3, 3.5)."""
        n = model.n
        cost = quad_cost(model, QUAD3)
        cfg = ILQRConfig(N=n_knots, dt=dt, iters=ITERS, use_kernels=False)
        _, parts = make_ilqr(model, cost, cfg, expose_parts=True)
        rng = np.random.default_rng(seed)
        x0 = torch.as_tensor(rng.uniform(-0.2, 0.2, (2 * n, batch)),
                             dtype=model.dtype, device=dev)
        U0 = torch.zeros((n_knots, n, batch), dtype=model.dtype, device=dev)
        X = parts["rollout"](x0, U0)
        A, Bm = parts["linearize"](X[:n_knots], U0)
        fold = lambda Z: Z.transpose(0, 1).reshape(Z.shape[1], -1)
        unfold = lambda z: z.reshape(z.shape[:-1] + (n_knots, batch)).movedim(
            -2, 0)
        _, Vx0, Vxx0 = cost.terminal_expansion(X[n_knots])
        _, lx, lu, lxx, luu, lux = cost.stage_expansion(fold(X[:n_knots]),
                                                        fold(U0), 0)
        head = (A, Bm, unfold(lx).contiguous(), unfold(lu).contiguous())
        tail = (Vx0.contiguous(), Vxx0.contiguous(), cfg.reg)
        scale = (1.0 + torch.arange(n_knots, dtype=model.dtype, device=dev)
                 / n_knots)[:, None, None, None]
        ric = head + tuple(c[..., :batch].contiguous()
                           for c in (lxx, luu, lux)) + tail
        ric_stacked = head + tuple((unfold(c) * scale).contiguous()
                                   for c in (lxx, luu, lux)) + tail
        ks, Ks = S.riccati_plain(*ric)
        lo, hi = resolve_control_bounds(model, cfg)
        al = torch.tensor(cfg.alphas, dtype=model.dtype, device=dev)[:, None]
        U = torch.as_tensor(rng.uniform(-4, 4, (n_knots, n, batch)),
                            dtype=model.dtype, device=dev)
        bound = lambda v: torch.full((n, 1), v, dtype=model.dtype,
                                     device=dev)
        return {"riccati": ric, "riccati_stacked": ric_stacked,
                "linesearch_quad": (model, X[0].contiguous(), U0,
                                    X[:n_knots].contiguous(), ks, Ks,
                                    al.repeat(1, batch), dt, GRAVITY, lo, hi,
                                    cost),
                "rollout": (model, x0, U, dt, GRAVITY, bound(-3.0),
                            bound(3.5))}

    def so_cases(model, lanes, seed):
        """idsva_so (q, qd, qdd) and fdsva_so (q, qd, u) on (n, lanes)
        inputs ~ U(-1, 1)."""
        rng = np.random.default_rng(seed)
        q, qd, x = (torch.as_tensor(rng.uniform(-1, 1, (model.n, lanes)),
                                    dtype=model.dtype, device=dev)
                    for _ in range(3))
        return {"idsva_so": (model, q, qd, x, GRAVITY),
                "fdsva_so": (model, q, qd, x, GRAVITY)}

    def roofline(name, model, args, out):
        """The least time the card could take for one call of kernel
        ``name`` on ``args`` -> ``out`` (bound_ms, bound_by "bytes" or
        "operations"): each input and output tensor moved once, and the
        operations one lane of the function needs (utils/opcount.py) times
        the lanes; and the operations the kernel executes (ops_executed).
        A Riccati sweep's count is N times one knot's (every knot runs the
        same arithmetic: counted at N = 1, for the counting's time at 52
        joints)."""
        kw, extra, knots = {}, (), 1
        if name in ("rollout", "feedback_rollout"):
            kw, lanes = dict(N=args[2].shape[0]), args[1].shape[-1]
        elif name.startswith("linesearch"):
            name, cost = "linesearch_rollout", args[-1]
            kw, lanes = dict(N=args[2].shape[0], cost=cost), args[6].numel()
            extra = () if cost is None else (build.cost_buffer(cost, args[1]),)
        elif name == "riccati_factored":
            kw, knots = dict(N=1, rank=args[4].shape[0]), args[0].shape[0]
            lanes = args[0].shape[-1]
        elif name.startswith("riccati"):
            name = "riccati"
            kw = dict(N=1, stationary=args[4].ndim == 3)
            knots, lanes = args[0].shape[0], args[0].shape[-1]
        else:
            lanes = args[1].shape[-1]
            if name in ("eepos", "deepos", "d2eepos"):
                extra = (build.ee_buffer(model),)
        if isinstance(args[0], type(model)):
            extra += (build.model_buffer(model),)
        ops = opcount.ops_per_lane(name, model, **kw) * lanes * knots
        ms, by = opcount.bound_ms(ops, opcount.tensor_bytes(args, out, extra),
                                  model.dtype)
        return {"bound_ms": ms, "bound_by": by, "ops": ops,
                "ops_executed": opcount.ops_per_lane(
                    name, model, executed=True, **kw) * lanes * knots}

    kernels = {
        "fd_du": (K.fd_du, K.fd_du_plain, K.SOURCES[K.FD_DU],
                  K.REPLACES[K.FD_DU]),
        "rollout": (S.rollout, S.rollout_plain, S.SOURCES[S.ROLLOUT],
                    S.REPLACES[S.ROLLOUT]),
        "feedback_rollout": (S.feedback_rollout, S.feedback_rollout_plain,
                             S.SOURCES[S.FEEDBACK], S.REPLACES[S.FEEDBACK]),
        "riccati_factored": (S.riccati_factored, S.riccati_factored_plain,
                             S.SOURCES[S.RICCATI], S.REPLACES[S.RICCATI]),
        "linesearch_rollout": (S.linesearch_rollout,
                               S.linesearch_rollout_plain,
                               S.SOURCES[S.LINESEARCH],
                               S.REPLACES[S.LINESEARCH]),
        "linesearch_nocost": (S.linesearch_rollout,
                              S.linesearch_rollout_plain,
                              S.SOURCES[S.LINESEARCH_NOCOST],
                              S.REPLACES[S.LINESEARCH_NOCOST]),
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
        "fd_du": (K.fd_du, K.fd_du_plain),
        "idsva_so": (K.idsva_so, K.idsva_so_plain),
        "fdsva_so": (K.fdsva_so, K.fdsva_so_plain),
        "d2eepos": (K.d2eepos, K.d2eepos_plain),
        "riccati": (S.riccati, S.riccati_plain),
        "riccati_stacked": (S.riccati, S.riccati_plain),
        "rollout": (S.rollout, S.rollout_plain),
        "linesearch_quad": (S.linesearch_rollout,
                            S.linesearch_rollout_plain)}

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
    phase_start[2] = elapsed()
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
    # the second-order kernels, riccati and the QuadCost line search:
    # within 1e-9 of each output's scale max(1, max|ref|)
    small_new = {}
    new_cases = [(f"{m.name} {c}", c, a) for m in (m64, hyq64)
                 for c, a in so_cases(m, 37, seed=1).items()]
    new_cases.append(("iiwa linesearch_quad", "linesearch_quad",
                      quad_inputs(m64, 8, 37, seed=1)["linesearch_quad"]))
    # d2eepos on chains, branched robots, gym_ant's welded EEs (zero blocks)
    # and its feet; every GRiD kernel case on the 8- and 16-joint instances
    gym64, gymw64, dmq64 = (build_model(t, dtype=torch.float64, device=dev)
                            for t in (leaf_ees(load_robot("gym_ant")),
                                      load_robot("gym_ant"),
                                      load_robot("dm_quadruped")))
    for what, m in (("iiwa", m64), ("hyq", hyq64), ("gym_ant welded", gymw64),
                    ("gym_ant feet", gym64), ("dm_quadruped", dmq64)):
        q = torch.as_tensor(np.random.default_rng(1).uniform(
            -1, 1, (m.n, 37)), dtype=torch.float64, device=dev)
        new_cases.append((f"{what} d2eepos", "d2eepos", (m, q)))
    for m in (gym64, dmq64):
        new_cases += [(f"{m.name} {c}", c, a) for c, a in (
            lane_cases(m, 37, seed=1, with_fd_du=True)
            | so_cases(m, 37, seed=1)).items()]
    # the dense riccati and the rollout (thread-group programs, one plan
    # per joint count) on every robot of configs 3 and 4
    for m in (m64, hyq64, gymw64, dmq64):
        ins_q = quad_inputs(m, 8, 37, seed=1, dt=DT4.get(m.name, DT))
        new_cases += [(f"sweep {m.name} {c}", c, ins_q[c])
                      for c in ("riccati", "riccati_stacked", "rollout")]
    for what, case, args in new_cases:
        case = case_kernel.get(case, case)
        kern, plain = case_fns[case]
        out, ref = as_tuple(kern(*args)), as_tuple(plain(*args))
        torch.cuda.synchronize()
        if len(out) != len(ref) or any(o.shape != r.shape
                                       for o, r in zip(out, ref)):
            raise AssertionError(f"{what}: kernel and plain outputs differ "
                                 f"in number or shape")
        err = max_err(out, ref)
        tol = 1e-9 * max(1.0, max(float(r.abs().max()) for r in ref))
        if not err <= tol:
            raise AssertionError(f"{what} float64: max abs err {err} > {tol}")
        small_new[what] = {"max_abs_err": err, "tol": tol}
    line("small_f64", {"robot": "iiwa", "N": 8, "B": 37,
                       "max_abs_err": small, "tol": 1e-9})
    slice5 = ("gym_ant", "dm_quadruped", "d2eepos")
    sweeps = {k[6:]: small_new.pop(k) for k in list(small_new)
              if k.startswith("sweep ")}
    line("small_f64_second_order_quad", {"B": 37, "N": 8, "cases": {
        k: v for k, v in small_new.items() if not any(
            w in k for w in slice5)}})
    line("small_f64_d2eepos_8_16_joints", {"B": 37, "cases": {
        k: v for k, v in small_new.items() if any(w in k for w in slice5)}})
    line("small_f64_riccati_rollout_4_robots", {"B": 37, "N": 8,
                                                "cases": sweeps})
    line("small_f64_hyq", {"robot": "hyq", "joints": hyq64.n,
                           "ees": build.ee_buffer(hyq64).shape[0],
                           "B": 37, "max_abs_err": small_hyq, "tol": 1e-9})

    # every kernel on the 17- and 28-joint instances (gym_humanoid, atlas;
    # the sweeps at config 5's dt) and on the counts built at first use
    # (pendulum4, mixed5, the 20-joint chain): within 1e-9 of each output's
    # scale; idsva_so in bands and fdsva_so composed where their knot does
    # not fit (atlas; the chain in float64), held at 37 and 128 lanes
    kernel_of = case_kernel | {"rollout_bounded": "rollout",
                               "riccati_stacked": "riccati",
                               "linesearch_quad": "linesearch_rollout"}
    fns_of = case_fns | {k: kernels[k][:2] for k in kernels} | {
        "rnea_bias": case_fns["rnea"], "minv_upper": case_fns["minv"],
        "rollout_bounded": case_fns["rollout"]}
    all_kernels = set(K.SOURCES) | set(S.SOURCES)
    humanoids = {}
    for robot in ROBOTS5 + ROBOTS_NEW:
        m = build_model(load_robot(robot), dtype=torch.float64, device=dev)
        dt5 = DT5.get(robot, DT_NEW.get(robot, DT))
        q = torch.as_tensor(np.random.default_rng(1).uniform(
            -1, 1, (m.n, 37)), dtype=torch.float64, device=dev)
        quad = quad_inputs(m, 8, 37, seed=1, dt=dt5)
        quad["rollout_bounded"] = quad.pop("rollout")
        cases = (path_inputs(m, 8, 37, seed=1, dt=dt5)
                 | lane_cases(m, 37, seed=1) | {"d2eepos": (m, q)} | quad
                 | so_cases(m, 37, seed=1))
        if robot in ("atlas", "pendulum20"):
            cases |= {f"{c} B=128": a
                      for c, a in so_cases(m, 128, seed=2).items()}
        errs, routes = {}, {}
        for case, args in cases.items():
            name = kernel_of.get(case.split(" ")[0], case.split(" ")[0])
            kern, plain = fns_of[case.split(" ")[0]]
            what = f"{robot} {case}"
            build.reset_counters()
            out = as_tuple(kern(*args))
            torch.cuda.synchronize()
            if name in ("idsva_so", "fdsva_so"):
                routes[case] = dict(build.LAUNCHES)
            ref = as_tuple(plain(*args))
            if len(out) != len(ref) or any(o.shape != r.shape
                                           for o, r in zip(out, ref)):
                raise AssertionError(f"{what}: kernel and plain outputs "
                                     f"differ in number or shape")
            err = max_err(out, ref)
            tol = 1e-9 * max(1.0, max(float(r.abs().max()) for r in ref))
            if not err <= tol:
                raise AssertionError(f"{what} float64: max abs err {err} > "
                                     f"{tol}")
            errs[case] = {"max_abs_err": err, "tol": tol}
            del out, ref
        covered = {kernel_of.get(c, c) for c in errs}
        if not all_kernels <= covered:
            raise AssertionError(f"{robot}: kernels not held "
                                 f"{sorted(all_kernels - covered)}")
        want = ({"fd_du": 1, "idsva_so": 1} if K.fdsva_so_route(
            m.n, torch.float64) == K.COMPOSED else {"fdsva_so": 1})
        if routes["fdsva_so"] != want or routes["idsva_so"] != {
                "idsva_so": 1}:
            raise AssertionError(f"{robot}: second-order launches {routes}")
        humanoids[robot] = {
            "joints": m.n, "dt": dt5, "cases": errs, "so_launches": routes,
            "idsva_so_bands": build.plan("idsva_so", m.n,
                                         torch.float64)["bands"]}
        del cases, quad
        torch.cuda.empty_cache()
    line("small_f64_17_28_joints", {"B": 37, "N": 8, "robots": {
        r: humanoids[r] for r in ROBOTS5}})
    line("small_f64_new_joint_counts", {"B": 37, "N": 8, "robots": {
        r: humanoids[r] for r in ROBOTS_NEW}, "elapsed_s": elapsed()})

    # minv (dense and the upper factor), crba and deepos, a thread group a
    # knot, G knots a block: a block's one knot, a ragged second block
    # (G + 1) and 37 lanes, each call one launch, within 1e-9 of each
    # output's scale
    ragged = {}
    for robot in ("iiwa", "hyq") + ROBOTS5:
        m = build_model(load_robot(robot), dtype=torch.float64, device=dev)
        for case in ("minv", "minv_upper", "crba", "deepos"):
            g = build.plan(case_kernel[case], m.n,
                           torch.float64)["knots_per_block"]
            for lanes in (1, g + 1, 37):
                args = lane_cases(m, lanes, seed=3)[case]
                kern, plain = case_fns[case_kernel[case]]
                build.reset_counters()
                out = kern(*args)
                torch.cuda.synchronize()
                what = f"{robot} {case} L={lanes}"
                if dict(build.LAUNCHES) != {case_kernel[case]: 1}:
                    raise AssertionError(f"{what}: launches "
                                         f"{dict(build.LAUNCHES)}")
                ref = plain(*args)
                err = max_err((out,), (ref,))
                tol = 1e-9 * max(1.0, float(ref.abs().max()))
                if out.shape != ref.shape or not err <= tol:
                    raise AssertionError(f"{what} float64: max abs err {err} "
                                         f"> {tol}")
                if case == "minv_upper":
                    lo = out.permute(2, 0, 1).tril(-1)
                    if bool(lo.any()) or bool(torch.signbit(lo).any()):
                        raise AssertionError(f"{what}: not +0 below the "
                                             f"diagonal")
                ragged[what] = {"max_abs_err": err, "tol": tol}
    line("minv_crba_f64_ragged", {"cases": {
        k: v for k, v in ragged.items() if " deepos " not in k}})
    line("deepos_f64_ragged", {"cases": {
        k: v for k, v in ragged.items() if " deepos " in k},
        "elapsed_s": elapsed()})

    # the float64 dynamics kernels against the float64 oracle
    # (reference/oracle.py, the numpy anchor of the JAX package), lane by
    # lane, on ORACLE_LANES lanes of every robot of this phase: within
    # ORACLE_REL of each output's scale max(1, max|oracle|), beside the
    # plain twin's distance to it; one launch a call
    oracle_of = {
        "rnea": lambda t, q, qd, x: (oracle.rnea(t, q, qd, x)[0],),
        "minv": lambda t, q, qd, x: (oracle.minv(t, q),),
        "crba": lambda t, q, qd, x: (oracle.crba(t, q),),
        "aba": lambda t, q, qd, x: (oracle.aba(t, q, qd, x),),
        "fd": lambda t, q, qd, x: (oracle.forward_dynamics(t, q, qd, x),),
        "id_du": lambda t, q, qd, x: (oracle.rnea_grad(t, q, qd, x),),
        "fd_du": lambda t, q, qd, x: oracle.fd_grad(t, q, qd, x)}
    vs_oracle = {}
    for robot in ("iiwa", "hyq", "gym_ant", "dm_quadruped") + ROBOTS5 + \
            ROBOTS_NEW:
        topo_r = load_robot(robot)
        m = build_model(topo_r, dtype=torch.float64, device=dev)
        cases = lane_cases(m, ORACLE_LANES, seed=7, with_fd_du=True)
        lanes_np = [a.cpu().numpy() for a in cases["rnea"][1:4]]
        for case, orc in oracle_of.items():
            args = cases[case]
            kern, plain = case_fns[case]
            build.reset_counters()
            out = as_tuple(kern(*args))
            torch.cuda.synchronize()
            what = f"{robot} {case}"
            if dict(build.LAUNCHES) != {case: 1} or build.PLAIN_CALLS:
                raise AssertionError(f"{what}: launches "
                                     f"{dict(build.LAUNCHES)}, plain calls "
                                     f"{dict(build.PLAIN_CALLS)}")
            per_lane = [orc(topo_r, *(a[:, b] for a in lanes_np))
                        for b in range(ORACLE_LANES)]
            ref = tuple(torch.as_tensor(np.stack([r[k] for r in per_lane],
                                                 -1), device=dev)
                        for k in range(len(out)))
            err = max_err(out, ref)
            tol = ORACLE_REL * max(1.0, max(float(r.abs().max())
                                            for r in ref))
            if any(o.shape != r.shape for o, r in zip(out, ref)) or \
                    not err <= tol:
                raise AssertionError(f"{what} float64 vs the oracle: max abs "
                                     f"err {err} > {tol}")
            vs_oracle[what] = {"max_abs_err": err, "tol": tol,
                               "plain_max_abs_err": max_err(
                                   as_tuple(plain(*args)), ref)}
    line("oracle_f64", {"lanes": ORACLE_LANES, "rel": ORACLE_REL,
                        "cases": vs_oracle, "elapsed_s": elapsed()})

    # -- phase 3: config-3 shapes, float32 ----------------------------------
    phase_start[3] = elapsed()
    m32 = build_model(topo, dtype=torch.float32, device=dev)
    m32_64 = m32.to(dtype=torch.float64)
    hyq32 = build_model(load_robot("hyq"), dtype=torch.float32, device=dev)
    hyq32_64 = hyq32.to(dtype=torch.float64)
    gym32, dmq32 = (build_model(load_robot(r), dtype=torch.float32, device=dev)
                    for r in ("gym_ant", "dm_quadruped"))
    f64_of = {id(m): m.to(dtype=torch.float64) for m in (gym32, dmq32)}
    f64_of |= {id(m32): m32_64, id(hyq32): hyq32_64}

    def to64(a):
        if isinstance(a, torch.Tensor):
            return a.double()
        if isinstance(a, EEReachCost):
            return dataclasses.replace(a, model=m32_64,
                                       goal_xyz=a.goal_xyz.double())
        if isinstance(a, QuadCost):
            return QuadCost(Q=a.Q.double(), R=a.R.double(), Qf=a.Qf.double(),
                            x_goal=a.x_goal.double())
        return f64_of.get(id(a), a)

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
            if name.startswith("linesearch") else 1
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
            "ms": ms, "plain_ms": plain_ms} | roofline(name, m32, args, out)
    line("config3_f32", {k: {f: v[f] for f in (
        "max_abs_err", "kernel_err_vs_f64", "plain_err_vs_f64", "ms",
        "plain_ms", "bound_ms", "bound_by", "ops", "ops_executed")}
        for k, v in results.items()})

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

    # fd_du and fdsva_so (a warp per knot, G knots a block) in float32 at
    # 37 lanes, a ragged block, on every robot of phase 2, by the rule above
    warp37 = {}
    for model in (m32, hyq32, gym32, dmq32):
        args = so_cases(model, 37, seed=1)["fdsva_so"]
        for name in ("fd_du", "fdsva_so"):
            kern, plain = case_fns[name]
            out, ref = as_tuple(kern(*args)), as_tuple(plain(*args))
            ref64 = as_tuple(plain(*map(to64, args)))
            torch.cuda.synchronize()
            errs = [check_f32(f"{model.name} {name} L=37 output {k}", o, r,
                              r64)
                    for k, (o, r, r64) in enumerate(zip(out, ref, ref64))]
            warp37[f"{model.name} {name}"] = {
                "kernel_err_vs_f64": max(e[0] for e in errs),
                "plain_err_vs_f64": max(e[1] for e in errs)}
    line("warp_kernels_f32_37_lanes", warp37)

    grid_f32 = {}
    for lanes in (L1, N * B):
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
                "plain_ms": time_cuda(lambda: plain(*args), iters=3),
                "bound": (roofline(case, m32, args, (out,))
                          if case == case_kernel[case] else None)}
    line("grid_kernels_f32", {f"{case} L={lanes}": v
                              for (case, lanes), v in grid_f32.items()})
    for name, (_, _, src, repl) in grid_kernels.items():
        results[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "max_abs_err": max(v["max_abs_err"] for (c, lanes), v
                               in grid_f32.items()
                               if case_kernel[c] == name and lanes == L1),
            "ms": grid_f32[name, L1]["ms"],
            "plain_ms": grid_f32[name, L1]["plain_ms"]} | grid_f32[
                name, L1]["bound"]

    def timed_f32(what, kern, plain, args, model, name, iters,
                  plain_iters=2):
        """The float32 rule on every output, and the kernel's and plain
        version's times and bound (the plain version's reference call is its
        warm-up: at 52 joints a plain call takes seconds)."""
        out, ref = as_tuple(kern(*args)), as_tuple(plain(*args))
        ref64 = as_tuple(plain(*map(to64, args)))
        torch.cuda.synchronize()
        ek = ep = 0.0
        for k, (o, r, r64) in enumerate(zip(out, ref, ref64)):
            e = check_f32(f"{what} output {k}", o, r, r64)
            ek, ep = max(ek, e[0]), max(ep, e[1])
        del ref64
        return {"max_abs_err": max_err(out, ref), "kernel_err_vs_f64": ek,
                "plain_err_vs_f64": ep,
                "ms": time_cuda(lambda: kern(*args), iters=iters),
                "plain_ms": time_cuda(lambda: plain(*args),
                                      iters=plain_iters, warmup=0)} | \
            roofline(name, model, args, out)

    # riccati with the stationary curvature at config 3's QuadCost shapes
    new_f32 = {f"riccati N={N} B={B}": timed_f32(
        "riccati", S.riccati, S.riccati_plain,
        quad_inputs(m32, N, B, seed=0)["riccati"], m32, "riccati", 20)}
    # idsva_so and fdsva_so at 1024 lanes and at config 4's N*B lanes
    for model in (m32, hyq32):
        for lanes in (L1, N4 * B4[model.name]):
            for case, args in so_cases(model, lanes, seed=0).items():
                what = f"{model.name} {case} L={lanes}"
                new_f32[what] = timed_f32(what, *case_fns[case], args, model,
                                          case, 10)
                del args
            torch.cuda.empty_cache()
    line("second_order_riccati_f32", new_f32)
    # rnea (with qdd and the bias form) and aba at one lane, config 1's id
    # at B=1 and config 5's plant, on iiwa and the humanoids, and fd and
    # eepos (config 1's unbatched calls) on iiwa and atlas: the float32
    # rule, times and bounds (the bias form's bound counts rnea's need with
    # qdd)
    one_lane = {}
    for robot in ("iiwa",) + ROBOTS5:
        model = m32 if robot == "iiwa" else build_model(
            load_robot(robot), dtype=torch.float32, device=dev)
        f64_of.setdefault(id(model), model.to(dtype=torch.float64))
        cases = lane_cases(model, 1, seed=0)
        for case in ("rnea", "rnea_bias", "aba") + (
                ("fd", "eepos") if robot in ("iiwa", "atlas") else ()):
            what = f"{robot} {case} L=1"
            one_lane[what] = timed_f32(what, *case_fns[case_kernel[case]],
                                       cases[case], model, case_kernel[case],
                                       100)
    line("rnea_aba_f32_one_lane", one_lane)

    # the warp-per-knot kernels at the main paths' other shapes: fd_du at
    # L1 lanes and at config 4's N*B lanes, fdsva_so at config 4's lanes on
    # gym_ant and dm_quadruped; each held to the float32 rule on its first
    # L1 lanes (a float64 plain fdsva_so of 16384 16-joint lanes would take
    # gigabytes)
    warp_f32 = {}
    for name, model, lanes in (
            ("fd_du", m32, L1), ("fd_du", m32, N4 * B4["iiwa"]),
            ("fd_du", gym32, N4 * B4["gym_ant"]),
            ("fd_du", hyq32, N4 * B4["hyq"]),
            ("fd_du", dmq32, N4 * B4["dm_quadruped"]),
            ("fdsva_so", gym32, N4 * B4["gym_ant"]),
            ("fdsva_so", dmq32, N4 * B4["dm_quadruped"])):
        what = f"{model.name} {name} L={lanes}"
        args = so_cases(model, lanes, seed=0)["fdsva_so"]
        kern, plain = case_fns[name]
        out = as_tuple(kern(*args))
        head = (model, *(a[:, :L1].contiguous() for a in args[1:4]), GRAVITY)
        ref, ref64 = as_tuple(plain(*head)), as_tuple(plain(*map(to64, head)))
        for k, (o, r, r64) in enumerate(zip(out, ref, ref64)):
            check_f32(f"{what} output {k}", o[..., :L1], r, r64)
        warp_f32[what] = {"ms": time_cuda(lambda: kern(*args), iters=10)} | \
            roofline(name, model, args, out)
        del args, out, ref, ref64
        torch.cuda.empty_cache()
    line("warp_kernels_f32", warp_f32)

    # d2eepos at L1 lanes and at L_HESS lanes (inputs ~ U(-1, 1))
    hess_f32 = {}
    for model in (m32, hyq32, dmq32):
        for lanes in (L1, L_HESS[model.name]):
            q = torch.as_tensor(np.random.default_rng(0).uniform(
                -1, 1, (model.n, lanes)), dtype=torch.float32, device=dev)
            what = f"{model.name} d2eepos L={lanes}"
            hess_f32[what] = timed_f32(what, K.d2eepos, K.d2eepos_plain,
                                       (model, q), model, "d2eepos", 10)
            del q
            torch.cuda.empty_cache()
    # the feedback rollout (kff = FB_ALPHA k, exact) against the line
    # search's alpha = FB_ALPHA row on the same float64 inputs (config-3
    # shapes, gains from its first backward): both kernels run the line
    # search's block and step code (csrc/sweep_warp.cuh), the feedback
    # rollout at a step size of exactly 1, so alpha k + s there is FB_ALPHA
    # k + s here under any contraction into FMAs: the two are equal.
    ls = list(map(to64, ins["linesearch_rollout"]))
    ls[6] = torch.full_like(ls[6][:1], FB_ALPHA)
    out_ls = S.linesearch_rollout(*ls)[:2]
    out_fb = S.feedback_rollout(*ls[:4], FB_ALPHA * ls[4], *ls[5:6],
                                *ls[7:11])
    torch.cuda.synchronize()
    lane_err = torch.stack([(a - b).abs().flatten(0, -2).amax(0)
                            for a, b in zip(out_fb, out_ls)]).amax(0)
    if not all(torch.equal(a, b) for a, b in zip(out_fb, out_ls)):
        raise AssertionError(f"feedback_rollout vs the line search's alpha = "
                             f"{FB_ALPHA} row, float64: "
                             f"{int((lane_err != 0).sum())} problems differ "
                             f"(worst by {float(lane_err.max())})")
    hess_f32[f"feedback_rollout vs linesearch alpha={FB_ALPHA} f64"] = {
        "equal": True, "problems": int(lane_err.numel())}
    del ls, out_fb, out_ls
    line("d2eepos_f32_feedback_f64", hess_f32)
    results["d2eepos"] = {"name": "d2eepos", "route": "cuda",
                          "source": K.SOURCES[K.D2EEPOS],
                          "replaces": K.REPLACES[K.D2EEPOS]} | hess_f32[
                              f"iiwa d2eepos L={L1}"]
    for name, key in (("riccati", f"riccati N={N} B={B}"),
                      ("idsva_so", f"iiwa idsva_so L={N4 * B4['iiwa']}"),
                      ("fdsva_so", f"iiwa fdsva_so L={N4 * B4['iiwa']}")):
        src = (S if name == "riccati" else K).SOURCES[name]
        repl = (S if name == "riccati" else K).REPLACES[name]
        results[name] = {"name": name, "route": "cuda", "source": src,
                         "replaces": repl} | new_f32[key]

    # -- phase 4: the slice ------------------------------------------------
    phase_start[4] = elapsed()
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
    # the EE cost: its pose in the first total cost's stage and terminal,
    # then in each iteration's terminal expansion and GN factor, with its
    # Jacobian
    expect = {"rollout": 1, "fd_du": ITERS, "riccati_factored": ITERS,
              "linesearch_rollout": ITERS, "eepos": 2 + 2 * ITERS,
              "deepos": 2 * ITERS}
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
    build.reset_counters()
    c_p32 = solve_with(m32, False)
    plain_launches = dict(build.LAUNCHES)
    c_k64 = solve_with(m32_64, None)
    build.reset_counters()
    c_p64 = solve_with(m32_64, False)
    plain_launches |= dict(build.LAUNCHES)
    if plain_launches:
        raise AssertionError(f"the plain solves launched {plain_launches}")
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
        "launches": launches, "phases": phases,
        "backward_ms_plain_ee_cost": BACKWARD_MS_PLAIN_EE})

    # The solved policy as a tracking controller (feedback_rollout, the
    # sweep entry point): feedforward 0, the solve's final gains K about its
    # X and U. From x0 every deviation starts at zero and stays so while
    # each step is computed as the solve's line search computed it: the
    # feedback rollout runs the line search's step code, so it retraces the
    # solve (the plain replay parts from it by the rounding of its own
    # order of operations, which the closed loop amplifies). So the replay
    # is held to the float32 rule against a float64 plain replay of the
    # same inputs, and its distance to the solve to F32_FACTOR times the
    # plain float32 replay's, plus F32_FLOOR of the scale. From a perturbed
    # x0 the gains act.
    lo, hi = resolve_control_bounds(m32, cfg)
    Xref, kff = res.X[:N].contiguous(), torch.zeros_like(res.k)
    x0p = x0 + 1e-3 * torch.as_tensor(
        np.random.default_rng(5).standard_normal(x0.shape),
        dtype=torch.float32, device=dev)
    build.reset_counters()
    track = [S.feedback_rollout(m32, x, res.U, Xref, kff, res.K, DT, GRAVITY,
                                lo, hi) for x in (x0, x0p)]
    torch.cuda.synchronize()
    track_launches = dict(build.LAUNCHES)
    if track_launches != {"feedback_rollout": 2} or build.PLAIN_CALLS:
        raise AssertionError(f"tracking launches {track_launches}, plain "
                             f"calls {dict(build.PLAIN_CALLS)}")
    targs = (m32, x0, res.U, Xref, kff, res.K, DT, GRAVITY, lo, hi)
    track_plain = S.feedback_rollout_plain(*targs)
    track64 = S.feedback_rollout_plain(*map(to64, targs))
    for k, (o, r, r64) in enumerate(zip(track[0], track_plain, track64)):
        check_f32(f"tracking from x0 output {k}", o, r, r64)
    del track64
    retrace = max_err(track[0], (res.X[1:], res.U))
    retrace_plain = max_err(track_plain, (res.X[1:], res.U))
    tol = F32_FACTOR * retrace_plain + F32_FLOOR * max(
        1.0, float(res.X.abs().max()), float(res.U.abs().max()))
    if not retrace <= tol:
        raise AssertionError(f"tracking from x0 leaves the solve: {retrace} "
                             f"> {tol} ({F32_FACTOR} x the plain replay's "
                             f"{retrace_plain} + floor)")
    if not all(bool(torch.isfinite(t).all()) for t in track[1]):
        raise AssertionError("tracking from a perturbed x0: non-finite")
    line("tracking", {"config": 3, "kernel": "feedback_rollout",
                      "retrace_max_abs_err": retrace,
                      "plain_retrace_max_abs_err": retrace_plain, "tol": tol,
                      "perturbed_x0_max_state_dev": float(
                          (track[1][0] - res.X[1:]).abs().max()),
                      "ms": time_cuda(lambda: S.feedback_rollout(
                          m32, x0p, res.U, Xref, kff, res.K, DT, GRAVITY,
                          lo, hi), iters=10),
                      "launches": track_launches})
    del track

    # -- phase 5: configs 1 and 2 and the rest of the API through GRiD -----
    phase_start[5] = elapsed()
    grids = {robot: (GRiD(robot, dtype=torch.float32, device=dev),
                     GRiD(robot, dtype=torch.float32, device=dev,
                          use_kernels=False),
                     GRiD(robot, dtype=torch.float64, device=dev,
                          use_kernels=False))
             for robot in ("iiwa", "hyq")}
    g = grids["iiwa"][0]
    n, BG = g.num_vel, L1
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
                          ("deepos", 1), ("d2eepos", 1)):
        calls[f"api_{method}_B1"] = ("iiwa", method, x1[:nargs], method)
        calls[f"api_{method}_B1024"] = ("iiwa", method, x2[:nargs], method)
    rng = np.random.default_rng(1)
    xh5 = tuple(rng.uniform(-1, 1, (B4["hyq"], 12)) for _ in range(3))
    for method in ("idsva_so", "fdsva_so"):
        calls[f"api_{method}_B1"] = ("iiwa", method, x1, method)
        calls[f"api_{method}_B1024"] = ("iiwa", method, x2, method)
        calls[f"hyq_{method}_B512"] = ("hyq", method, xh5, method)
    calls["hyq_d2eepos_B512"] = ("hyq", "d2eepos", xh5[:1], "d2eepos")
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
                          ("deepos", 1), ("d2eepos", 1), ("fk", 1)):
        fn = getattr(g, method)
        api[f"{method}_us_B1"] = us(lambda: fn(*t1[:nargs]), 200)
        api[f"{method}_us_B1024"] = us(lambda: fn(*t2[:nargs]), 100)
    th = on_card(xh)
    api["hyq_eepos_us_B1024"] = us(lambda: grids["hyq"][0].eepos(*th), 100)
    th5 = on_card(xh5)
    for method in ("idsva_so", "fdsva_so"):
        fn, fh = getattr(g, method), getattr(grids["hyq"][0], method)
        api[f"{method}_us_B1"] = us(lambda: fn(*t1), 100)
        api[f"{method}_us_B1024"] = us(lambda: fn(*t2), 50)
        api[f"hyq_{method}_us_B512"] = us(lambda: fh(*th5), 50)
    api["hyq_d2eepos_us_B512"] = us(
        lambda: grids["hyq"][0].d2eepos(th5[0]), 50)
    line("grid", {"configs": [1, 2], "robot": "iiwa", "dtype": "float32",
                  "B": BG, "device": smi, "config1": c1, "config2": c2,
                  "api": api, "max_err_vs_f64_plain": errs,
                  "launches": grid_launches})

    # -- path B: GRiD's second-order calls on the humanoids ---------------
    # idsva_so and fdsva_so unbatched and at B_SO through GRiD (float32):
    # the float32 rule against a float64 plain GRiD (unbatched and at the
    # first B_SO), launches by route, µs a call and evals/s; then each
    # step of the composed route (fd_du, idsva_so, the contractions) and,
    # where both routes run (gym_humanoid), both at config 4's N*B lanes:
    # the faster is the route
    from gridcodegenerator_tpu_torch.ops.so import fdsva_compose_lanes
    so_api, so_rows = {}, {}
    for robot in ROBOTS4_SO:
        gk = GRiD(robot, dtype=torch.float32, device=dev)
        gp = GRiD(robot, dtype=torch.float32, device=dev, use_kernels=False)
        g64 = GRiD(robot, dtype=torch.float64, device=dev, use_kernels=False)
        gk64 = GRiD(robot, dtype=torch.float64, device=dev)
        n, m = gk.num_vel, gk.model
        route = K.fdsva_so_route(n, torch.float32)
        expect = {"idsva_so": {"idsva_so": 1}, "fdsva_so": (
            {"fd_du": 1, "idsva_so": 1} if route == K.COMPOSED
            else {"fdsva_so": 1})}
        expect64 = {"idsva_so": {"idsva_so": 1}, "fdsva_so": (
            {"fd_du": 1, "idsva_so": 1}
            if K.fdsva_so_route(n, torch.float64) == K.COMPOSED
            else {"fdsva_so": 1})}
        rng = np.random.default_rng(3)
        row = {"route": route, "idsva_so_bands": build.plan(
            "idsva_so", n, torch.float32)["bands"]}
        for b in (1,) + B_SO:
            shape = (n,) if b == 1 else (b, n)
            x = on_card(rng.uniform(-1, 1, shape) for _ in range(3))
            for method in ("idsva_so", "fdsva_so"):
                fn = getattr(gk, method)
                build.reset_counters()
                out = fn(*x)
                torch.cuda.synchronize()
                if dict(build.LAUNCHES) != expect[method] or \
                        build.PLAIN_CALLS:
                    raise AssertionError(
                        f"{robot} GRiD.{method} B={b} launched "
                        f"{dict(build.LAUNCHES)}, expected {expect[method]}")
                if b <= B_SO[0]:
                    ref = getattr(gp, method)(*x)
                    x64 = tuple(a.double() for a in x)
                    ref64 = getattr(g64, method)(*x64)
                    row[f"{method}_B{b}_err_vs_f64"] = check_f32(
                        f"{robot} GRiD.{method} B={b}", out, ref, ref64)[0]
                    # the float64 kernels against the float64 plain GRiD
                    build.reset_counters()
                    out64 = getattr(gk64, method)(*x64)
                    torch.cuda.synchronize()
                    err = max_err((out64,), (ref64,))
                    tol = 1e-9 * max(1.0, float(ref64.abs().max()))
                    if dict(build.LAUNCHES) != expect64[method] or \
                            build.PLAIN_CALLS or not err <= tol:
                        raise AssertionError(
                            f"{robot} float64 GRiD.{method} B={b}: "
                            f"{dict(build.LAUNCHES)}, err {err} (tol {tol})")
                    row[f"{method}_B{b}_f64_err"] = {"max_abs_err": err,
                                                     "tol": tol}
                    del ref, ref64, out64, x64
                del out
                t_us = us(lambda: fn(*x), 20 if b < 1024 else 5)
                row[f"{method}_us_B{b}"] = t_us
                row[f"{method}_evals_per_s_B{b}"] = b / (t_us / 1e6)
            del x
        so_api[robot] = row
        # the route's steps and bounds at B_SO lanes and config 4's N*B
        for lanes in B_SO + (N4 * B4[robot],):
            args = so_cases(build_model(load_robot(robot),
                                        dtype=torch.float32, device=dev),
                            lanes, seed=4)
            mk = args["fdsva_so"][0]
            q, qd, u = args["fdsva_so"][1:4]
            d, qdd, Mi = K.fd_du(mk, q, qd, u)
            T = K.idsva_so(mk, q, qd, qdd)
            step = {"fd_du_ms": time_cuda(lambda: K.fd_du(mk, q, qd, u),
                                          iters=5),
                    "idsva_so_ms": time_cuda(
                        lambda: K.idsva_so(mk, q, qd, qdd), iters=5)}
            clone_ms = time_cuda(lambda: T.clone(), iters=3)
            step["compose_ms"] = time_cuda(
                lambda: fdsva_compose_lanes(T.clone(), d, Mi),
                iters=3) - clone_ms
            routes = {K.COMPOSED: K.fdsva_so_composed}
            if route == K.FUSED:
                routes[K.FUSED] = K.fdsva_so
            for r, fn in routes.items():
                step[f"fdsva_so_{r}_ms"] = time_cuda(
                    lambda: fn(mk, q, qd, u), iters=5)
            out = K.fdsva_so(mk, q, qd, u)
            step["fdsva_so_bound"] = roofline("fdsva_so", mk,
                                              args["fdsva_so"], (out,))
            del out
            outi = K.idsva_so(mk, q, qd, qdd)
            step["idsva_so_bound"] = roofline(
                "idsva_so", mk, (mk, q, qd, qdd, GRAVITY), (outi,))
            del outi, T, d, qdd, Mi, args, q, qd, u
            torch.cuda.empty_cache()
            so_rows[f"{robot} L={lanes}"] = step
            if lanes == N4 * B4[robot] and f"fdsva_so_{K.FUSED}_ms" in step:
                faster = min((K.FUSED, K.COMPOSED),
                             key=lambda r: step[f"fdsva_so_{r}_ms"])
                if faster != route:
                    raise AssertionError(f"{robot}: fdsva_so's route {route} "
                                         f"is not the faster: {step}")
    line("grid_so_humanoids", {"dtype": "float32", "device": smi,
                               "api": so_api, "steps": so_rows,
                               "elapsed_s": elapsed()})
    for name in ("idsva_so", "fdsva_so"):
        results[name]["humanoids"] = {
            key: {"ms": (v["idsva_so_ms"] if name == "idsva_so" else
                         v[f"fdsva_so_{so_api[key.split()[0]]['route']}_ms"]),
                  "route": (so_api[key.split()[0]]["route"]
                            if name == "fdsva_so" else
                            f"{so_api[key.split()[0]]['idsva_so_bands']} "
                            f"band(s)")}
            | {k: v[f"{name}_bound"][k] for k in ("bound_ms", "bound_by")}
            for key, v in so_rows.items()}

    # -- phase 6: config 4 (SQP) and config 3's QuadCost task -------------
    phase_start[6] = elapsed()
    def first64(make, cfg_cls, cfg_kw, model32, goal, x0n, c_k32, f64_at,
                cost_of=None):
        """On the first 64 problems: the float32 kernel solve's final costs,
        and a plain float32 solve's, each against a plain float64 solve
        (shares within rel 1e-3, median rel. differences); and a float64
        kernel solve against the plain float64 solve, iteration by
        iteration, held at iteration ``f64_at`` (see F64_REL). The cost is
        the QuadCost of ``goal``, or ``cost_of(model)`` for the first 64
        problems."""
        def run(model, use_kernels):
            n = model.n
            x = torch.as_tensor(x0n[:, :64], dtype=model.dtype, device=dev)
            U = torch.zeros((cfg_kw["N"], n, x.shape[-1]), dtype=model.dtype,
                            device=dev)
            cfg = cfg_cls(**cfg_kw, use_kernels=use_kernels)
            cost = cost_of(model) if cost_of else quad_cost(model, goal)
            return make(model, cost, cfg)(x, U).cost_trace.double().cpu()
        m64_ = f64_of[id(model32)]
        t_p32, t_p64, t_k64 = (run(model32, False), run(m64_, False),
                               run(m64_, None))
        c_p32, c_p64 = t_p32[-1], t_p64[-1]
        k = c_k32.double().cpu()[:c_p64.shape[0]]
        r_k, r_p = rel(k, c_p64), rel(c_p32, c_p64)
        r_at = rel(t_k64[f64_at], t_p64[f64_at])
        at = float((r_at <= F64_REL).double().mean())
        out = {"f32_kernel_vs_f64_plain": share(r_k),
               "f32_plain_vs_f64_plain": share(r_p),
               "kernel_median_rel": float(r_k.median()),
               "plain_median_rel": float(r_p.median()),
               "f64_held_at_iter": f64_at,
               "f64_kernel_vs_plain_share_at_iter": at,
               "f64_kernel_vs_plain_max_rel_at_iter": float(r_at.max()),
               "f64_kernel_vs_plain_share_per_iter": [
                   share(rel(a, b)) for a, b in zip(t_k64, t_p64)]}
        if not at >= F64_SHARE:
            raise AssertionError(f"float64 kernel solve at iteration {f64_at} "
                                 f"within rel {F64_REL} of the plain one on "
                                 f"{at} of the problems < {F64_SHARE}: {out}")
        # the rule of config 3 (phase 4): the kernel solve agrees with the
        # float64 solve on no fewer problems than the plain float32 solve
        # does, less 5 points
        if not (out["f32_kernel_vs_f64_plain"]
                >= out["f32_plain_vs_f64_plain"] - 0.05):
            raise AssertionError(f"float32 kernel solve less accurate than the "
                                 f"plain float32 solve: {out}")
        return out

    def check_run(what, res, expect, n_knots, batch, iters, n):
        runs = dict(build.LAUNCHES)
        if runs != expect or build.PLAIN_CALLS:
            raise AssertionError(f"{what} launches {runs} (expected "
                                 f"{expect}), plain calls "
                                 f"{dict(build.PLAIN_CALLS)}")
        if (res.X.shape != (n_knots + 1, 2 * n, batch)
                or res.U.shape != (n_knots, n, batch)
                or res.cost_trace.shape != (iters + 1, batch)):
            raise AssertionError(f"{what} returned the wrong shapes")
        tr = res.cost_trace
        if not bool(torch.isfinite(tr).all()):
            raise AssertionError(f"{what}: non-finite cost")
        if not bool((tr[1:] <= tr[:-1]).all()):
            raise AssertionError(f"{what}: cost increased")
        return runs

    path_runs = [launches, track_launches, grid_launches]
    config4 = {}
    rng = np.random.default_rng(0)              # config 4 (bench.py:211)
    models4 = {"iiwa": m32, "hyq": hyq32, "gym_ant": gym32,
               "dm_quadruped": dmq32}
    # path A: the same task on the humanoids, each x0 from its own
    # default_rng(0); fdsva_so composed at 28 joints (fd_du and idsva_so a
    # launch each)
    for robot in ROBOTS4_SO:
        models4[robot] = build_model(load_robot(robot), dtype=torch.float32,
                                     device=dev)
        f64_of[id(models4[robot])] = models4[robot].to(dtype=torch.float64)
    for robot, m in models4.items():
        n, b4 = m.n, B4[robot]
        cfg_kw = dict(N=N4, dt=DT4.get(robot, DT), iters=ITERS4)
        solve4, parts4 = make_sqp(m, quad_cost(m, QUAD4), SQPConfig(**cfg_kw),
                                  expose_parts=True)
        x0n = (np.random.default_rng(0) if robot in ROBOTS4_SO else
               rng).uniform(-0.2, 0.2, (2 * n, b4))
        x4 = torch.as_tensor(x0n, dtype=torch.float32, device=dev)
        U4 = torch.zeros((N4, n, b4), dtype=torch.float32, device=dev)
        route = K.fdsva_so_route(n, torch.float32)
        second = ({"fd_du": 2 * ITERS4, "idsva_so": ITERS4}
                  if route == K.COMPOSED
                  else {"fd_du": ITERS4, "fdsva_so": ITERS4})
        build.reset_counters()
        res4 = solve4(x4, U4)
        torch.cuda.synchronize()
        path_runs.append(check_run(
            f"config 4 {robot}", res4,
            {"rollout": 1, "linesearch_rollout": ITERS4} | second, N4, b4,
            ITERS4, n))
        agree = first64(make_sqp, SQPConfig, cfg_kw, m, QUAD4,
                        x4.double().cpu().numpy(), res4.cost, f64_at=1)
        ms4 = time_cuda(lambda: solve4(x4, U4), iters=5, warmup=1)
        X = parts4["rollout"](x4, U4)
        A, Bm = parts4["linearize"](X[:N4], U4)
        so = parts4["second_order"](X, U4)
        ks, Ks = parts4["backward"](X, U4, A, Bm, so)
        phases = {
            "rollout_ms": time_cuda(lambda: parts4["rollout"](x4, U4), iters=5),
            "linearize_ms": time_cuda(lambda: parts4["linearize"](X[:N4], U4),
                                      iters=5),
            "fdsva_so_ms": time_cuda(lambda: parts4["second_order"](X, U4),
                                     iters=5),
            "backward_ms": time_cuda(
                lambda: parts4["backward"](X, U4, A, Bm, so), iters=5),
            "forward_ms": time_cuda(lambda: parts4["forward"](X, U4, ks, Ks),
                                    iters=5)}
        config4[robot] = {
            "joints": n, "fdsva_so_route": route,
            "B": b4, "dt": cfg_kw["dt"], "solve_ms": ms4, "solves_per_s": b4 / (ms4 / 1e3),
            "cost_first_mean": float(res4.cost_trace[0].mean()),
            "cost_last_mean": float(res4.cost_trace[-1].mean()),
            "first64_final_cost": agree, "launches": path_runs[-1],
            "phases": phases}
        del X, A, Bm, so, ks, Ks
        torch.cuda.empty_cache()
    line("config4", {"config": 4, "N": N4, "iters": ITERS4, "dtype": "float32",
                     "device": smi, "backward": "plain torch (DDP terms)",
                     "robots": {r: v for r, v in config4.items()
                                if r not in ROBOTS4_SO}})
    line("path_a_sqp_humanoids", {
        "config": 4, "N": N4, "iters": ITERS4, "dtype": "float32",
        "device": smi, "backward": "plain torch (DDP terms)",
        "robots": {r: config4[r] for r in ROBOTS4_SO},
        "elapsed_s": elapsed()})

    cfg_q = dict(N=N, dt=DT, iters=ITERS)
    solve_q, parts_q = make_ilqr(m32, quad_cost(m32, QUAD3),
                                 ILQRConfig(**cfg_q), expose_parts=True)
    build.reset_counters()
    res_q = solve_q(x0, U0)
    torch.cuda.synchronize()
    path_runs.append(check_run(
        "config 3 QuadCost", res_q,
        {"rollout": 1, "fd_du": ITERS, "riccati": ITERS,
         "linesearch_rollout": ITERS}, N, B, ITERS, m32.n))
    agree_q = first64(make_ilqr, ILQRConfig, cfg_q, m32, QUAD3,
                      x0.double().cpu().numpy(), res_q.cost, f64_at=ITERS)
    ms_q = time_cuda(lambda: solve_q(x0, U0), iters=10, warmup=1)
    X = parts_q["rollout"](x0, U0)
    A, Bm = parts_q["linearize"](X[:N], U0)
    ks, Ks = parts_q["backward"](X, U0, A, Bm)
    phases_q = {
        "rollout_ms": time_cuda(lambda: parts_q["rollout"](x0, U0)),
        "linearize_ms": time_cuda(lambda: parts_q["linearize"](X[:N], U0)),
        "backward_ms": time_cuda(lambda: parts_q["backward"](X, U0, A, Bm)),
        "forward_ms": time_cuda(lambda: parts_q["forward"](X, U0, ks, Ks)),
    }
    del X, A, Bm, ks, Ks
    line("config3_quad", {"config": 3, "task": "QuadCost", "robot": "iiwa",
                          "N": N, "iters": ITERS, "B": B, "dtype": "float32",
                          "device": smi, "solve_ms": ms_q,
                          "quad_task_solves_per_s": B / (ms_q / 1e3),
                          "cost_first_mean": float(res_q.cost_trace[0].mean()),
                          "cost_last_mean": float(res_q.cost_trace[-1].mean()),
                          "first64_final_cost": agree_q,
                          "launches": path_runs[-1], "phases": phases_q})

    # -- phase 7: the generated per-robot modules --------------------------
    phase_start[7] = elapsed()
    gen = {}
    with tempfile.TemporaryDirectory() as tmp:
        # atlas: its fdsva_so on the composed route, as the JAX generated
        # module's fdsva_so_kernel() takes it above 16 joints
        grids["atlas"] = (GRiD("atlas", dtype=torch.float32, device=dev),)
        for robot in ("iiwa", "hyq", "atlas"):
            path = gen_all_code(load_robot(robot), f"grid_{robot}",
                                os.path.join(tmp, f"grid_{robot}.py"))
            spec = importlib.util.spec_from_file_location(f"grid_{robot}",
                                                          path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.configure(device=dev)           # float32, the card
            ref = grids[robot][0]
            rng = np.random.default_rng(2)
            x = [rng.uniform(-1, 1, (L1, ref.n)) for _ in range(3)]
            nargs = {a: len(args.split(", ")) for a, _, args in ALGORITHMS}
            want = {a: getattr(ref, a)(*x[:k]) for a, k in nargs.items()}
            torch.cuda.synchronize()
            build.reset_counters()
            errs = {}
            for algo, k in nargs.items():
                before = dict(build.LAUNCHES)
                got = getattr(mod, algo)(*x[:k])
                torch.cuda.synchronize()
                added = {c: v - before.get(c, 0)
                         for c, v in build.LAUNCHES.items()
                         if v != before.get(c, 0)}
                kernel = GEN_KERNELS[algo][0]
                expect = {kernel: 1}
                if kernel == "fdsva_so" and K.fdsva_so_route(
                        ref.n, torch.float32) == K.COMPOSED:
                    expect = {"fd_du": 1, "idsva_so": 1}
                if added != expect:
                    raise AssertionError(f"grid_{robot}.{algo} launched "
                                         f"{added}, expected {expect}")
                err = max_err((got,), (want[algo],))
                tol = 1e-6 * max(1.0, float(want[algo].abs().max()))
                if got.shape != want[algo].shape or not err <= tol:
                    raise AssertionError(f"grid_{robot}.{algo}: "
                                         f"{tuple(got.shape)}, max abs err "
                                         f"{err} vs GRiD (tol {tol})")
                errs[algo] = err
            if build.PLAIN_CALLS:
                raise AssertionError(f"grid_{robot} ran plain versions: "
                                     f"{dict(build.PLAIN_CALLS)}")
            path_runs.append(dict(build.LAUNCHES))
            print(f"grid_{robot}.single_timing_table(batch_size={L1}):",
                  flush=True)
            gen[robot] = {"max_abs_err_vs_grid": errs,
                          "launches": path_runs[-1],
                          "single_call_s": mod.single_timing_table(
                              batch_size=L1, iters=20)}
    jax_loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "gridcodegenerator_tpu"))
    if jax_loaded:
        raise AssertionError(f"JAX modules loaded: {jax_loaded}")
    line("codegen", {"robots": gen, "B": L1, "dtype": "float32",
                     "device": smi, "elapsed_s": elapsed()})

    # -- phase 8: config 5, scenario-tree MPC on one card ------------------
    phase_start[8] = elapsed()
    step5 = {"rollout": 1, "fd_du": ITERS5, "riccati": ITERS5,
             "linesearch_rollout": ITERS5}
    config5, grid5, ref5 = {}, {}, {}
    for robot in ROBOTS5:
        dt5 = DT5.get(robot, DT)
        m = build_model(load_robot(robot), dtype=torch.float32, device=dev)
        m64 = m.to(dtype=torch.float64)
        f64_of[id(m)] = m64
        n = m.n
        cost5 = quad_cost(m, QUAD5, qf=10.0)
        cfg5 = ScenarioMPCConfig(ILQRConfig(N=N5, dt=dt5, iters=ITERS5), S5)
        step = make_scenario_step(m, cost5, cfg5)
        x0n = SPREAD5 * np.random.default_rng(0).standard_normal((2 * n, S5))
        x0s = torch.as_tensor(x0n, dtype=torch.float32, device=dev)
        U0 = torch.zeros((N5, n, S5), dtype=torch.float32, device=dev)
        build.reset_counters()
        u0, U_next, costs = step(x0s, U0)
        torch.cuda.synchronize()
        # phase 12 holds its mesh steps against these
        ref5[robot] = {f: v.cpu().numpy() for f, v in (
            ("u0", u0), ("U_next", U_next), ("costs", costs))}
        runs = dict(build.LAUNCHES)
        if runs != step5 or build.PLAIN_CALLS:
            raise AssertionError(f"config 5 {robot} step launches {runs} "
                                 f"(expected {step5}), plain calls "
                                 f"{dict(build.PLAIN_CALLS)}")
        path_runs.append(runs)
        # the solve behind the step, for its cost trace and first controls:
        # the same kernels on the same inputs give the same bits
        res = make_ilqr(m, cost5, cfg5.ilqr)(x0s, U0)
        tr = res.cost_trace
        if not (torch.equal(res.cost, costs) and torch.equal(
                U_next, torch.cat([res.U[1:], res.U[-1:]]))):
            raise AssertionError(f"config 5 {robot}: the step's costs or "
                                 f"U_next are not its solve's, shifted")
        if not bool(torch.isfinite(tr).all()):
            raise AssertionError(f"config 5 {robot}: non-finite cost")
        if not bool((tr[1:] <= tr[:-1]).all()):
            raise AssertionError(f"config 5 {robot}: cost increased")
        lo, hi = res.U[0].amin(dim=1), res.U[0].amax(dim=1)
        slack = 1e-6 * max(1.0, float(res.U[0].abs().max()))
        if not (bool(torch.isfinite(u0).all()) and u0.shape == (n,)
                and bool((u0 >= lo - slack).all())
                and bool((u0 <= hi + slack).all())):
            raise AssertionError(f"config 5 {robot}: consensus u0 {u0} "
                                 f"outside the scenarios' first controls")
        ms5 = time_cuda(lambda: step(x0s, U0), iters=5, warmup=1)

        # the step's kernels at its shapes (float32 rule, times, bounds), on
        # the inputs its first iteration makes; aba at the closed loop's one
        # lane
        _, parts5 = make_ilqr(m, cost5, cfg5.ilqr, expose_parts=True)
        X = parts5["rollout"](x0s, U0)
        fold = lambda Z: Z.transpose(0, 1).reshape(Z.shape[1], -1)
        A, Bm = parts5["linearize"](X[:N5], U0)
        _, Vx0, Vxx0 = cost5.terminal_expansion(X[N5])
        _, lx, lu, lxx, luu, lux = cost5.stage_expansion(fold(X[:N5]),
                                                         fold(U0), 0)
        unfold = lambda z: z.reshape(z.shape[:-1] + (N5, S5)).movedim(-2, 0)
        ric = (A, Bm, unfold(lx).contiguous(), unfold(lu).contiguous(),
               *(c[..., :S5].contiguous() for c in (lxx, luu, lux)),
               Vx0.contiguous(), Vxx0.contiguous(), cfg5.ilqr.reg)
        ks, Ks = S.riccati(*ric)
        blo, bhi = resolve_control_bounds(m, cfg5.ilqr)
        al = torch.tensor(cfg5.ilqr.alphas, dtype=torch.float32,
                          device=dev)[:, None].repeat(1, S5)
        q1 = torch.zeros((n, 1), dtype=torch.float32, device=dev)
        cases5 = {
            "rollout": (m, x0s, U0, dt5, GRAVITY, blo, bhi),
            "fd_du": (m, fold(X[:N5, :n]), fold(X[:N5, n:]), fold(U0),
                      GRAVITY),
            "riccati": ric,
            "linesearch_quad": (m, X[0].contiguous(), U0,
                                X[:N5].contiguous(), ks, Ks, al, dt5,
                                GRAVITY, blo, bhi, cost5),
            "aba": (m, q1, q1, u0[:, None].contiguous(), GRAVITY)}
        build.reset_counters()
        kern5 = {}
        for case, args in cases5.items():
            name = kernel_of.get(case, case)
            kern5[name] = timed_f32(f"config 5 {robot} {case}", *fns_of[case],
                                    args, m, case, 10) | {
                "launches_per_step": step5.get(name, 0)}
        del X, A, Bm, ric, ks, Ks, cases5, parts5
        # the GRiD kernels at L1 lanes on this instance
        cases = lane_cases(m, L1, seed=0)
        cases["d2eepos"] = cases["eepos"]
        grid5[robot] = {
            case: timed_f32(f"{robot} {case} L={L1}", *fns_of[case], args,
                            m, case, 10)
            for case, args in cases.items() if case in all_kernels}
        del cases
        torch.cuda.empty_cache()

        # three closed-loop periods: a scenario step each, then the
        # consensus control through dynamics_step (one aba launch)
        build.reset_counters()
        xs, us = closed_loop(m, cost5, cfg5, torch.zeros(
            2 * n, dtype=torch.float32, device=dev), PERIODS5,
            torch.Generator(device=dev).manual_seed(0), SPREAD5)
        torch.cuda.synchronize()
        runs = dict(build.LAUNCHES)
        want = {k: PERIODS5 * v for k, v in step5.items()} | {
            "aba": PERIODS5}
        if runs != want or build.PLAIN_CALLS:
            raise AssertionError(f"config 5 {robot} closed loop launches "
                                 f"{runs} (expected {want}), plain calls "
                                 f"{dict(build.PLAIN_CALLS)}")
        path_runs.append(runs)
        ref5[robot]["xs"] = xs.cpu().numpy()
        if xs.shape != (PERIODS5 + 1, 2 * n) or not bool(
                torch.isfinite(xs).all()):
            raise AssertionError(f"config 5 {robot} closed loop: states "
                                 f"{tuple(xs.shape)}, finite "
                                 f"{bool(torch.isfinite(xs).all())}")

        # float64 on the first S5_F64 scenarios: the kernel step against the
        # plain step, costs by phase 6's QuadCost rule at the last iteration,
        # and the consensus u0, U_next and every scenario's cost within
        # U0_REL of their scale
        cost64 = to64(cost5)
        x64 = torch.as_tensor(x0n[:, :S5_F64], dtype=torch.float64,
                              device=dev)
        U64 = torch.zeros((N5, n, S5_F64), dtype=torch.float64, device=dev)
        f64 = {}
        for uk in (None, False):
            icfg = ILQRConfig(N=N5, dt=dt5, iters=ITERS5, use_kernels=uk)
            f64[uk] = (make_scenario_step(m64, cost64, ScenarioMPCConfig(
                icfg, S5_F64))(x64, U64), make_ilqr(m64, cost64, icfg)(
                    x64, U64).cost_trace.double().cpu())
        (u0_k, Un_k, c_k), t_k = f64[None]
        (u0_p, Un_p, c_p), t_p = f64[False]
        r_at = rel(t_k[-1], t_p[-1])
        at = float((r_at <= F64_REL).double().mean())
        f64_err = {}
        for what, k_, p_ in (("u0", u0_k, u0_p), ("U_next", Un_k, Un_p),
                             ("costs", c_k, c_p)):
            err = float((k_ - p_).abs().max())
            tol = U0_REL * max(1.0, float(p_.abs().max()))
            f64_err[what] = {"max_abs_err": err, "tol": tol}
            if not err <= tol:
                raise AssertionError(f"config 5 {robot} float64: {what} off "
                                     f"by {err} (tol {tol})")
        if not at >= F64_SHARE:
            raise AssertionError(f"config 5 {robot} float64: costs within "
                                 f"rel {F64_REL} on {at}")
        config5[robot] = {
            "joints": n, "dt": dt5, "S": S5, "N": N5, "iters": ITERS5,
            "dtype": "float32", "device": smi, "step_ms": ms5,
            "scenario_solves_per_s": S5 / (ms5 / 1e3),
            "launches": path_runs[-2], "closed_loop_launches": runs,
            "cost_first_mean": float(tr[0].mean()),
            "cost_last_mean": float(tr[-1].mean()),
            "u0": u0.tolist(), "closed_loop_final_state_max": float(
                xs[-1].abs().max()),
            "f64_first64": {"costs_within_rel": F64_REL, "share": at,
                            "max_rel": float(r_at.max()), **f64_err},
            "kernels": kern5}
        del x0s, U0, res, step, f64
        torch.cuda.empty_cache()
    line("config5", {"config": 5, "robots": config5})
    line("grid_kernels_f32_17_28", {"L": L1, "robots": grid5,
                                    "elapsed_s": elapsed()})
    for name in ("fd_du", "riccati", "linesearch_rollout", "rollout", "aba"):
        results[name]["config5"] = {
            robot: {k: v["kernels"][name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "launches_per_step")} for robot, v in config5.items()}

    # -- phase 9: the per-knot cost route ----------------------------------
    phase_start[9] = elapsed()
    class RampTracking(CostModel):
        """A user cost of the knot index t, neither stationary nor
        time-invariant: 0.5 s_t (x - x_ref[t])^T Q (x - x_ref[t])
        + 0.5 u^T R u with s_t = (t + 1) / N and x_ref[t] = s_t x_goal;
        terminal 0.5 (x - x_ref[N])^T Qf (x - x_ref[N]). Q 0.1, R 1e-3,
        Qf 100, x_goal config 3's QuadCost task's."""

        def __init__(self, model, n_knots):
            n, kw = model.n, dict(dtype=model.dtype, device=model.device)
            self.Q = torch.full((2 * n,), 0.1, **kw)
            self.R = torch.full((n,), 1e-3, **kw)
            self.Qf = torch.full((2 * n,), 100.0, **kw)
            self.xg = torch.zeros(2 * n, **kw)
            for i, v in QUAD3.items():
                self.xg[i] = v
            self.n_knots = n_knots

        def _dx(self, x, t):
            s = (t + 1) / self.n_knots
            return s, x - s * self.xg[:, None]

        def stage(self, x, u, t):
            s, dx = self._dx(x, t)
            return (0.5 * s * (self.Q[:, None] * dx * dx).sum(0)
                    + 0.5 * (self.R[:, None] * u * u).sum(0))

        def terminal(self, x):
            _, dx = self._dx(x, self.n_knots)
            return 0.5 * (self.Qf[:, None] * dx * dx).sum(0)

        @staticmethod
        def _diag(w, like):
            return torch.diag(w)[:, :, None].expand(w.shape[0], w.shape[0],
                                                    like.shape[-1])

        def stage_expansion(self, x, u, t):
            s, dx = self._dx(x, t)
            lux = torch.zeros((), dtype=x.dtype, device=x.device).expand(
                u.shape[0], x.shape[0], x.shape[-1])
            return (self.stage(x, u, t), s * self.Q[:, None] * dx,
                    self.R[:, None] * u, self._diag(s * self.Q, x),
                    self._diag(self.R, x), lux)

        def terminal_expansion(self, x):
            _, dx = self._dx(x, self.n_knots)
            return (self.terminal(x), self.Qf[:, None] * dx,
                    self._diag(self.Qf, x))

    def per_knot_run(tag, make, cfg_cls, cfg_kw, cost_of, x0n, expect,
                     f64_at):
        """One float32 solve on the kernels (launches as ``expect``,
        nothing plain), its first 64 problems held by phase 6's rule,
        solves/s over 5 solves and each phase's ms."""
        n = m32.n
        cost = cost_of(m32)
        solve_, parts_ = make(m32, cost, cfg_cls(**cfg_kw), expose_parts=True)
        x = torch.as_tensor(x0n, dtype=torch.float32, device=dev)
        U = torch.zeros((cfg_kw["N"], n, x.shape[-1]), dtype=torch.float32,
                        device=dev)
        build.reset_counters()
        res_ = solve_(x, U)
        torch.cuda.synchronize()
        path_runs.append(check_run(tag, res_, expect, cfg_kw["N"],
                                   x.shape[-1], cfg_kw["iters"], n))
        agree_ = first64(make, cfg_cls, cfg_kw, m32, None, x0n, res_.cost,
                         f64_at, cost_of=lambda m: cost_of(m, 64))
        ms_ = time_cuda(lambda: solve_(x, U), iters=5, warmup=1)
        X_ = parts_["rollout"](x, U)
        A_, Bm_ = parts_["linearize"](X_[:cfg_kw["N"]], U)
        so_ = (parts_["second_order"](X_, U)
               if cfg_cls(**cfg_kw).use_second_order else None)
        ks_, Ks_ = parts_["backward"](X_, U, A_, Bm_, so_)
        phases_ = {
            "rollout_ms": time_cuda(lambda: parts_["rollout"](x, U), iters=5),
            "linearize_ms": time_cuda(
                lambda: parts_["linearize"](X_[:cfg_kw["N"]], U), iters=5),
            "backward_ms": time_cuda(
                lambda: parts_["backward"](X_, U, A_, Bm_, so_), iters=5),
            "forward_ms": time_cuda(
                lambda: parts_["forward"](X_, U, ks_, Ks_), iters=5)}
        if so_ is not None:
            phases_["fdsva_so_ms"] = time_cuda(
                lambda: parts_["second_order"](X_, U), iters=5)
        out = {"N": cfg_kw["N"], "iters": cfg_kw["iters"],
               "B": x.shape[-1], "alphas": len(cfg_kw.get(
                   "alphas", ILQRConfig.alphas)),
               "dtype": "float32", "device": smi, "solve_ms": ms_,
               "solves_per_s": x.shape[-1] / (ms_ / 1e3),
               "cost_first_mean": float(res_.cost_trace[0].mean()),
               "cost_last_mean": float(res_.cost_trace[-1].mean()),
               "first64_final_cost": agree_, "launches": path_runs[-1],
               "phases": phases_}
        return out, (cost, X_, U, A_, Bm_, ks_, Ks_)

    rng9 = np.random.default_rng(0)
    x0n9 = rng9.uniform(-0.2, 0.2, (2 * m32.n, B))
    # a tracking cost of the knot index at config 3's shapes: the per-knot
    # expansions, the stacked riccati and the no-cost line search, the cost
    # summed knot by knot over the six step sizes' rollouts
    cfg_t = dict(N=N, dt=DT, iters=ITERS)
    tracking, (cost_t, X9, U9, A9, Bm9, ks9, Ks9) = per_knot_run(
        "per-knot tracking", make_ilqr, ILQRConfig, cfg_t,
        lambda m, b=None: RampTracking(m, N), x0n9,
        {"rollout": 1, "fd_du": ITERS, "riccati": ITERS,
         "linesearch_nocost": ITERS}, ITERS)
    line("per_knot_tracking", tracking | {"robot": "iiwa", "cost":
                                          "RampTracking (t-varying)"})
    # the stacked riccati at these shapes, and the no-cost line search at
    # one step size (the per-problem task's shape), FB_ALPHA: at alpha = 1
    # the first iteration's closed loop is unstable and float32 overflows
    # (phase 3 holds the six rows per row)
    _, Vx0, Vxx0 = cost_t.terminal_expansion(X9[N])
    exps = [cost_t.stage_expansion(X9[t], U9[t], t) for t in range(N)]
    ric_st = (A9, Bm9, torch.stack([e[1] for e in exps]),
              torch.stack([e[2] for e in exps]),
              *(torch.stack([e[k] for e in exps]).contiguous()
                for k in (3, 4, 5)), Vx0.contiguous(), Vxx0.contiguous(),
              ILQRConfig.reg)
    del exps
    blo, bhi = resolve_control_bounds(m32, ILQRConfig(**cfg_t))
    al9 = torch.tensor(ILQRConfig.alphas, dtype=torch.float32,
                       device=dev)[:, None].repeat(1, B)
    ls_nc = (m32, X9[0].contiguous(), U9, X9[:N].contiguous(), ks9, Ks9,
             al9, DT, GRAVITY, blo, bhi, None)
    per_knot_k = {
        f"riccati_stacked N={N} B={B}": timed_f32(
            "riccati stacked", S.riccati, S.riccati_plain, ric_st, m32,
            "riccati_stacked", 10),
        f"linesearch_nocost N={N} 1x{B}": timed_f32(
            "linesearch_nocost one step size", S.linesearch_rollout,
            S.linesearch_rollout_plain,
            ls_nc[:6] + (torch.full_like(al9[:1], FB_ALPHA),) + ls_nc[7:],
            m32, "linesearch_nocost", 10)}
    del ric_st, ls_nc, X9, U9, A9, Bm9, ks9, Ks9
    torch.cuda.empty_cache()

    # config 3's EE reach task with a goal per problem, at one step size
    # (the case the JAX solver runs): eepos and deepos once a knot in each
    # backward and terminal expansion, eepos once a knot in each total cost
    qg = torch.as_tensor(0.5 + np.random.default_rng(1).uniform(
        -0.1, 0.1, (m32.n, B)), dtype=torch.float32, device=dev)
    goals9 = eepose.eepos(m32_64, qg.double())[:3]

    def ee_per_problem(m, b=B):
        return EEReachCost(model=m, goal_xyz=goals9[:, :b].to(m.dtype),
                           w_pos=0.5, w_pos_f=200.0)
    cfg_p = dict(N=N, dt=DT, iters=ITERS, alphas=(1.0,))
    per_problem, _ = per_knot_run(
        "per-problem EE goals", make_ilqr, ILQRConfig, cfg_p, ee_per_problem,
        x0n9, {"rollout": 1, "fd_du": ITERS, "riccati": ITERS,
               "linesearch_nocost": ITERS,
               "eepos": (N + 1) * (1 + 2 * ITERS),
               "deepos": (N + 1) * ITERS}, ITERS)
    line("per_problem_ee", per_problem | {
        "robot": "iiwa", "goal": "eepos(q = 0.5 + U(-0.1, 0.1)), seed 1",
        "launches_derived": "eepos (N+1)(1+2I), deepos (N+1)I"})

    # SQP on config 3's EE reach task (shared goal, its weights) at config
    # 4's shapes: the DDP backward on the EE cost's dense Gauss-Newton
    # expansion, one folded call a sweep; the EE line search
    goal3 = eepose.eepos(m32_64, torch.full((m32.n, 1), 0.5,
                                            dtype=torch.float64,
                                            device=dev))[:3, 0]

    def ee_shared(m, b=None):
        return EEReachCost(model=m, goal_xyz=goal3.to(m.dtype), w_pos=0.5,
                           w_pos_f=200.0)
    b4 = B4["iiwa"]
    sqp_ee, _ = per_knot_run(
        "SQP EE reach", make_sqp, SQPConfig, dict(N=N4, dt=DT, iters=ITERS4),
        ee_shared, np.random.default_rng(0).uniform(-0.2, 0.2,
                                                    (2 * m32.n, b4)),
        {"rollout": 1, "fd_du": ITERS4, "fdsva_so": ITERS4,
         "linesearch_rollout": ITERS4, "eepos": 2 + 2 * ITERS4,
         "deepos": 2 * ITERS4}, 1)
    line("sqp_ee_reach", sqp_ee | {"robot": "iiwa", "backward":
                                   "plain torch (DDP terms)"})
    line("per_knot_kernels", per_knot_k | {"elapsed_s": elapsed()})
    results["riccati"]["per_knot"] = per_knot_k[f"riccati_stacked N={N} B={B}"]
    results["linesearch_nocost"]["per_knot"] = per_knot_k[
        f"linesearch_nocost N={N} 1x{B}"]

    # -- phase 10: config 3 with parallel_riccati --------------------------
    phase_start[10] = elapsed()
    # phase 4's task and x0, the backward the associative suffix scan in
    # plain torch (trajopt/priccati.py): no Riccati kernel runs
    cfg10 = dict(N=N, dt=DT, iters=ITERS, parallel_riccati=True)
    n = m32.n
    U0 = torch.zeros((N, n, B), dtype=torch.float32, device=dev)
    solve10, parts10 = make_ilqr(m32, cost, ILQRConfig(**cfg10),
                                 expose_parts=True)
    build.reset_counters()
    res10 = solve10(x0, U0)
    torch.cuda.synchronize()
    path_runs.append(check_run(
        "parallel riccati", res10, {
            "rollout": 1, "fd_du": ITERS, "linesearch_rollout": ITERS,
            "eepos": 2 + 2 * ITERS, "deepos": 2 * ITERS}, N, B, ITERS, n))
    agree10 = first64(make_ilqr, ILQRConfig, cfg10, m32, None, x0n9,
                      res10.cost, ITERS, cost_of=lambda m: dataclasses.replace(
                          cost, model=m, goal_xyz=cost.goal_xyz.to(m.dtype)))
    ms10 = time_cuda(lambda: solve10(x0, U0), iters=5, warmup=1)
    X10 = parts10["rollout"](x0, U0)
    A10, Bm10 = parts10["linearize"](X10[:N], U0)
    ks10, Ks10 = parts10["backward"](X10, U0, A10, Bm10)
    _, parts4 = make_ilqr(m32, cost, ILQRConfig(N=N, dt=DT, iters=ITERS),
                          expose_parts=True)
    back = {}                   # the two backward phases in turns
    for tag in ("scan", "factored", "factored", "scan"):
        p_ = parts10 if tag == "scan" else parts4
        back.setdefault(tag, []).append(time_cuda(
            lambda: p_["backward"](X10, U0, A10, Bm10), iters=5))
    # the scan alone on this backward's inputs (the folded EE expansion,
    # unfolded to the knot stacks), and where its time goes: device time
    # by op (torch.profiler) against the host's wall time
    _, Vx10, Vxx10 = cost.terminal_expansion(X10[N])
    ex10 = [t.reshape(t.shape[:-1] + (N, B)).movedim(-2, 0)
            for t in cost.stage_expansion(
                X10[:N].transpose(0, 1).reshape(2 * n, -1),
                U0.transpose(0, 1).reshape(n, -1), 0)[1:]]
    scan_args = (A10, Bm10, *ex10, Vx10, Vxx10)
    scan_ms = time_cuda(lambda: priccati.suffix_value_functions(*scan_args),
                        iters=5)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        priccati.suffix_value_functions(*scan_args)
        torch.cuda.synchronize()
        tw = time.perf_counter() - tw
    # the device's own rows (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    ops10 = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in ops10)
    del ex10, scan_args
    scan_rounds = []
    priccati.associative_scan(lambda a, b: [a[0] + b[0]],
                              [torch.zeros(N + 1)], scan_rounds)
    gap = rel(res10.cost.double().cpu(), c_k32)
    line("parallel_riccati", {
        "config": 3, "robot": "iiwa", "N": N, "iters": ITERS, "B": B,
        "dtype": "float32", "device": smi, "solve_ms": ms10,
        "solves_per_s": B / (ms10 / 1e3),
        "cost_first_mean": float(res10.cost_trace[0].mean()),
        "cost_last_mean": float(res10.cost_trace[-1].mean()),
        "first64_final_cost": agree10, "launches": path_runs[-1],
        "phases": {"rollout_ms": time_cuda(
            lambda: parts10["rollout"](x0, U0), iters=5),
            "linearize_ms": time_cuda(
                lambda: parts10["linearize"](X10[:N], U0), iters=5),
            "forward_ms": time_cuda(lambda: parts10["forward"](
                X10, U0, ks10, Ks10), iters=5)},
        "backward_ms_scan": back["scan"],
        "backward_ms_riccati_factored": back["factored"],
        "scan_alone_ms": scan_ms,
        "scan_profile": {"wall_ms": tw * 1e3, "device_ms": device_ms,
                         "device_busy_share": device_ms / (tw * 1e3),
                         "top_ops_device_ms_count": ops10[:6]},
        "scan_rounds": len(scan_rounds), "scan_pairs_per_round": scan_rounds,
        "final_cost_rel_gap_to_phase4": {
            "median": float(gap.median()), "max": float(gap.max()),
            "share_within_1e-3": share(gap)},
        "elapsed_s": elapsed()})
    del X10, A10, Bm10, ks10, Ks10, parts4, res10
    torch.cuda.empty_cache()

    # -- phase 11: the floating base -------------------------------------
    phase_start[11] = elapsed()
    # GRiD on *_floating robots: every first-order method on the plain
    # twins, on the card (the kernels are fixed-base)
    floating = {}
    for robot in ROBOTS_FLOATING:
        gf = {dt: GRiD(robot, dtype=dt, device=dev)
              for dt in (torch.float32, torch.float64)}
        g_cpu = GRiD(robot, dtype=torch.float64, device="cpu")
        g32, g64 = gf[torch.float32], gf[torch.float64]
        npos, nv = g32.num_pos, g32.num_vel
        rng = np.random.default_rng(0)
        qf = rng.uniform(-1, 1, (L1, npos))
        qf[:, 3:7] = rng.standard_normal((L1, 4))     # unnormalized
        vf = tuple(rng.uniform(-1, 1, (L1, nv)) for _ in range(3))
        shapes = {"B1": (qf[0],) + tuple(v[0] for v in vf),
                  f"B{L1}": (qf,) + vf}
        cases = {}              # label -> (method, inputs, plain twin)
        for bl, (q_, qd_, qdd_, u_) in shapes.items():
            for method, twin, args in FLOATING_METHODS:
                x = {"q": q_, "qd": qd_, "qdd": qdd_, "u": u_}
                ins_ = [x[a] for a in args]
                if method.endswith("_packed"):
                    ins_ = [np.concatenate(ins_, axis=-1)]
                cases[f"{method}_{bl}"] = (method, ins_, twin)

        def call(g_, method, ins_):
            if method == "minv_upper":
                return g_.minv(*ins_, dense=False)
            return getattr(g_, method.replace("_nqdd", ""))(*ins_)
        errs, rates = {}, {}
        for label, (method, ins_, twin) in cases.items():
            build.reset_counters()
            out = call(g32, method, ins_)
            torch.cuda.synchronize()
            if build.LAUNCHES or dict(build.PLAIN_CALLS) != (
                    {twin: 1} if twin else {}):
                raise AssertionError(
                    f"{robot} GRiD.{method}: launches "
                    f"{dict(build.LAUNCHES)}, plain calls "
                    f"{dict(build.PLAIN_CALLS)} (expected {twin} once)")
            ref64_ = call(g64, method, ins_)
            if out.device.type != dev.type or out.shape != ref64_.shape:
                raise AssertionError(f"{robot} {label}: {out.shape}")
            # the float32 rule, where the plain twin is what ran: finite
            # values of the float64 run's shape; the error is recorded
            errs[label], _ = check_f32(f"{robot} {label}", out, out, ref64_)
            iters_ = 2 if method == "d2eepos" else 3
            ms_ = time_cuda(lambda: call(g32, method, ins_), iters=iters_)
            rates[label] = ({"us_per_call": ms_ * 1e3} if label.endswith(
                "_B1") else {"ms_per_call": ms_, "evals_per_s": L1 / (
                    ms_ / 1e3)})
        # float64: the card's plain twins against the CPU's on 3 lanes
        lanes3 = (qf[:3],) + tuple(v[:3] for v in vf)
        card_vs_cpu = {}
        for method, _, args in FLOATING_METHODS:
            x = dict(zip(("q", "qd", "qdd", "u"), lanes3))
            ins_ = [x[a] for a in args]
            if method.endswith("_packed"):
                ins_ = [np.concatenate(ins_, axis=-1)]
            got = call(g64, method, ins_).cpu()
            want = call(g_cpu, method, ins_)
            err = float((got - want).abs().max())
            tol = 1e-10 * max(1.0, float(want.abs().max()))
            if not err <= tol:
                raise AssertionError(f"{robot} {method} float64 card vs CPU: "
                                     f"{err} > {tol}")
            card_vs_cpu[method] = err / tol
        # the physical checks (JAX tests/test_floating_base.py) in float64
        # on the card, the quaternion normalized
        qn = qf[:64].copy()
        qn[:, 3:7] /= np.linalg.norm(qn[:, 3:7], axis=1, keepdims=True)
        qd_, qdd_ = vf[0][:64], vf[1][:64]
        c, c0 = g64.id(qn, qd_, qdd_), g64.id(qn, qd_)
        M, Mi = g64.crba(qn), g64.minv(qn)
        qdd_t = torch.as_tensor(qdd_, device=dev)
        eye = torch.eye(nv, dtype=torch.float64, device=dev)
        phys = {
            "M_Minv_minus_I": float((M @ Mi - eye).abs().max()),
            "id_minus_id0_minus_M_qdd": float(
                (c - c0 - torch.einsum("bij,bj->bi", M, qdd_t)).abs().max()
                / max(1.0, float(c.abs().max()))),
            "fd_of_id_minus_qdd": float(
                (g64.fd(qn, qd_, c) - qdd_t).abs().max()),
            "aba_of_id_minus_qdd": float(
                (g64.aba(qn, qd_, c) - qdd_t).abs().max())}
        if not all(v <= 1e-9 for v in phys.values()):
            raise AssertionError(f"{robot} physical checks: {phys}")
        refused = []
        for what, fn in (
                ("idsva_so", lambda: g32.idsva_so(qf[:2], vf[0][:2],
                                                  vf[1][:2])),
                ("fdsva_so", lambda: g32.fdsva_so(qf[:2], vf[0][:2],
                                                  vf[1][:2])),
                ("use_kernels=True", lambda: GRiD(robot, device=dev,
                                                  use_kernels=True))):
            try:
                fn()
            except NotImplementedError:
                refused.append(what)
        if len(refused) != 3:
            raise AssertionError(f"{robot}: only {refused} refused")
        floating[robot] = {"num_pos": npos, "num_vel": nv,
                           "f32_max_abs_err_vs_f64": errs,
                           "f64_card_vs_cpu_err_over_tol": card_vs_cpu,
                           "f64_physical_checks": phys, "refused": refused,
                           "times": rates}
    # the generated module of atlas_floating: imported with nothing of JAX
    # loaded, its algorithms on the plain twins agree with GRiD, its timing
    # table runs
    with tempfile.TemporaryDirectory() as tmp:
        robot = ROBOTS_FLOATING[-1]
        path = gen_all_code(load_robot(robot), "grid_floating",
                            os.path.join(tmp, "grid_floating.py"))
        spec = importlib.util.spec_from_file_location("grid_floating", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.configure(device=dev)
        gref = GRiD(robot, dtype=torch.float32, device=dev)
        rng = np.random.default_rng(2)
        x = [rng.uniform(-1, 1, (L1, d)) for d in (gref.num_pos,
                                                   gref.num_vel,
                                                   gref.num_vel)]
        gen_errs = {}
        for algo, k in mod._TIMING_SET:
            build.reset_counters()
            got = getattr(mod, algo)(*x[:k])
            want = getattr(gref, algo)(*x[:k])
            torch.cuda.synchronize()
            if build.LAUNCHES or sum(build.PLAIN_CALLS.values()) != 2:
                raise AssertionError(f"grid_floating.{algo}: launches "
                                     f"{dict(build.LAUNCHES)}, plain "
                                     f"{dict(build.PLAIN_CALLS)}")
            gen_errs[algo] = max_err((got,), (want,))
            if not gen_errs[algo] == 0.0:
                raise AssertionError(f"grid_floating.{algo} differs from "
                                     f"GRiD: {gen_errs[algo]}")
        print(f"grid_floating ({robot}).single_timing_table"
              f"(batch_size={L1}):", flush=True)
        gen_floating = {"robot": robot, "max_abs_err_vs_grid": gen_errs,
                        "timed": [a for a, _ in mod._TIMING_SET],
                        "single_call_s": mod.single_timing_table(
                            batch_size=L1, iters=3)}
    jax_loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "gridcodegenerator_tpu"))
    if jax_loaded:
        raise AssertionError(f"JAX modules loaded: {jax_loaded}")
    line("floating_base", {"robots": floating, "codegen": gen_floating,
                           "B": L1, "dtype": "float32", "device": smi,
                           "elapsed_s": elapsed()})

    # -- phase 12: config 5 on a mesh ---------------------------------------
    phase_start[12] = elapsed()
    # the float32 rule's reference: phase 8's one-card step in float64 on
    # the same (float32-rounded) scenario states and robot constants
    plan12 = {"device": str(dev), "S": S5, "timed": True,
              "robots": {r: DT5.get(r, DT) for r in ROBOTS5}}
    ref64_5 = {}
    for robot, dt5 in plan12["robots"].items():
        m = build_model(load_robot(robot), dtype=torch.float32, device=dev)
        m64_ = m.to(dtype=torch.float64)
        _, x0s = config5_inputs(m.n, S5, dev)
        step64 = make_scenario_step(m64_, to64(config5_cost(m)),
                                    ScenarioMPCConfig(ILQRConfig(
                                        N=N5, dt=dt5, iters=ITERS5), S5))
        ref64_5[robot] = {f: v.cpu().numpy() for f, v in zip(
            ("u0", "U_next", "costs"), step64(x0s.double(), torch.zeros(
                (N5, m.n, S5), dtype=torch.float64, device=dev)))}
        ref64_5[robot]["xs"] = config5_closed_loop64(m, dt5, S5).cpu().numpy()
        del step64, x0s
    torch.cuda.empty_cache()
    mesh5, runs12 = phase12(plan12, ref5, ref64_5, check_f32)
    path_runs += runs12
    seen = {"device": smi, "note": MESH_NOTE}
    line("config5_mesh", mesh5 | {"elapsed_s": elapsed()})
    line("mesh_step", seen | {
        robot: {k: v[k] for k in MESH_STEP} for robot, v in
        mesh5["robots"].items()} | {"nccl_one_rank_step_ms": {
            robot: v["step_ms"] for robot, v in mesh5[
                "nccl_one_rank"].items()}})
    line("mesh_kp_backward", seen | {robot: {
        "kp_backward_ms": v["kp_backward_ms"],
        "rank_kp_backward_ms": v["rank_kp_backward_ms"],
        "fd_du_lanes": v["fd_du_lanes"]["hybrid"],
        "phase8_riccati_ms": config5[robot]["kernels"]["riccati"]["ms"],
        "phase8_fd_du_ms": config5[robot]["kernels"]["fd_du"]["ms"]}
        for robot, v in mesh5["robots"].items()})
    line("mesh_staged_bytes", seen | {
        robot: {kind: {"per_rank": v["staged_bytes_per_step"][kind],
                       "all_ranks": sum(sum(b.values()) for b in v[
                           "staged_bytes_per_step"][kind]),
                       "host_s_per_rank": v["staged_s_per_step"][kind]}
                for kind in MESH_STEP} for robot, v in
        mesh5["robots"].items()})

    # -- phase 13: above 28 joints: atlas with hands -------------------------
    phase_start[13] = elapsed()
    t = time.perf_counter()
    build.lib(nj13)
    lib13 = {"seconds": round(time.perf_counter() - t, 3),
             "nvcc_seconds": round(build.NVCC_SECONDS[nj13], 3)}
    dtypes = (torch.float32, torch.float64)
    plans13 = {f"{what} {str(dt)[6:]}": build.warp_kernel_info(what, nj13, dt)
               for what in build.WARP_KERNELS
               if what not in ("idsva_so", "fdsva_so") for dt in dtypes}
    # the instances on the device-memory route: a knot a block, its state
    # in a workspace the wrapper allocates (minv and fd in float64; the
    # others keep theirs in shared memory or on chip)
    ws13 = sorted(k for k, v in plans13.items() if v["workspace_bytes"])
    want_ws = ["fd float64", "minv float64"]
    for k, v in plans13.items():
        if v["knots_per_block"] < 1 and not v["workspace_bytes"]:
            raise AssertionError(f"{k} at {nj13} joints: no plan")
    if ws13 != sorted(want_ws):
        raise AssertionError(f"device-memory instances at {nj13} joints: "
                             f"{ws13}")
    # fd_du, id_du and the Riccati sweeps on chip at 34, 52 and 64 joints: a
    # knot or problem a block or a cluster (csrc/warp.cuh: ChipPack), no
    # workspace
    onchip13 = {f"{what} {str(dt)[6:]} nj{nj}": build.warp_kernel_info(
        what, nj, dt) for what in ONCHIP13 for nj in (nj34, nj13, nj64)
        for dt in dtypes}
    for k, v in onchip13.items():
        if (v["workspace_bytes"] or v["knots_per_block"] != 1
                or not 1 <= v["cluster_blocks"] <= 4
                or v["smem_bytes_per_block"] > 232448):
            raise AssertionError(f"{k}: not on chip: {v}")
    line("hands52_build", {"robot": topo13.name, "joints": nj13} | lib13 | {
        "device_memory_instances": ws13, "plans": {
            k: {f: v[f] for f in ("knots_per_block", "threads_per_knot",
                                  "smem_bytes_per_block", "workspace_bytes",
                                  "registers", "local_bytes", "blocks_per_sm",
                                  "cluster_blocks")}
            for k, v in plans13.items()}, "onchip_plans": {
            k: {f: v[f] for f in ("cluster_blocks", "threads_per_knot",
                                  "smem_bytes_per_block", "registers",
                                  "local_bytes", "blocks_per_sm")}
            for k, v in onchip13.items()}, "elapsed_s": elapsed()})

    # float64: each kernel but the second-order pair against its plain
    # version at 1 lane and 37 (a ragged block), one launch a call, within
    # 1e-9 of each output's scale; then the dynamics kernels against the
    # oracle on ORACLE_LANES lanes
    def held64(tag, cases, f64_cases):
        for case, args in cases.items():
            name = kernel_of.get(case, case)
            kern, plain = fns_of[case]
            what = f"{tag} {case}"
            build.reset_counters()
            out = as_tuple(kern(*args))
            torch.cuda.synchronize()
            if dict(build.LAUNCHES) != {name: 1} or build.PLAIN_CALLS:
                raise AssertionError(f"{what}: launches "
                                     f"{dict(build.LAUNCHES)}, plain calls "
                                     f"{dict(build.PLAIN_CALLS)}")
            ref = as_tuple(plain(*args))
            if len(out) != len(ref) or any(o.shape != r.shape
                                           for o, r in zip(out, ref)):
                raise AssertionError(f"{what}: kernel and plain outputs "
                                     f"differ in number or shape")
            err = max_err(out, ref)
            tol = 1e-9 * max(1.0, max(float(r.abs().max()) for r in ref))
            if not err <= tol:
                raise AssertionError(f"{what} float64: max abs err {err} > "
                                     f"{tol}")
            f64_cases[case] = {"max_abs_err": err, "tol": tol}

    m13 = build_model(topo13, dtype=torch.float64, device=dev)
    f64_13 = {}
    for lanes in (1, 37):
        quad = quad_inputs(m13, 8, lanes, seed=13, dt=DT13)
        quad["rollout_bounded"] = quad.pop("rollout")
        q = torch.as_tensor(np.random.default_rng(13).uniform(
            -1, 1, (nj13, lanes)), dtype=torch.float64, device=dev)
        cases = (path_inputs(m13, 8, lanes, seed=13, dt=DT13) | quad
                 | lane_cases(m13, lanes, seed=13, with_fd_du=True)
                 | {"d2eepos": (m13, q)})
        held = {}
        held64(f"{topo13.name} L={lanes}", cases, held)
        f64_13 |= {f"{case} L={lanes}": v for case, v in held.items()}
        del cases, quad
    # the on-chip kernels at 34 and 64 joints too: riccati_factored and
    # id_du on 1 lane and 37 (a ragged block), fd_du and the dense riccati
    # on 37 (one lane: at 52); for the time limit, phase 13's plain versions
    # of config 5's kernels are timed once (they take seconds a call at 52
    # joints)
    def first_lane(case, args):
        """A case's inputs of its first lane or problem (riccati_factored's
        lx, lu, Jw in the knot-major lanes t B + b)."""
        if case == "id_du":
            return (args[0], *(a[:, :1].contiguous() for a in args[1:4]),
                    args[4])
        A, Bm, lx, lu, Jw, Vx0, Vxx0, *rest = args
        lanes = torch.arange(A.shape[0], device=dev) * A.shape[-1]
        return (A[..., :1].contiguous(), Bm[..., :1].contiguous(),
                lx[:, lanes].contiguous(), lu[:, lanes].contiguous(),
                Jw[..., lanes].contiguous(), Vx0[:, :1].contiguous(),
                Vxx0[..., :1].contiguous(), *rest)

    for topo in (topo34, topo64):
        mk = build_model(topo, dtype=torch.float64, device=dev)
        ins = quad_inputs(mk, 8, 37, seed=13, dt=DT13)
        grid_in = lane_cases(mk, 37, seed=13, with_fd_du=True)
        cases = {"fd_du": grid_in["fd_du"], "id_du": grid_in["id_du"],
                 "riccati_factored": path_inputs(
                     mk, 8, 37, seed=13, dt=DT13)["riccati_factored"],
                 "riccati": ins["riccati"],
                 "riccati_stacked": ins["riccati_stacked"]}
        for lanes, held_cases in ((37, cases), (1, {
                c: first_lane(c, cases[c])
                for c in ("id_du", "riccati_factored")})):
            held = {}
            held64(f"{topo.name} L={lanes}", held_cases, held)
            f64_13 |= {f"{topo.name} {case} L={lanes}": v
                       for case, v in held.items()}
        if topo is topo34:
            # more knots and problems than the card holds clusters: each
            # cluster takes two or three in turn, its state reused
            held = {}
            held64(f"{topo.name} L={STRIDE13}", {
                "id_du": lane_cases(mk, STRIDE13, seed=13)["id_du"],
                "riccati_factored": path_inputs(
                    mk, 2, STRIDE13, seed=13,
                    dt=DT13)["riccati_factored"]}, held)
            f64_13 |= {f"{topo.name} {case} L={STRIDE13}": v
                       for case, v in held.items()}
        del mk, ins, cases, grid_in
    covered = {kernel_of.get(c.split(" ")[0], c.split(" ")[0]) for c in f64_13}
    if not all_kernels - {"idsva_so", "fdsva_so"} <= covered:
        raise AssertionError(f"{topo13.name}: kernels not held "
                             f"{sorted(all_kernels - covered)}")
    cases = lane_cases(m13, ORACLE_LANES, seed=7, with_fd_du=True)
    lanes_np = [a.cpu().numpy() for a in cases["rnea"][1:4]]
    for case, orc in oracle_of.items():
        out = as_tuple(case_fns[case][0](*cases[case]))
        per_lane = [orc(topo13, *(a[:, b] for a in lanes_np))
                    for b in range(ORACLE_LANES)]
        ref = tuple(torch.as_tensor(np.stack([r[k] for r in per_lane], -1),
                                    device=dev) for k in range(len(out)))
        err = max_err(out, ref)
        tol = ORACLE_REL * max(1.0, max(float(r.abs().max()) for r in ref))
        if any(o.shape != r.shape for o, r in zip(out, ref)) or not err <= tol:
            raise AssertionError(f"{topo13.name} {case} float64 vs the "
                                 f"oracle: max abs err {err} > {tol}")
        f64_13[f"{case} vs oracle L={ORACLE_LANES}"] = {"max_abs_err": err,
                                                        "tol": tol}
    line("hands52_f64", {"N": 8, "dt": DT13, "cases": f64_13,
                         "elapsed_s": elapsed()})
    del m13, cases
    torch.cuda.empty_cache()

    # float32: the sweeps that config 5 does not run, at N = 8 on 37
    # problems, by the float32 rule (the plain versions, seconds a call
    # here, timed once: the time the striding holds above take)
    m = build_model(topo13, dtype=torch.float32, device=dev)
    f64_of[id(m)] = m.to(dtype=torch.float64)
    ins13 = path_inputs(m, 8, 37, seed=14, dt=DT13) | quad_inputs(
        m, 8, 37, seed=14, dt=DT13)
    f32_13 = {case: timed_f32(f"{topo13.name} {case} N=8", *fns_of[case],
                              ins13[case], m, kernel_of.get(case, case), 3,
                              plain_iters=1)
              for case in ("riccati_factored", "riccati_stacked",
                           "feedback_rollout", "linesearch_nocost")}
    line("hands52_f32_small", {"N": 8, "B": 37, "cases": f32_13})
    del ins13
    # the on-chip riccati_factored at config 3's N and B and id_du on
    # IDU13_LANES lanes (float32, inputs ~ U(-1, 1): A = I + dt U, B = dt U,
    # a rank-3 factor; q, qd, qdd), one launch a call, finite outputs: ms
    # beside the bound (the plain versions take seconds a call there)
    gen = torch.Generator(device=dev).manual_seed(13)
    rnd = lambda *sh: torch.rand(*sh, generator=gen, device=dev) * 2 - 1
    N13, B13 = RIC13_BIG
    nx13 = 2 * nj13
    eye13 = torch.eye(nx13, device=dev)[None, :, :, None]
    big13 = {"riccati_factored": (
        (eye13 + DT13 * rnd(N13, nx13, nx13, B13)).contiguous(),
        (DT13 * rnd(N13, nx13, nj13, B13)).contiguous(),
        rnd(nx13, N13 * B13), rnd(nj13, N13 * B13), rnd(3, nj13, N13 * B13),
        rnd(nx13, B13), (10 * eye13[0].expand(nx13, nx13, B13)).contiguous(),
        1e-6, 0.1, 1e-2), "id_du": (m, *(rnd(nj13, IDU13_LANES)
                                         for _ in range(3)), GRAVITY)}
    del eye13
    onchip_f32 = {}
    for name, args in big13.items():
        build.reset_counters()
        out = as_tuple(fns_of[name][0](*args))
        torch.cuda.synchronize()
        if (dict(build.LAUNCHES) != {name: 1} or build.PLAIN_CALLS
                or not all(bool(torch.isfinite(o).all()) for o in out)):
            raise AssertionError(f"{topo13.name} {name} float32 at its big "
                                 f"shape: launches {dict(build.LAUNCHES)}, "
                                 f"finite outputs required")
        onchip_f32[name] = {"ms": time_cuda(
            lambda: fns_of[name][0](*args), iters=3)} | {
            k: v for k, v in roofline(name, m, args, out).items()
            if k in ("bound_ms", "bound_by")} | {
            "plan": {f: v for f, v in build.warp_kernel_info(
                name, nj13, torch.float32).items()
                if f in ("cluster_blocks", "threads_per_knot",
                         "smem_bytes_per_block", "registers", "local_bytes",
                         "blocks_per_sm")}}
        del out
    onchip_f32["riccati_factored"] |= {"N": N13, "B": B13}
    onchip_f32["id_du"]["lanes"] = IDU13_LANES
    line("hands52_onchip_f32", onchip_f32 | {"device": smi,
                                             "elapsed_s": elapsed()})
    del big13
    torch.cuda.empty_cache()

    # config 5 on atlas_hands52
    n = m.n
    cost5 = config5_cost(m)
    cfg5 = ScenarioMPCConfig(ILQRConfig(N=N5, dt=DT13, iters=ITERS5), S5)
    step = make_scenario_step(m, cost5, cfg5)
    x0n, x0s = config5_inputs(n, S5, dev)
    U0 = torch.zeros((N5, n, S5), dtype=torch.float32, device=dev)
    build.reset_counters()
    u0, U_next, costs = step(x0s, U0)
    torch.cuda.synchronize()
    runs = dict(build.LAUNCHES)
    if runs != step5 or build.PLAIN_CALLS:
        raise AssertionError(f"config 5 {topo13.name} step launches {runs} "
                             f"(expected {step5}), plain calls "
                             f"{dict(build.PLAIN_CALLS)}")
    path_runs.append(runs)
    res = make_ilqr(m, cost5, cfg5.ilqr)(x0s, U0)
    tr = res.cost_trace
    if not (torch.equal(res.cost, costs) and torch.equal(
            U_next, torch.cat([res.U[1:], res.U[-1:]]))):
        raise AssertionError(f"config 5 {topo13.name}: the step's costs or "
                             f"U_next are not its solve's, shifted")
    if not bool(torch.isfinite(tr).all()):
        raise AssertionError(f"config 5 {topo13.name}: non-finite cost")
    if not bool((tr[1:] <= tr[:-1]).all()):
        raise AssertionError(f"config 5 {topo13.name}: cost increased")
    lo, hi = res.U[0].amin(dim=1), res.U[0].amax(dim=1)
    slack = 1e-6 * max(1.0, float(res.U[0].abs().max()))
    if not (bool(torch.isfinite(u0).all()) and u0.shape == (n,)
            and bool((u0 >= lo - slack).all())
            and bool((u0 <= hi + slack).all())):
        raise AssertionError(f"config 5 {topo13.name}: consensus u0 {u0} "
                             f"outside the scenarios' first controls")
    ms13 = time_cuda(lambda: step(x0s, U0), iters=2)
    del res

    # the step's kernels at its shapes, on the inputs its first iteration
    # makes; fd_du's float32 rule and plain time on its first L1 lanes (its
    # plain float64 version at 65536 lanes of 52 joints would take tens of
    # gigabytes); aba at the closed loop's one lane
    _, parts5 = make_ilqr(m, cost5, cfg5.ilqr, expose_parts=True)
    X = parts5["rollout"](x0s, U0)
    fold = lambda Z: Z.transpose(0, 1).reshape(Z.shape[1], -1)
    A, Bm = parts5["linearize"](X[:N5], U0)
    _, Vx0, Vxx0 = cost5.terminal_expansion(X[N5])
    _, lx, lu, lxx, luu, lux = cost5.stage_expansion(fold(X[:N5]), fold(U0), 0)
    unfold = lambda z: z.reshape(z.shape[:-1] + (N5, S5)).movedim(-2, 0)
    ric = (A, Bm, unfold(lx).contiguous(), unfold(lu).contiguous(),
           *(c[..., :S5].contiguous() for c in (lxx, luu, lux)),
           Vx0.contiguous(), Vxx0.contiguous(), cfg5.ilqr.reg)
    ks, Ks = S.riccati(*ric)
    blo, bhi = resolve_control_bounds(m, cfg5.ilqr)
    al = torch.tensor(cfg5.ilqr.alphas, dtype=torch.float32,
                      device=dev)[:, None].repeat(1, S5)
    q1 = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    fd_args = (m, fold(X[:N5, :n]), fold(X[:N5, n:]), fold(U0), GRAVITY)
    cases5 = {"rollout": (m, x0s, U0, DT13, GRAVITY, blo, bhi),
              "riccati": ric,
              "linesearch_quad": (m, X[0].contiguous(), U0,
                                  X[:N5].contiguous(), ks, Ks, al, DT13,
                                  GRAVITY, blo, bhi, cost5),
              "aba": (m, q1, q1, u0[:, None].contiguous(), GRAVITY)}
    build.reset_counters()
    kern13 = {}
    for case, args in cases5.items():
        name = kernel_of.get(case, case)
        kern13[name] = timed_f32(f"config 5 {topo13.name} {case}",
                                 *fns_of[case], args, m, case, 3, 1) | {
            "launches_per_step": step5.get(name, 0)}
    out = as_tuple(K.fd_du(*fd_args))
    head = (m, *(a[:, :L1].contiguous() for a in fd_args[1:4]), GRAVITY)
    ref, ref64 = as_tuple(K.fd_du_plain(*head)), as_tuple(
        K.fd_du_plain(*map(to64, head)))
    ek = max(check_f32(f"config 5 {topo13.name} fd_du output {k}",
                       o[..., :L1], r, r64)[0]
             for k, (o, r, r64) in enumerate(zip(out, ref, ref64)))
    kern13["fd_du"] = {"kernel_err_vs_f64_first_lanes": ek,
                       "max_abs_err": max_err([o[..., :L1] for o in out],
                                              ref),
                       "ms": time_cuda(lambda: K.fd_du(*fd_args), iters=3),
                       "plain_ms": time_cuda(lambda: K.fd_du_plain(*head),
                                             iters=1, warmup=0),
                       "plain_lanes": L1, "launches_per_step": ITERS5} | \
        roofline("fd_du", m, fd_args, out)
    del X, A, Bm, ric, ks, Ks, cases5, parts5, out, ref, ref64, fd_args, head
    torch.cuda.empty_cache()

    # PERIODS13 closed-loop periods: a scenario step each, then the
    # consensus control through dynamics_step (one aba launch)
    build.reset_counters()
    xs, us13 = closed_loop(m, cost5, cfg5, torch.zeros(
        2 * n, dtype=torch.float32, device=dev), PERIODS13,
        torch.Generator(device=dev).manual_seed(0), SPREAD5)
    torch.cuda.synchronize()
    runs = dict(build.LAUNCHES)
    want = {k: PERIODS13 * v for k, v in step5.items()} | {"aba": PERIODS13}
    if runs != want or build.PLAIN_CALLS:
        raise AssertionError(f"config 5 {topo13.name} closed loop launches "
                             f"{runs} (expected {want}), plain calls "
                             f"{dict(build.PLAIN_CALLS)}")
    path_runs.append(runs)
    if xs.shape != (PERIODS13 + 1, 2 * n) or not bool(
            torch.isfinite(xs).all()):
        raise AssertionError(f"config 5 {topo13.name} closed loop: states "
                             f"{tuple(xs.shape)}, finite "
                             f"{bool(torch.isfinite(xs).all())}")

    # float64 on the first S5_F64 scenarios: the kernel step against the
    # plain step (phase 8's rule)
    m64 = f64_of[id(m)]
    cost64 = to64(cost5)
    x64 = torch.as_tensor(x0n[:, :S5_F64], dtype=torch.float64, device=dev)
    U64 = torch.zeros((N5, n, S5_F64), dtype=torch.float64, device=dev)
    f64 = {uk: make_scenario_step(m64, cost64, ScenarioMPCConfig(ILQRConfig(
        N=N5, dt=DT13, iters=ITERS5, use_kernels=uk), S5_F64))(x64, U64)
           for uk in (None, False)}
    f64_err = {}
    for what, k_, p_ in zip(("u0", "U_next", "costs"), f64[None], f64[False]):
        err = float((k_ - p_).abs().max())
        tol = U0_REL * max(1.0, float(p_.abs().max()))
        f64_err[what] = {"max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"config 5 {topo13.name} float64: {what} "
                                 f"off by {err} (tol {tol})")
    config5_13 = {
        "robot": topo13.name, "joints": n, "dt": DT13, "S": S5, "N": N5,
        "iters": ITERS5, "dtype": "float32", "device": smi, "step_ms": ms13,
        "scenario_solves_per_s": S5 / (ms13 / 1e3), "launches": path_runs[-2],
        "closed_loop_launches": runs,
        "cost_first_mean": float(tr[0].mean()),
        "cost_last_mean": float(tr[-1].mean()),
        "closed_loop_final_state_max": float(xs[-1].abs().max()),
        "f64_first64": f64_err, "kernels": kern13, "elapsed_s": elapsed()}
    line("config5_hands52", config5_13)
    del x0s, U0, step, f64, xs
    torch.cuda.empty_cache()

    # GRiD's first-order calls at B = 1 and L1: one launch each, the float32
    # rule against a float64 plain GRiD (and a float32 plain one), µs a call
    g13 = (GRiD(topo13, dtype=torch.float32, device=dev),
           GRiD(topo13, dtype=torch.float32, device=dev, use_kernels=False),
           GRiD(topo13, dtype=torch.float64, device=dev, use_kernels=False))
    rng = np.random.default_rng(5)
    methods13 = {"id": ("rnea", 3), "id_bias": ("rnea", 2),
                 "id_du": ("id_du", 3), "aba": ("aba", 3),
                 "minv": ("minv", 1), "minv_upper": ("minv", 1),
                 "fd": ("fd", 3), "crba": ("crba", 1), "fd_du": ("fd_du", 3),
                 "eepos": ("eepos", 1), "deepos": ("deepos", 1),
                 "d2eepos": ("d2eepos", 1)}
    grid13, grid_runs = {}, {}
    for batch in (1, L1):
        x = tuple(torch.as_tensor(rng.uniform(-1, 1, (batch, nj13)),
                                  dtype=torch.float32, device=dev)
                  for _ in range(3))
        for label, (kernel, nargs) in methods13.items():
            method = {"id_bias": "id", "minv_upper": "minv"}.get(label, label)
            kw = {"dense": False} if label == "minv_upper" else {}
            call = lambda gg, xx: getattr(gg, method)(*xx[:nargs], **kw)
            build.reset_counters()
            out = call(g13[0], x)
            torch.cuda.synchronize()
            if dict(build.LAUNCHES) != {kernel: 1} or build.PLAIN_CALLS:
                raise AssertionError(f"{topo13.name} GRiD.{label} B={batch}: "
                                     f"launches {dict(build.LAUNCHES)}, "
                                     f"plain calls "
                                     f"{dict(build.PLAIN_CALLS)}")
            grid_runs[kernel] = grid_runs.get(kernel, 0) + 1
            ek, ep = check_f32(f"{topo13.name} GRiD.{label} B={batch}", out,
                               call(g13[1], x),
                               call(g13[2], tuple(a.double() for a in x)))
            grid13[f"{label}_B{batch}"] = {
                "us_per_call": time_cuda(lambda: call(g13[0], x), iters=(
                    50 if batch == 1 else 10)) * 1e3,
                "kernel_err_vs_f64": ek, "plain_err_vs_f64": ep} | {
                k: v for k, v in roofline(kernel, m, (m, *(
                    a.T for a in x[:nargs])), (out,)).items()
                if k in ("bound_ms", "bound_by")}
    path_runs.append(grid_runs)
    line("grid_hands52", {"robot": topo13.name, "device": smi,
                          "calls": grid13, "elapsed_s": elapsed()})
    for name in ("fd_du", "riccati", "linesearch_rollout", "rollout", "aba"):
        results[name]["hands52"] = {k: kern13[name][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "launches_per_step")}
    for case, name in (("riccati_factored", "riccati_factored"),
                       ("riccati_stacked", "riccati"),
                       ("feedback_rollout", "feedback_rollout"),
                       ("linesearch_nocost", "linesearch_nocost")):
        results[name].setdefault("hands52", {})[f"{case}_N8_B37"] = {
            k: f32_13[case][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "max_abs_err")}
    for label, (kernel, _) in methods13.items():
        if kernel in results:
            results[kernel].setdefault("hands52", {})[
                f"grid_{label}_us"] = {b: grid13[f"{label}_B{b}"][
                    "us_per_call"] for b in (1, L1)}
    del g13, m
    torch.cuda.empty_cache()

    # -- phase 14: the second order above 28 joints --------------------------
    phase_start[14] = elapsed()
    t = time.perf_counter()
    build.lib(nj34)
    lib14 = {"seconds": round(time.perf_counter() - t, 3),
             "nvcc_seconds": round(build.NVCC_SECONDS[nj34], 3)}
    # idsva_so's plan and route at 28, 34 and 52 joints; fdsva_so is
    # composed above 22 | 17 joints
    plans14 = {}
    for nj in (28, topo34.get_num_joints(), nj13):
        for dt in dtypes:
            p = build.plan("idsva_so", nj, dt)
            plans14[f"{nj} {str(dt)[6:]}"] = {f: p[f] for f in (
                "knots_per_block", "threads_per_knot", "smem_bytes_per_block",
                "bands", "device_tile", "registers", "local_bytes",
                "blocks_per_sm")} | {
                "route": K.idsva_so_route(nj, dt),
                "fdsva_so_route": K.fdsva_so_route(nj, dt)}
            if K.fdsva_so_route(nj, dt) != K.COMPOSED or (
                    nj == nj13 and K.idsva_so_route(nj, dt) != K.DEVICE):
                raise AssertionError(f"second order at {nj} joints in {dt}: "
                                     f"{plans14}")
    line("so_big_build", {"robot": topo34.name} | lib14 | {
        "idsva_so_plans": plans14, "elapsed_s": elapsed()})

    # (a) float64: GRiD's second order against the plain versions at 1 and
    # 37 lanes, and idsva_so at L_STRIDE14 (its blocks over more than one
    # group of lanes), each call its route's kernels and nothing plain,
    # within 1e-9 of each output's scale; float32 idsva_so at 34 joints on
    # those lanes by the float32 rule
    so_launches = {"idsva_so": {"idsva_so": 1},
                   "fdsva_so": {"fd_du": 1, "idsva_so": 1}}
    f64_14 = {}
    for tp in (topo34, topo13):
        gk = GRiD(tp, dtype=torch.float64, device=dev)
        gp = GRiD(tp, dtype=torch.float64, device=dev, use_kernels=False)
        rng = np.random.default_rng(14)
        for b in (1, 37, L_STRIDE14):
            shape = (gk.n,) if b == 1 else (b, gk.n)
            x = tuple(torch.as_tensor(rng.uniform(-1, 1, shape),
                                      dtype=torch.float64, device=dev)
                      for _ in range(3))
            for method, want in so_launches.items():
                # the striding blocks' code is the same at every count:
                # held at 34 joints (2 knots a block in float64)
                if b == L_STRIDE14 and (method != "idsva_so"
                                        or tp is not topo34):
                    continue
                what = f"{tp.name} GRiD.{method} B={b} float64"
                build.reset_counters()
                out = getattr(gk, method)(*x)
                torch.cuda.synchronize()
                if dict(build.LAUNCHES) != want or build.PLAIN_CALLS:
                    raise AssertionError(f"{what}: launches "
                                         f"{dict(build.LAUNCHES)}, plain "
                                         f"calls {dict(build.PLAIN_CALLS)}")
                ref = getattr(gp, method)(*x)
                err = max_err((out,), (ref,))
                tol = 1e-9 * max(1.0, float(ref.abs().max()))
                if out.shape != ref.shape or not err <= tol:
                    raise AssertionError(f"{what}: max abs err {err} > {tol}")
                f64_14[what] = {"max_abs_err": err, "tol": tol}
                del out
                if b == L_STRIDE14 and tp is topo34:
                    # float32's device tile (4 knots a block) by the float32
                    # rule, against the float64 plain output above
                    x32 = tuple(a.float() for a in x)
                    g32, gp32 = (GRiD(tp, dtype=torch.float32, device=dev,
                                      use_kernels=uk) for uk in (None, False))
                    what = f"{tp.name} GRiD.idsva_so B={b} float32"
                    build.reset_counters()
                    out = g32.idsva_so(*x32)
                    torch.cuda.synchronize()
                    if dict(build.LAUNCHES) != want or build.PLAIN_CALLS:
                        raise AssertionError(f"{what}: launches "
                                             f"{dict(build.LAUNCHES)}")
                    ek, ep = check_f32(what, out, gp32.idsva_so(*x32), ref)
                    f64_14[what] = {"kernel_err_vs_f64": ek,
                                    "plain_err_vs_f64": ep}
                    del out, g32, gp32
                del ref
        del gk, gp
    line("so_big_f64", {"cases": f64_14, "elapsed_s": elapsed()})

    # (b) float32 on atlas_hands52: GRiD's second order at B_SO14 (µs a
    # call, launches), each kernel's ms at those lanes beside its bound
    # (operations counted once a lane), the float32 rule at B=128 against
    # plain float32 and float64 GRiD, and the error against the float64
    # kernels (held to plain above) at every B
    m = build_model(topo13, dtype=torch.float32, device=dev)
    f64_of[id(m)] = m.to(dtype=torch.float64)
    gk, gk64 = (GRiD(topo13, dtype=dt, device=dev) for dt in dtypes)
    gp, gp64 = (GRiD(topo13, dtype=dt, device=dev, use_kernels=False)
                for dt in dtypes)
    ops14 = {(k, ex): opcount.ops_per_lane(k, m, executed=ex)
             for k in ("idsva_so", "fdsva_so") for ex in (False, True)}
    grid14 = {}
    rng = np.random.default_rng(16)
    for b in B_SO14:
        shape = (nj13,) if b == 1 else (b, nj13)
        x = tuple(torch.as_tensor(rng.uniform(-1, 1, shape),
                                  dtype=torch.float32, device=dev)
                  for _ in range(3))
        x64 = tuple(a.double() for a in x)
        lanes = tuple(a.reshape(-1, nj13).T.contiguous() for a in x)
        for method, want in so_launches.items():
            what = f"{topo13.name} GRiD.{method} B={b}"
            build.reset_counters()
            out = getattr(gk, method)(*x)
            torch.cuda.synchronize()
            if dict(build.LAUNCHES) != want or build.PLAIN_CALLS:
                raise AssertionError(f"{what}: launches "
                                     f"{dict(build.LAUNCHES)}, plain calls "
                                     f"{dict(build.PLAIN_CALLS)}")
            row = {"kernel_err_vs_f64_kernel": max_err(
                (out,), (getattr(gk64, method)(*x64),))}
            if b == 128:   # the plain versions take seconds a call here
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                ref = getattr(gp, method)(*x)
                ev[1].record()
                ev[1].synchronize()
                row["plain_ms"] = ev[0].elapsed_time(ev[1])
                ref64 = getattr(gp64, method)(*x64)
                row["kernel_err_vs_f64"], row["plain_err_vs_f64"] = \
                    check_f32(what, out, ref, ref64)
                del ref, ref64
            kern = getattr(K, method)
            kargs = (m, *lanes, GRAVITY)
            row["us_per_call"] = time_cuda(lambda: getattr(gk, method)(*x),
                                           iters=5 if b < 1024 else 3) * 1e3
            row["ms"] = time_cuda(lambda: kern(*kargs), iters=3)
            ops = ops14[method, False] * b
            row |= dict(zip(("bound_ms", "bound_by"), opcount.bound_ms(
                ops, opcount.tensor_bytes(kargs, (out,),
                                          build.model_buffer(m)),
                torch.float32)))
            row |= {"ops": ops, "ops_executed": ops14[method, True] * b}
            grid14[f"{method}_B{b}"] = row
            del out
        del x, x64, lanes
        torch.cuda.empty_cache()
    line("grid_so_hands52", {"robot": topo13.name, "device": smi,
                             "dtype": "float32", "calls": grid14,
                             "ops_per_lane": {
                                 f"{k} {('needed', 'executed')[ex]}": v
                                 for (k, ex), v in ops14.items()},
                             "elapsed_s": elapsed()})
    del gk, gk64, gp, gp64

    # (c) config 4's SQP (bench.py:199-228: QuadCost, N=32, 4 iterations)
    # on atlas_hands52 at B14, float32, dt DT13, x0 from its own
    # default_rng(0) as path A's: rollout, fd_du, the composed fdsva_so
    # (fd_du and idsva_so) and the line search every iteration, nothing
    # plain; costs finite and non-increasing; solves/s, each phase's ms and
    # the peak device memory
    n = m.n
    cfg_kw = dict(N=N4, dt=DT13, iters=ITERS4)
    solve14, parts14 = make_sqp(m, quad_cost(m, QUAD4), SQPConfig(**cfg_kw),
                                expose_parts=True)
    x0n = np.random.default_rng(0).uniform(-0.2, 0.2, (2 * n, B14))
    x14 = torch.as_tensor(x0n, dtype=torch.float32, device=dev)
    U14 = torch.zeros((N4, n, B14), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counters()
    res14 = solve14(x14, U14)
    torch.cuda.synchronize()
    peak14 = torch.cuda.max_memory_allocated()
    path_runs.append(check_run(
        f"config 4 {topo13.name}", res14,
        {"rollout": 1, "linesearch_rollout": ITERS4, "fd_du": 2 * ITERS4,
         "idsva_so": ITERS4}, N4, B14, ITERS4, n))
    ms14 = time_cuda(lambda: solve14(x14, U14), iters=1, warmup=0)
    X = parts14["rollout"](x14, U14)
    A, Bm = parts14["linearize"](X[:N4], U14)
    so = parts14["second_order"](X, U14)
    ks, Ks = parts14["backward"](X, U14, A, Bm, so)
    phases14 = {"backward_ms": time_cuda(
        lambda: parts14["backward"](X, U14, A, Bm, so), iters=1)}
    del so
    phases14 |= {
        "rollout_ms": time_cuda(lambda: parts14["rollout"](x14, U14),
                                iters=3),
        "linearize_ms": time_cuda(lambda: parts14["linearize"](X[:N4], U14),
                                  iters=3),
        "fdsva_so_ms": time_cuda(lambda: parts14["second_order"](X, U14),
                                 iters=1),
        "forward_ms": time_cuda(lambda: parts14["forward"](X, U14, ks, Ks),
                                iters=3)}
    # the composed fdsva_so's kernels at the solve's N*B lanes (its first
    # iteration's inputs), idsva_so beside its bound
    fold = lambda Z: Z.transpose(0, 1).reshape(Z.shape[1], -1)
    q, qd, u = fold(X[:N4, :n]), fold(X[:N4, n:]), fold(U14)
    qdd = K.fd_du(m, q, qd, u)[1]
    phases14["fd_du_ms"] = time_cuda(lambda: K.fd_du(m, q, qd, u), iters=3)
    phases14["idsva_so_ms"] = time_cuda(lambda: K.idsva_so(m, q, qd, qdd),
                                        iters=3)
    lanes14 = N4 * B14
    phases14["idsva_so_bound_ms"], phases14["idsva_so_bound_by"] = \
        opcount.bound_ms(ops14["idsva_so", False] * lanes14,
                         opcount.tensor_bytes(q, qd, qdd) + 4 * n ** 3
                         * lanes14 * 4, torch.float32)
    phases14["lanes"] = lanes14
    del X, A, Bm, ks, Ks, q, qd, u, qdd
    torch.cuda.empty_cache()

    # (d) float64 on the first 64 problems: the kernel solve against the
    # plain one after iteration 1 (phase 6's rule for SQP; the plain solve
    # stops there, since a plain float64 iteration takes 8-11 s at 52
    # joints), and, to show how far the solve itself parts rounding-level
    # differences, the kernel solve with fdsva_so's output scaled by
    # 1 + EPS14 against the unscaled one over all ITERS4 iterations; each
    # pair's share within F64_REL and largest rel difference at every
    # iteration it ran, and each solve's seconds
    m64 = f64_of[id(m)]
    x64 = torch.as_tensor(x0n[:, :64], dtype=torch.float64, device=dev)
    U64 = torch.zeros((N4, n, 64), dtype=torch.float64, device=dev)
    fdsva_kernel = K.fdsva_so

    def solve64(use_kernels, eps, iters):
        if eps:
            K.fdsva_so = lambda *a: fdsva_kernel(*a).mul_(1 + eps)
        try:
            solve = make_sqp(m64, quad_cost(m64, QUAD4), SQPConfig(
                **(cfg_kw | {"iters": iters}), use_kernels=use_kernels))
        finally:
            K.fdsva_so = fdsva_kernel
        t = time.perf_counter()
        trace = solve(x64, U64).cost_trace.cpu()
        return trace, time.perf_counter() - t

    tr64, s64 = {}, {}
    for key, uk, eps, iters in (("kernel", None, 0.0, ITERS4),
                                ("plain", False, 0.0, 1),
                                ("kernel_scaled", None, EPS14, ITERS4)):
        tr64[key], s64[key] = solve64(uk, eps, iters)
    per_iter = {}
    for pair, (a, b) in (("kernel_vs_plain", ("kernel", "plain")),
                         ("scaled_vs_kernel", ("kernel_scaled", "kernel"))):
        it = min(len(tr64[a]), len(tr64[b]))
        r = rel(tr64[a][:it], tr64[b][:it])
        per_iter[pair] = {
            "share": [float(x) for x in (r <= F64_REL).double().mean(1)],
            "max_rel": [float(x) for x in r.max(1).values]}
    f64_at = per_iter["kernel_vs_plain"]["share"][1]
    agree14 = {
        "f64_held_at_iter": 1, "f64_kernel_vs_plain_share_at_iter": f64_at,
        "f64_kernel_vs_plain_max_rel_at_iter": per_iter[
            "kernel_vs_plain"]["max_rel"][1],
        "per_iteration": per_iter, "scaled_eps": EPS14,
        "cost_mean_per_iteration": {k: [float(c) for c in v.mean(1)]
                                    for k, v in tr64.items()},
        "solve_s": s64}
    if not f64_at >= F64_SHARE:
        raise AssertionError(f"config 4 {topo13.name} float64: kernel solve "
                             f"within rel {F64_REL} of the plain one on "
                             f"{f64_at} of the problems after iteration 1 < "
                             f"{F64_SHARE}: {agree14}")
    config4_14 = {
        "robot": topo13.name, "joints": n, "B": B14, "N": N4,
        "iters": ITERS4, "dt": DT13, "dtype": "float32", "device": smi,
        "fdsva_so_route": K.fdsva_so_route(n, torch.float32),
        "idsva_so_route": K.idsva_so_route(n, torch.float32),
        "solve_ms": ms14, "solves_per_s": B14 / (ms14 / 1e3),
        "max_memory_allocated_bytes": peak14,
        "cost_first_mean": float(res14.cost_trace[0].mean()),
        "cost_last_mean": float(res14.cost_trace[-1].mean()),
        "launches": path_runs[-1], "phases": phases14,
        "first64": agree14, "elapsed_s": elapsed()}
    line("config4_hands52", config4_14)
    for name in ("idsva_so", "fdsva_so"):
        results[name]["hands52"] = {
            f"B{b}": {k: grid14[f"{name}_B{b}"][k] for k in (
                "ms", "bound_ms", "bound_by", "ops", "ops_executed",
                "kernel_err_vs_f64_kernel")} for b in B_SO14} | {
            "plain_ms_B128": grid14[f"{name}_B128"]["plain_ms"],
            "route": (K.idsva_so_route(nj13, torch.float32)
                      if name == "idsva_so" else
                      K.fdsva_so_route(nj13, torch.float32)),
            "config4_launches_per_solve": path_runs[-1][name] if
            name in path_runs[-1] else 0,
            "f64_max_abs_err": max(v["max_abs_err"] for k, v in
                                   f64_14.items() if topo13.name in k
                                   and f"GRiD.{name} " in k),
            "config4_ms": phases14[f"{name}_ms"]}
    results["idsva_so"]["hands52"]["config4_bound_ms"] = phases14[
        "idsva_so_bound_ms"]
    del res14, m, m64, tr64, x14, U14, solve14, parts14
    torch.cuda.empty_cache()
    phase_start[15] = elapsed()
    line("phase_seconds", {k: round(phase_start[k + 1] - phase_start[k], 1)
                           for k in range(1, 15)} | {
        "last_phase_end_s": phase_start[15]})
    print(smi, flush=True)

    path_launches = {k: sum(run.get(k, 0) for run in path_runs)
                     for k in results}
    missing = [k for k, v in path_launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels the main paths never launched: "
                             f"{missing}")
    print(json.dumps({"kernels": [
        {k: results[name][k] for k in ("name", "route", "source",
                                       "replaces")}
        | {"launches": path_launches[name]}
        | {k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "ops",
                                         "ops_executed")}
        | {"library_ms": None}
        | {k: results[name][k] for k in ("config5", "humanoids", "per_knot",
                                         "hands52") if k in results[name]}
        for name in results]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
