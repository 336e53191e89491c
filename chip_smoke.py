#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dexterity_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --closed-loop SEED [--max-wall SECONDS]
    python3 chip_smoke.py --hold-readings N
    python3 chip_smoke.py --phase-split [CASES]

Needs a CUDA device and the repository checkout beside this file; exits
non-zero otherwise, and on any failed check.  Phases, one JSON line each:

  0. probe: torch/CUDA versions, the card, the kernel build (one nvcc per
     csrc/*.cu source, all started together, sm_90a), and the registers
     and spills of the register-design kernels, K1-K4 in both types, and
     of the wide-design kernels, K1-K4 in both types at 64 rows and K1
     and K4 at 80 (none may spill), and of the tree-sweep kernels.
  1. rollouts: the ShadowHand reorient planning model (4 Newton iterations,
     6 line-search steps, refactor every 2, 3 substeps, contact budget
     16/16, implicit damping, no self-collision) steps B = 1024 rollouts
     through 10 control steps of step_n_b; the launch counts of the Cholesky
     kernels are read for exactly that run, the contact path is checked,
     and the first control step of 8 rollouts is held against the port run
     on the CPU in float64.
  2. environment model: one control step (5 substeps, exact Newton, Euler
     damping solve, contact 64/64) at B = 256: K3's 45 launches, and the
     step's device time with K3's share of it.
  2c. environment: manipulation.load('reorient', 'state_dense') on the
     card, GoalEnvironment.reset of 32 episodes from a seeded CPU
     generator, then 3 steps with seeded actions: wall time of reset and
     of each step, device time and idle share of one step, K3's launches
     checked exactly (8 in reset, 45 per step), the placement tries, each
     observation's shape, and the first 8 episodes held against the same
     calls on the CPU in float64 (qpos 1e-4, qvel 1e-2, goals, goal
     distance, reward, step_type, the task-state flags, observations to
     1e-4 of their max-abs); K3 held against its plain version and
     float64 on the Hessians and Euler matrices reset and step give it,
     at (32, 30, 30) and for one episode without a batch axis.  Then
     reset and a step at B = 256 (key `b256`): K3's launches (8, 45), the
     first 8 episodes' step against the CPU float64 step from the card's
     reset state, one episode's step without a batch axis against row 0,
     K3 held on the step's Newton Hessian and Euler matrix at
     (256, 30, 30) and (1, 30, 30), device time of reset's forward, the
     step and its refresh, the step's idle share, K3's share and design.
  3. planner (the main path): PredictiveSampling.solve_batch at bench.py's
     configuration (4 streams x 256 samples x 2 CEM iterations, horizon
     10) from GoalEnvironment.reset's states and goals: solves/s, launches
     per solve, action and return checks, and rollout returns held
     against the port on the CPU in float64.
  3b. planner_per_candidate: one stream's solve with batched_rollouts=False
     (256 samples x 2 CEM iterations, each candidate through the
     per-environment step_n): wall time of each of 2 solves after a
     warm-up (cut from 3, `reduced`), 120 K1 + 120 K2 launches per
     solve, rollout_return of 8 candidates held against the port on the
     CPU in float64.
  3c. sharded: sharded_solve_batch at the bench configuration on a world
     of one NCCL rank (FileStore, no TCP port), a warm-up and 2 timed
     calls, each bit-equal to solve_batch from the same generator seed
     (actions, nominal, best returns) with 120 K1 + 120 K2 launches; one
     MPPI sharded_solve (temperature 0.5) bit-equal to solve; the wall of
     both per call and the all-gather's time.  Multi-rank equality is
     held on the CPU (tests/test_torch_distributed.py): one card cannot
     hold two NCCL ranks.
  4. tree sweep: build_tree_sweep (K5 + K6) on the rollouts' states after
     their first control step, against its plain version in float32 and
     float64 (also at B = 37), qm factorable; timed beside
     step._precompute_planes; K5's launch shape (grid and block, from the
     profiler's trace) and its wrapper's host time by operation (the
     profiler's CPU activity).
  5. cholesky_factor: the K4 + K2 entry points on the path's Hessians.
  6. kernels: each Cholesky kernel against its plain version and a
     float64 reference, on seeded SPD matrices and on the Hessians the
     rollouts built, and K1/K2 on a rank-deficient batch; timed (device
     time, torch.profiler) beside its plain version, a library call and
     its bound.  K1-K4 also name the design that ran (`design`, from the
     profiled kernel names) and time the shared-memory design at the same
     inputs, in turns with it (`previous_design_ms`); K3 also at the
     environment step's shape (`env_shape`).
  7. juggle size: K1, K2 and K4 (the wide design) at (1024, 62, 62) on
     seeded SPD matrices: a counted run of the cholesky_factor /
     cholesky_resolve, cholesky_solve_factor and cholesky_solve entry
     points (one launch each; the timed kernels' rows join the kernels
     line), each kernel checked against its plain version and timed in
     turns with the shared design, beside its bound (one triangle, and
     n^2 in `bound_square_ms`), its plain version and the library call.
     Then `size_n80`: the same at (1024, 80, 80), the top of the JAX
     package's Pallas range, for K1-K4: each runs the wide design's
     80-row layout there (three warps a matrix; checked from the
     profiled kernel names) and is timed in turns with the shared
     design.
  8. closed_loop: scripts/eval_closed_loop_batch.py's configuration (256
     samples, 2 iterations, horizon 10, 4 knots, the task's 5 substeps,
     refactor every 4, its keep-in-hand shaping) on 4 goals from reset
     for at most 3 control steps (cut from 10, `reduced`): solve_batch
     over all goals, then
     env.step; finished episodes frozen.  Median goal distance at the
     start and the end, the episodes that ended, wall per control step,
     and the wall, device busy time and idle share of one solve_batch and
     one env.step; K1 and K2 held against their plain versions and
     float64 on one solve_batch's own inputs (goals x 256 rows; 8192 in
     the bar); everything finite, frozen episodes unmoved.  No success
     rate is checked.
  9. reach and juggle: manipulation.load of reach.state_dense (Adroit,
     nv = 24) and juggle.state_sparse (two MPL hands welded to mocap
     bodies, nv = 62, 20 equality rows), reset of 32 episodes and 3
     steps each: wall of reset and steps, device time and idle share of
     one step, K3's launches (9 per substep; 26 in reset: 8 in its
     forward and one settle of 2 substeps) and the design that ran
     (registers at 24, wide at 62), the first 8 episodes held against
     the CPU float64 port at TASK_LIMITS (qpos, qvel, reach's settled
     goals; goal distance, reward and observations relative to their
     max-abs; step_type and the task-state flags equal; an episode is
     left out only where a rejection search picked another try), K3
     held against its plain version and float64 on a step's own Newton
     Hessian and Euler matrix at (32, n, n) and for one episode without a
     batch axis; for juggle also the tree sweep (K5 + K6) on its reset
     states at nmocap = 2 against its plain version.
  10. reach_oracle: examples/oracle_reach.py's policy on 8 reach
     state_sparse episodes, at most 200 steps: success rate, mean return,
     steps; every episode must register a solve and see reward 0.
  11. suite: scripts/bench_suite.py, every manipulation.ALL_NAMES task
     through BatchedEnvironment.step_with_metrics under uniform random
     actions at B = 4096: 2 warm-up and 25 timed steps (cut from the
     reference's 100 in `reduced`), env steps/s, substeps/s, episodes,
     mean return, K3 launches, the device idle share of one step, peak
     memory; K3 held against its plain version and float64 on reach's and
     juggle's own Newton Hessian and Euler matrix at (4096, n, n).
  12. k3_task_sizes: K3 on juggle's own Newton Hessians at (32, 62, 62)
     and (4096, 62, 62) (wide design) and reach's at (4096, 24, 24)
     (register design), each held in phase 9 or 11: device time in turns
     with the shared design (`previous_design_ms`), bound, plain version,
     library call, per-call time; these rows join the kernels line.  On
     the same juggle Hessians the K4 + K2 pair and K2 on K1's factor
     (wide design) are held against their plain versions and float64,
     and K2 at (32, 62, 62) is timed in turns with the shared design.
  13. ilqr: ILQR.solve at scripts/eval_ilqr.py's configuration (H = 32,
     4 iterations, 6 line-search steps, refactor every 4, 3 substeps,
     the keep-in-hand shaping as a cost) for 8 goals from
     GoalEnvironment.reset, after a warm-up solve at H = 2: wall,
     solves/s, peak memory, an estimate of the device busy time and idle
     share (one profiled window per stage, weighted by its count in a
     solve), K1 and K2 launches exactly (primal and tangent: K1 = 2HS +
     cS, K2 = 6HS + 7cS per iteration, c = 1 linearization pass), finite
     actions within the bounds, each iteration's cost no higher than
     its alpha = 0 candidate's; the linearization in goal 0's 32 blocks
     against the CPU float64 port (LIN_LIMITS in the blocks both
     precisions resolve, for the card and the CPU float32 port; also
     read under TF32 and a bfloat16 K2 tangent, the faults), and each
     tangent launch against its plain rule and float64 on the path's own
     inputs; the steps of the first backward pass whose gains are NaN,
     on the card and on the CPU float64 port.
  14. ilqr_k3: the same at refactor every 1 (K3 and its rule), H = 4,
     1 iteration, 2 goals: K3's launches exactly, its tangent launch held.
  15. sqp: SQP.solve, H = 32, 1 iteration, 8 goals: wall, launches
     exactly, a finite plan within the bounds, the cost no higher than
     the alpha = 0 candidate's.
  16. hybrid: scripts/eval_ilqr.py's hybrid control step (predictive
     sampling's solve_batch, warm_start, the two trajectory costs that
     pick the seed, one iLQR iteration, env.step) for 4 goals and 1
     control step (cut from 2 to keep the script inside its limit): wall
     per control step and its parts.
  17. ik: IKSolver.solve_batch on the card (Adroit, float32): 64 feasible
     target sets (the fingertips' FK at joint positions uniform in 0.8 of
     the ranges, as examples/inverse_kinematics.py draws them) x 30
     attempts, up to 100 steps, tolerance 1e-3; a warm-up and 3 timed
     calls: target sets/s, wall per call, the loop's iterations, launches
     per iteration, device busy and idle of one call, peak memory, the
     K1-K6 launches (none: the path runs no TPU kernel's port).  Holds:
     every solved set's FK in float64 within 1.5 tol of its targets and
     its joints in range, at least 52 of 64 solved (tests/test_ik.py's 4
     in 5), all tips 2 m overhead fails, the first iteration's q-dot of 8
     sets' attempts within IK_QDOT_LIMIT of the CPU float64 port (and the
     stacked Jacobian rounded to TF32, the fault, outside it); reported:
     success agreement with the CPU float64 port from the same starts.
  18. wrappers: reorient at B = 32 in a BatchedEnvironment whose hand
     effector is wrapped in SmoothAction(PreviousAction(.), 0.3), 3 steps
     with rows 1 and 5 reset before the last, against the same run on the
     CPU in float64 (first 8 episodes, TASK_LIMITS['reorient']): the
     wrapper state equal (flags exactly, commands within float32
     rounding), the reset rows' smoothing restarted; then a checkpoint
     save / load of the card's state, bit-equal.
  19. mjcf: each hand (Shadow, Adroit, MPL right) and the reorient arena
     through the port's export_mjcf (visual primitives kept) and
     load_mjcf_string, compiled onto the card (the dropped-pair set
     travels beside the text, which cannot carry it); every array of the
     reparsed model within one float32 rounding of the original's (mesh
     geoms, which the export drops, left out), and 256 rows stepped 10
     environment steps on both (K3 on both) held at MJCF_LIMITS; an
     export printed at 6 digits is the fault, read beside.
  20. prune: pair_distance_stats of the reorient arena on the card (256
     samples, float32) against the CPU float64 port on the same draws,
     held within PRUNE_RANGE (2 cm) of contact: min, reference-pose and
     median distances and each sampled distance at PRUNE_LIMITS, no
     sample on the other side of 0 beyond it, the dropped-pair set equal
     but for pairs within the limit of a threshold (listed); the CPU
     float32 port and bfloat16 joint draws (the fault) read beside.
  21. render: `renderer` gives the MuJoCo version and GL backend, or
     `absent: <the ImportError>`.  Always: export_mjcf(include_meshes=True)
     of the reorient and reach arenas and of each hand (the mesh assets,
     every file under the port's assets/meshes, every STL read with finite
     vertices, the visual mesh geoms, the MPL's dual-use visuals), and the
     card's side of the vision path: reach state_dense at B = 8, reset and
     3 steps, each step followed by rendering.host_state (one copy of qpos
     and mocap to the host, equal to the state), K3 above 0.  Where mujoco
     imports: reach VISION_ONLY on the card at B = 8 (front_close (8, 84,
     84, 3) uint8 on cuda, not black, the renderer's model with meshes, K3
     above 0), the pixel hold against the CPU float64 port from the same
     draws at PIXEL_LIMITS (hinges moved by 0.01 rad and TF32 products read
     beside), and reorient state_dense against VISION_ONLY at B = 8 over
     20 steps (env steps/s, render ms per step, device idle).
  --profile adds host and device time by stage and device time by kernel
  over one planning control step, and the device busy time and idle share
  over one solve_batch.
Device times are torch.profiler's summed kernel records over the calls
made.  The profiler drops the first records of a window on the H100, so
each window opens with spin kernels left out of its sums (_profiled); it
stands only where some of them were recorded and, for the kernel rows and
the environment step windows, where its Cholesky and tree-sweep records
equal the wrappers' launch counts.  The `profiler_passes` line counts the
windows, the records dropped in each and the windows that did not stand.
Then the `kernels` line (K1-K6, K3's rows at the new tasks' sizes, and
K1, K2 and K3 on the `ilqr` path at the linearization's shapes),
the card's name and power limit, and as the last line {"ok": true,
"device": {...}}.

--closed-loop SEED runs the probe and then only the closed-loop bar: 32
goals from seed SEED, up to 300 control steps, stopping when every
episode has ended (or after --max-wall seconds, reporting how far it
got).  It prints a progress line every 10 control steps and the run's
summary in the shape of EVAL_CLOSED_LOOP_r05.json's runs; the exit code
and the last line do not depend on the success rate.

--hold-readings N runs the probe and then only phase 9's hold against the
CPU float64 port, on seeds 0 to N - 1, for runs that are sound (the card;
the port on the CPU in float32) and faulted (the card with TF32 matrix
products; with K3's solution rounded to bfloat16): the readings that
TASK_LIMITS is set from, one line per task; then phase 17's q-dot hold on
N seeds, sound and faulted (IK_QDOT_LIMIT's readings); then the pixel
hold on N seeds (PIXEL_LIMITS' readings: the card and the CPU float32
port sound; hinges moved by 0.01 rad and TF32 products faulted), or the
renderer's absence.

--phase-split [CASES] runs the probe and then only the split of K1-K4's
time at (1024, n, n) float32 into the load, the pivot chain (K2: the
forward substitution) and the rest (the factor's store; K1's and K3's
substitutions; K2's back substitution), from a build of the Cholesky
sources with DEX_PHASE_CLOCKS, whose warps stamp clock64() at each
boundary; CASES is a comma list of shared80, wide62 and wide80 (default
all).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Main path: bench.py's planner configuration.
PLAN = dict(solver_iterations=4, ls_iterations=6, solver_refactor_every=2,
            plan_substeps=3, plan_midphase_cap=16, plan_contact_top_k=16,
            plan_implicit_damping=True, plan_self_collision=False)
B_PLAN = 1024
H = 10
B_ENV = 256
SEED = 0
# Planner: bench.py's throughput configuration (B_PLAN rollouts per CEM
# iteration), timed over SOLVES calls after one warm-up call.
STREAMS = 4
SAMPLES = 256
ITERATIONS = 2
SOLVES = 5
# Per-candidate planner (batched_rollouts=False): one stream, timed over
# PC_SOLVES solves after one warm-up solve (cut from PC_SOLVES_BEFORE to
# keep the script inside its limit on a slow host).
PC_SOLVES = 2
PC_SOLVES_BEFORE = 3
# The juggle model's nv (ROADMAP §A.3), where K1 and K2 leave the register
# design.
JUGGLE_NV = 62
# The top of the JAX package's Pallas range (linalg_pallas._max_pallas_n):
# K1-K4 run the wide design's 80-row layout there.
N_TOP = 80
# --phase-split's cases: label -> (design, n).
SPLIT_CASES = {'shared80': ('shared', N_TOP), 'wide62': ('wide', JUGGLE_NV),
               'wide80': ('wide', N_TOP)}
# Environment phase: GoalEnvironment.reset of B_EPISODES episodes, then
# ENV_STEPS control steps; the first ENV_CHECKED held against the CPU.
B_EPISODES = 32
ENV_STEPS = 3
ENV_CHECKED = 8
# Closed loop: scripts/eval_closed_loop_batch.py's configuration as
# EVAL_CLOSED_LOOP_r05.json records it (plan_substeps None: the task's 5;
# refactor every 4), with its keep-in-hand shaping (:66-76).  The default
# phase runs CL_GOALS goals for at most CL_STEPS control steps (cut from
# 10 to 5, then to 3, to keep the script inside its limit as phases were
# added and on a slow host);
# --closed-loop SEED runs the bar: BAR_GOALS goals, up to BAR_STEPS.
CLOSED_LOOP = dict(samples=256, horizon=10, knots=4, temperature=0.0,
                   noise=0.2, iterations=2, noise_decay=0.5,
                   failure_penalty=30.0, plan_substeps=None, refactor=4,
                   solver_iterations=4, ls_iterations=6, midphase=16,
                   top_k=16)
SHAPING = dict(horiz=300.0, drop=2000.0, margin=0.035, vel=0.0)
SPAWN_CENTER = (0.0, -0.13, 0.16)
CL_GOALS = 4
CL_STEPS = 3
CL_STEPS_BEFORE = 10
BAR_GOALS = 32
BAR_STEPS = 300
# Gradient planners: scripts/eval_ilqr.py's configuration (:36-99, as
# EVAL_ILQR_r05.json records it): H = 32, 4 iterations, 6 line-search
# steps, ctrl_cost 1e-3, reg_init 1e-4, 3 plan substeps, refactor every 4
# (the ILQRConfig defaults otherwise: 4 Newton / 6 line-search
# iterations, contact budget 16/16, implicit damping, no
# self-collision), the keep-in-hand shaping as a cost; ILQR_GOALS goals
# in one batch.  Phase ilqr_k3 runs it at refactor every 1 (K3), cut to
# H = 4, 1 iteration, 2 goals; phase sqp with SQP_ITERATIONS iteration(s).
ILQR = dict(horizon=32, iterations=4, line_search_steps=6, ctrl_cost=1e-3,
            reg_init=1e-4, plan_substeps=3, solver_refactor_every=4)
ILQR_GOALS = 8
ILQR_K3 = dict(horizon=4, iterations=1, solver_refactor_every=1)
ILQR_K3_GOALS = 2
SQP_ITERATIONS = 1
# The hybrid control step: scripts/eval_ilqr.py's predictive-sampling
# configuration (:91-99) and one iLQR iteration, HYBRID_GOALS goals for
# HYBRID_STEPS control steps.
HYBRID_PS = dict(horizon=10, num_samples=256, num_knots=4, iterations=2,
                 noise_decay=0.5, failure_penalty=30.0, solver_iterations=4,
                 ls_iterations=6, solver_refactor_every=2, plan_substeps=3)
HYBRID_GOALS = 4
HYBRID_STEPS = 1
# The linearization hold (PERF.md §2): fx, fu, cx, cu in each (goal 0, t)
# block of the first iteration's nominal rollout (H = 32 states) against
# the CPU float64 port at the same (x, u), relative to the block's
# max-abs.  A block is held where both precisions resolve it: the float64
# port's Jacobian moves by at most 1e-9 of its max-abs under the relative
# changes of the states in LIN_NUDGES_F64 (tests/torch_planners.py's
# rule), and the CPU float32 port's by at most LIN_RESOLVED under
# LIN_NUDGES_F32 (float32's own rounding).  In the other blocks the JAX
# package's float32 linearization parts from its float64 one as far as
# the port's does (tests/test_torch_ilqr_float32.py): they are read and
# must be finite.  Limits per quantity: the smallest 1, 2 or 5 x 10^k at
# least 3x the largest sound reading in a held block (the card, the CPU
# float32 port), kept under the faulted readings (TF32 products, K2's
# tangent in bfloat16).  Read on the H100 in the held blocks t = 4-6
# (PERF.md §2): sound fx 3.18e-4, fu 7.82e-5, cx 5.30e-7, cu 6.82e-8;
# TF32 fx 1.20, fu 0.807; bfloat16 fx 1.64e-2, fu 8.21e-3 (neither fault
# moves cx or cu).  LIN_WITNESS: the goals whose first backward pass is
# also run on the CPU float64 port (NaN gains).
LIN_NUDGES_F64 = (4e-15, -4e-15)
LIN_NUDGES_F32 = (1.2e-7, -1.2e-7)
LIN_RESOLVED = 1e-3
LIN_LIMITS = dict(fx=1e-3, fu=5e-4, cx=2e-6, cu=5e-7)
LIN_WITNESS = (0, ILQR_GOALS - 1)

# Reach and juggle phases: manipulation.load of each, reset of B_EPISODES
# episodes and ENV_STEPS steps, the first ENV_CHECKED held against the CPU.
TASK_PHASES = (('reach', 'state_dense'), ('juggle', 'state_sparse'))
# Their holds against the CPU float64 port (PERF.md §2), set from
# `--hold-readings 8` on the H100: per quantity, the smallest of 1, 2 or
# 5 x 10^k at least 3x the largest sound reading (card or CPU float32 over
# 8 seeds x 8 episodes).  Juggle's limits are under every faulted reading
# (TF32 products, K3 in bfloat16); on reach those faults move qpos, qvel
# and observations no further than float32 does on some seeds, and the
# goals (fingertips and joints after 2 settle steps) and reward are what
# catch them.  `goal` is 0 for juggle, which has none; `rel` is the goal
# distance and reward relative to their max-abs, `obs` the observations.
# Reorient's (the environment phase) are PERF.md §2's from PR 7; its goals
# are drawn, not settled.
TASK_LIMITS = {'reorient': dict(qpos=1e-4, qvel=1e-2, goal=1e-6, rel=1e-4,
                                obs=1e-4),
               'reach': dict(qpos=5e-4, qvel=2e-2, goal=5e-5, rel=5e-5,
                             obs=2e-3),
               'juggle': dict(qpos=5e-3, qvel=0.5, goal=0.0, rel=1e-4,
                              obs=2e-2)}
# The reach oracle (examples/oracle_reach.py): ORACLE_EPISODES sparse-reward
# episodes, at most ORACLE_STEPS control steps each.
ORACLE_EPISODES = 8
ORACLE_STEPS = 200
# The suite (scripts/bench_suite.py; BASELINE.json configs[4]: 4096
# scenarios x all tasks): SUITE_WARMUP steps, then SUITE_STEPS timed steps,
# cut from the reference's 100 (which took 166 s of the script's wall for
# all four on the card; 50 took 76 s).  25 keeps the script inside its
# 1200 s on a host ~1.45x slower in every host-bound phase, where 50 took
# 1168 s.
B_SUITE = 4096
SUITE_WARMUP = 2
SUITE_STEPS = 25
SUITE_REFERENCE_STEPS = 100

# The ik phase: examples/inverse_kinematics.py's feasible targets (the
# fingertips' FK at joint positions uniform in 0.8 of the ranges), all
# sets x attempts rows in one solve_batch; tests/test_ik.py's bars.
IK_SETS = 64
IK_ATTEMPTS = 30
IK_MAX_STEPS = 100
IK_TOL = 1e-3
IK_TIMED = 3
IK_SOLVED_MIN = 52           # 4 in 5 of IK_SETS, rounded up
IK_HELD_SETS = 8             # sets whose first q-dot is held (x attempts)
# The first iteration's q-dot against the CPU float64 port, relative to
# its max-abs: PERF.md section 2's rule over the readings of
# `--hold-readings 8` (sound: the card 2.19e-5-4.14e-5, the CPU float32
# port 1.82e-5-4.82e-5; 3 x 4.82e-5 -> 2e-4).
IK_QDOT_LIMIT = 2e-4

# The wrappers phase: reorient at B_EPISODES with the hand effector in
# SmoothAction(PreviousAction(.)), ENV_STEPS steps, WRAP_RESET_ROWS reset
# before the last step.
WRAP_ALPHA = 0.3
WRAP_RESET_ROWS = (1, 5)

# H100 SXM peaks (NVIDIA data sheet): HBM rate and FP32 non-tensor rate.
# Sharded planner: sharded_solve_batch at the bench configuration
# on a world of one NCCL rank, a warm-up and SHARDED_TIMED timed calls,
# each against solve_batch from the same generator seed; one MPPI
# sharded_solve (temperature MPPI_TEMPERATURE) against solve.
SHARDED_TIMED = 2
MPPI_TEMPERATURE = 0.5
GATHER_REPS = 100
# MJCF round trip: each hand and the reorient arena exported,
# reparsed and compiled onto the card; MJCF_BATCH rows stepped
# MJCF_STEPS environment steps on the original and the reparsed model.
# The export prints 12 significant digits; the compile casts the float64
# values to float32, so a reparsed array may differ from the original's
# by one float32 rounding (2^-23 relative) and by no more.
MJCF_BATCH = 256
MJCF_STEPS = 10
MJCF_ARRAY_RTOL = 2.0 ** -23
# Pair pruning: pair_distance_stats of the reorient arena on the
# card in float32 against the CPU float64 port, PRUNE_SAMPLES draws.
PRUNE_SAMPLES = 256
PRUNE_NEAR = 0.004
# The statistics are held within PRUNE_RANGE of contact, where the
# classification's thresholds (PRUNE_NEAR, 0, -3 mm) lie; beyond it the
# narrow phase's choice among a pair's candidate points may flip at the
# rounding level (a box-capsule pair at 7 cm parted by 1.7 mm between the
# CPU float32 and float64 ports), which no classification reads.
PRUNE_RANGE = 0.02
# Limits, by PERF.md §2's rule (the smallest 1, 2 or 5 x 10^k at least 3x
# the largest sound reading; PERF.md §2 has the readings, taken on an
# "NVIDIA H100 80GB HBM3, 700.00 W" and the CPU float32 port).  The reparsed
# models' float32 arrays are the originals' bit for bit, and so were the
# states after MJCF_STEPS steps on every model: every sound reading was 0,
# so the hold is bit-equality (the 6-digit export moved qvel by 5.8e-4 to
# 113 on three of the four models).  Pruning against the CPU float64 port,
# in metres: statistics 9.09e-8, sampled distances 1.18e-6 on the card and
# the CPU float32 port alike (bfloat16 draws: 2.8e-4 and 6.7e-2).
MJCF_LIMITS = dict(qpos=0.0, qvel=0.0)
PRUNE_LIMITS = dict(stats=5e-7, sample=5e-6)
# Rendering: reach VISION_ONLY at RENDER_B, reset and RENDER_STEPS steps
# (the card's side without MuJoCo: reach state_dense and the state's copy
# to the host); the throughput over VISION_STEPS reorient steps.  The
# pixel hold against the CPU float64 port reads the share of pixels whose
# largest channel differs by more than PIXEL_LEVEL levels and the mean
# absolute difference; the fault moves every hinge by HINGE_NUDGE rad.
RENDER_B = 8
RENDER_STEPS = 3
VISION_STEPS = 20
PIXEL_LEVEL = 16
HINGE_NUDGE = 0.01
# PIXEL_LIMITS by PERF.md §2's rule from phase_render_readings on 8
# seeds, run on the CPU with the card's device mapped to it (the card
# host has no MuJoCo): the CPU float32 port against float64, share
# 1.77e-5, mean 1.03e-3 levels at most; hinges moved by 0.01 rad 3.30e-2
# and 1.53 at least.
PIXEL_LIMITS = dict(share_over_level=1e-4, mean_abs=5e-3)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12

# name (launch counter), TPU kernel it replaces, source, path that runs it.
_LP = 'dexterity_tpu/physics/linalg_pallas.py'
_TP = 'dexterity_tpu/physics/tree_pallas.py'
_CHOL = 'dexterity_tpu_torch/csrc/cholesky.cu'
_REGS = 'dexterity_tpu_torch/csrc/cholesky_regs.cu'
_WIDE = 'dexterity_tpu_torch/csrc/cholesky_wide.cu'
# The H100's L2 cache (50 MB).
L2_BYTES = 50 * 2 ** 20
_TREE = 'dexterity_tpu_torch/csrc/tree_sweep.cu'
KERNELS = [
    ('cholesky_solve_factor', f'{_LP}:135', _REGS, 'main_path'),
    ('cholesky_resolve_const', f'{_LP}:291', _REGS, 'main_path'),
    ('cholesky_solve', f'{_LP}:74', _REGS, 'environment'),
    ('cholesky_factor', f'{_LP}:262', _REGS, 'entry:cholesky_factor'),
    ('tree_sweep_fk', f'{_TP}:239', _TREE, 'entry:build_tree_sweep'),
    ('tree_sweep_dyn', f'{_TP}:449', _TREE, 'entry:build_tree_sweep'),
]


def emit(obj):
  print(json.dumps(obj), flush=True)


def check(cond, what):
  if not cond:
    raise AssertionError(what)


def tf32(torch, fn):
  """fn() with every float32 matrix product in TF32 (a fault the holds
  read beside their sound runs)."""
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    return fn()
  finally:
    torch.backends.cuda.matmul.allow_tf32 = False


def reset_counts(pkg):
  pkg['linalg_cuda'].reset_launches()
  pkg['tree_cuda'].reset_launches()


def read_counts(pkg):
  return {**pkg['linalg_cuda'].launches, **pkg['tree_cuda'].launches}


def launch_counters(pkg):
  """The wrappers' launch counters, which _device_profile and _busy_window
  hold the profiler's kernel records against."""
  return pkg['linalg_cuda'].launches, pkg['tree_cuda'].launches


def nvidia_smi_line():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
  return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ''


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def start_states(torch, types, model, batch, gen, band=0.3):
  """Seeded reorient starts: hand hinge joints within a band of their
  ranges around 0 (_hinge_starts), the cube at the spawn-workspace centre
  (reorient.py's workspace) with a uniformly random orientation."""
  qpos = _hinge_starts(torch, types, model, batch, gen, band)
  free = [j for j in range(model.njnt)
          if model.jnt_type[j] == int(types.JointType.FREE)][0]
  qa = model.jnt_qposadr[free]
  qpos[:, qa:qa + 3] = torch.tensor([0.0, -0.13, 0.16], dtype=torch.float64)
  q = torch.randn(batch, 4, generator=gen, dtype=torch.float64)
  qpos[:, qa + 3:qa + 7] = q / q.norm(dim=1, keepdim=True)
  return qpos


def _hinge_starts(torch, types, model, batch, gen, band=0.3):
  """Every limited hinge joint within a band of its range around 0 (0
  clipped into the range); other joints at qpos0."""
  qpos = model.qpos0.double().cpu().expand(batch, model.nq).clone()
  for j in range(model.njnt):
    if model.jnt_type[j] == int(types.JointType.HINGE) and \
        model.jnt_limited[j]:
      lo, hi = model.jnt_range[j].double().cpu().tolist()
      mid = min(max(0.0, lo), hi)
      u = torch.rand(batch, generator=gen, dtype=torch.float64) - 0.5
      qpos[:, model.jnt_qposadr[j]] = (mid + band * (hi - lo) * u).clamp(lo,
                                                                         hi)
  return qpos


def controls(torch, model, steps, batch, gen, band=0.3):
  """Seeded controls inside actuator_ctrlrange (a band around its middle)."""
  lo = model.actuator_ctrlrange[:, 0].double().cpu()
  hi = model.actuator_ctrlrange[:, 1].double().cpu()
  u = torch.rand(steps, batch, model.nu, generator=gen, dtype=torch.float64)
  return lo + (hi - lo) * (0.5 + band * (u - 0.5))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_probe(torch, pkg, smi):
  cuda_build = pkg['cuda_build']
  t0 = time.perf_counter()
  cuda_build.build_all()
  pkg['linalg_cuda'].build()
  pkg['tree_cuda'].build()
  build_s = time.perf_counter() - t0
  logs = cuda_build.build_info.get('log', {})
  ptxas = {name: [ln.strip() for ln in log.splitlines()
                  if 'registers' in ln or 'spill' in ln][:12]
           for name, log in logs.items()}
  # The register design's eight kernels and the wide design's sixteen
  # (K1-K4 at 64 rows and at 80, in float32 and float64 each): none may
  # spill.
  regs = _ptxas_entries(logs.get('cholesky_regs', ''), 'cholesky_regs_')
  check(len(regs) == 8, f'register-design kernels in the ptxas log: {regs}')
  wide = _ptxas_entries(logs.get('cholesky_wide', ''), 'cholesky_wide_')
  check(len(wide) == 16, f'wide-design kernels in the ptxas log: {wide}')
  for label, v in (*regs.items(), *wide.items()):
    check(v.get('spill_stores') == 0 and v.get('spill_loads') == 0,
          f'{label} spills: {v}')
  tree = _ptxas_entries(logs.get('tree_sweep', ''), 'tree_')
  emit({'phase': 'probe', 'torch': torch.__version__,
        'cuda': torch.version.cuda, 'python': sys.version.split()[0],
        'device': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(), 'nvidia_smi': smi,
        'kernel_build_s': build_s,
        'nvcc_parallel_s': cuda_build.build_info.get('seconds'),
        'sources': sorted(cuda_build.sources()), 'ptxas': ptxas,
        'register_design_ptxas': regs, 'wide_design_ptxas': wide,
        'tree_sweep_ptxas': tree})


# The register designs' solve_factor kernels by their template flags
# (kEmitFactor, kSolve), in cholesky_regs.cu and cholesky_wide.cu alike.
_REG_KINDS = {('1', '1'): 'solve_factor', ('0', '1'): 'solve',
              ('1', '0'): 'factor'}


def _ptxas_entries(log, prefix):
  """Registers and spill bytes of each kernel whose mangled name holds
  `prefix`, from nvcc's `-Xptxas -v` log, labelled kernel_type: the
  register designs' solve_factor kernels by their flags (K1 solve_factor,
  K3 solve, K4 factor), a wide kernel's layout of other than 64 rows by
  its row count (`factor_n80_f32`).  Names that do not parse as a
  kernel's are left out."""
  out, cur = {}, None
  for ln in log.splitlines():
    m = re.search(r"(?:Compiling entry function|Function properties for) "
                  r"'?([\w$]+)'?", ln)
    if m:
      # The kernel's own name follows its length; the anonymous
      # namespace's name (which holds the file name) does not.
      t = re.search(r'\d' + prefix + r'([a-z_]+?)I([fd])((?:L[bi]\d+E)*)E',
                    m.group(1))
      cur = None
      if t:
        kind, args = t.group(1), t.group(3)
        if kind == 'solve_factor':
          kind = _REG_KINDS[tuple(re.findall(r'Lb(\d)E', args))]
        rows = re.findall(r'Li(\d+)E', args)
        if rows and rows[0] != '64':
          kind = f'{kind}_n{rows[0]}'
        cur = f'{kind}_{"f32" if t.group(2) == "f" else "f64"}'
        out.setdefault(cur, {})
      continue
    if cur is None:
      continue
    m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', ln)
    if m:
      out[cur].update(spill_stores=int(m.group(1)),
                      spill_loads=int(m.group(2)))
    m = re.search(r'Used (\d+) registers', ln)
    if m:
      out[cur]['registers'] = int(m.group(1))
  return out


def run_rollouts(torch, step, model, n, data, ctrls):
  """H control steps of step_n_b; returns the final Data and the state
  after the first control step."""
  first = None
  for t in range(ctrls.shape[0]):
    data = data.replace(ctrl=ctrls[t])
    data = step.step_n_b(model, data, n, refresh='none', midphase='per_call',
                         carry='minimal')
    if t == 0:
      first = data
  return data, first


def phase_rollouts(torch, pkg):
  types, step, linalg_cuda, primitives, common, manip = (
      pkg['types'], pkg['step'], pkg['linalg_cuda'], pkg['primitives'],
      pkg['common'], pkg['manipulation'])
  task = manip.build_task('reorient', 'state_dense')
  model, n = common.reduced_planning_model(task, device='cuda', **PLAN)
  check(n == 3, f'plan substeps {n}')
  gen = torch.Generator().manual_seed(SEED)
  qpos0 = start_states(torch, types, model, B_PLAN, gen)
  ctrls = controls(torch, model, H, B_PLAN, gen)
  dev = model.device

  def fresh():
    return types.make_data(model, (B_PLAN,)).replace(
        qpos=qpos0.to(dev, model.dtype))

  ctrl_dev = ctrls.to(dev, model.dtype)
  # Warm-up (first-use caches, allocator): one control step, not counted.
  run_rollouts(torch, step, model, n, fresh(), ctrl_dev[:1])
  torch.cuda.synchronize()

  # Capture the first refactor Hessian of the counted run for phase 3.
  captured = {}
  real_k1 = linalg_cuda.cholesky_solve_factor

  def capture_k1(h, g):
    if 'h' not in captured:
      captured['h'], captured['g'] = h.detach().clone(), g.detach().clone()
    return real_k1(h, g)

  data0 = fresh()
  torch.cuda.synchronize()
  linalg_cuda.cholesky_solve_factor = capture_k1
  try:
    reset_counts(pkg)
    t0 = time.perf_counter()
    final, first = run_rollouts(torch, step, model, n, data0, ctrl_dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(pkg)
  finally:
    linalg_cuda.cholesky_solve_factor = real_k1

  check(launches['cholesky_solve_factor'] == H * n * 2,
        f'K1 launches {launches}')
  check(launches['cholesky_resolve_const'] == H * n * 2,
        f'K2 launches {launches}')
  check(launches['cholesky_solve'] == 0 and launches['cholesky_factor'] == 0
        and launches['tree_sweep_fk'] == 0, f'launches {launches}')
  finite = bool(torch.isfinite(final.qpos).all() and
                torch.isfinite(final.qvel).all())
  check(finite, 'non-finite state after the rollouts')

  # Contact path: the port's own planes + narrow phase on the final states.
  pre = step._planes_b(model, final)
  groups = primitives.collide_group_planes(
      model, tuple(step._major(p) for p in pre['gpos']),
      tuple(step._major(p) for p in pre['gmat']), model.dtype)
  score = torch.cat([g['dist'] - g['margin'] for g in groups], -1)
  in_contact = (score < 0).any(-1).float().mean().item()
  check(in_contact > 0.5, f'only {in_contact:.3f} of rollouts in contact')

  # First control step of 8 rollouts against the port on the CPU, float64.
  # Tolerance: float32 against float64 over 3 substeps of contact dynamics.
  # The Newton step carries float32 rounding times the Hessian's condition
  # (~1e5 on this path), ~6e-3 relative in qacc.  The control step is
  # 25 ms, so each of the 3 planning substeps is h = 8.33 ms: qvel to 1e-2
  # and qpos to 1e-4.
  cpu_model, _ = common.reduced_planning_model(
      task, device='cpu', dtype=torch.float64, **PLAN)
  k = 8
  d_cpu = types.make_data(cpu_model, (k,)).replace(qpos=qpos0[:k].clone())
  ref, _ = run_rollouts(torch, step, cpu_model, n, d_cpu, ctrls[:1, :k])
  err_q = (first.qpos[:k].double().cpu() - ref.qpos).abs().max().item()
  err_v = (first.qvel[:k].double().cpu() - ref.qvel).abs().max().item()
  check(err_q < 1e-4 and err_v < 1e-2,
        f'card vs CPU float64: qpos {err_q}, qvel {err_v}')

  emit({'phase': 'rollouts', 'model': 'reorient.state_dense planning',
        'batch': B_PLAN, 'control_steps': H, 'substeps': n,
        'launches': launches, 'finite': finite,
        'rollouts_in_contact': in_contact,
        'cpu_f64_max_err': {'qpos': err_q, 'qvel': err_v},
        'wall_s_per_rollout_batch': wall,
        'rollout_substeps_per_s': B_PLAN * H * n / wall,
        'npair': model.npair, 'nv': model.nv})
  return dict(launches=launches, hessians=captured, model=model, task=task,
              first=first)


def phase_env(torch, pkg, task):
  types, step = pkg['types'], pkg['step']
  model = task.compile(device='cuda')
  n = task.n_substeps
  check(n == 5 and model.opt.solver_refactor_every == 1 and
        not model.opt.implicit_damping and model.opt.contact_top_k == 64 and
        model.opt.midphase_cap == 64, 'environment model options')
  gen = torch.Generator().manual_seed(SEED + 1)
  qpos = start_states(torch, types, model, B_ENV, gen)
  ctrl = controls(torch, model, 1, B_ENV, gen)[0]
  data = types.make_data(model, (B_ENV,)).replace(
      qpos=qpos.to(model.device, model.dtype),
      ctrl=ctrl.to(model.device, model.dtype))
  step.step_n_b(model, data, 1, refresh='none')        # warm-up
  torch.cuda.synchronize()
  reset_counts(pkg)
  t0 = time.perf_counter()
  out = step.step_n_b(model, data, n, refresh='none')
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = read_counts(pkg)
  expect = n * (model.opt.solver_iterations + 1)
  check(launches['cholesky_solve'] == expect, f'K3 launches {launches}')
  check(launches['cholesky_solve_factor'] == 0 and
        launches['cholesky_resolve_const'] == 0, f'launches {launches}')
  finite = bool(torch.isfinite(out.qpos).all() and
                torch.isfinite(out.qvel).all())
  check(finite, 'non-finite state after the environment step')
  # Device time of one control step (summed kernel durations) and K3's
  # share of it, with the design K3 ran.
  step_ms, by_kernel = _device_profile(
      torch, lambda: step.step_n_b(model, data, n, refresh='none'), 1,
      launch_counters(pkg))
  k3 = {k: v for k, v in by_kernel.items() if 'cholesky' in k}
  k3_ms = sum(k3.values())
  check(_ran_design(k3) == 'registers', f'K3 ran {list(k3)}')
  emit({'phase': 'environment_model', 'batch': B_ENV, 'substeps': n,
        'launches': launches, 'finite': finite, 'wall_s_per_control_step':
        wall, 'npair': model.npair, 'device_ms_per_control_step': step_ms,
        'k3_device_ms': k3_ms, 'k3_share': k3_ms / step_ms,
        'k3_design': _ran_design(k3)})
  return launches


# K3's calling functions on the environment's path: the Newton iteration
# (forward and every substep) and the Euler damping solve (every substep).
_K3_FORWARD = (('newton_iter', 'newton_hessian'),)
_K3_STEP = _K3_FORWARD + (('euler_from_smooth', 'euler_matrix'),)


def _k3_holds(torch, lc, fn, rows, nv, label, callers, out):
  """Runs fn with K3's inputs captured (outside any counted or timed
  call) and holds K3 against its plain version and float64 on the first
  input from each of `callers` ((calling function, name) pairs), which
  must be (rows, nv, nv); the errors go into `out`.  Returns fn's
  result and the captured inputs (keyed as _capture_first keys them)."""
  res, seen = _capture_first(lc, ('cholesky_solve',), fn)
  for caller, what in callers:
    h, g = seen[('cholesky_solve', caller)]
    check(h.shape == (rows, nv, nv) and g.shape == (rows, nv),
          f'K3 {what} {label}: {tuple(h.shape)}')
    for key, v in _vs_plain(torch, lc, 'cholesky_solve', h, g,
                            f'{label} {what}').items():
      out[f'{label}_{what}{key}'] = v
  return res, seen


def _k12_holds(torch, lc, fn, rows, nv, label):
  """Runs fn with K1's and K2's inputs captured and holds both against
  their plain versions and float64 on the planner's own inputs, at
  (rows, nv, nv): the first refactor Hessian (K1, and K2 on its plain
  factor) and the first stale-factor resolve (K2 on the factor K1 gave;
  the matrix it factors is L L^T).  Returns the errors."""
  _, seen = _capture_first(
      lc, ('cholesky_solve_factor', 'cholesky_resolve_const'), fn)
  h, g = seen[('cholesky_solve_factor', 'newton_iter')]
  fac, g2 = seen[('cholesky_resolve_const', 'newton_iter')]
  check(h.shape == fac.shape == (rows, nv, nv) and
        g.shape == g2.shape == (rows, nv),
        f'{label} K1/K2 inputs {tuple(h.shape)}, {tuple(fac.shape)}')
  f64 = fac.double()
  ll = (torch.tril(f64, -1)
        + torch.diag_embed(1 / torch.diagonal(f64, dim1=-2, dim2=-1)))
  out = {}
  for name, args, kw, what in (
      ('cholesky_solve_factor', (h, g), {}, 'hessian'),
      ('cholesky_resolve_const', (h, g), {}, 'hessian'),
      ('cholesky_resolve_const', (ll @ ll.mT, g2), {'fac': fac},
       'path_factor')):
    for key, v in _vs_plain(torch, lc, name, *args, f'{label} {what}',
                            **kw).items():
      out[f'{name}_{what}{key}'] = v
  return out


def _environment_at_b_env(torch, pkg, env, gen):
  """GoalEnvironment.reset and .step of the reorient environment at B_ENV
  episodes, and of one episode without a batch axis: K3's launches (8 in
  reset's forward, 45 in a step), the first 8 episodes' step held against
  the same step on the CPU in float64 from the card's reset state, the
  unbatched step against row 0, K3 held against its plain version and
  float64 on the step's own Newton Hessian and Euler matrix at (B_ENV,
  nv, nv) and (1, nv, nv) (reset's own at (1, nv, nv) in the caller),
  and the device time of reset's forward, the step and its refresh."""
  types, step, structs = pkg['types'], pkg['step'], pkg['structs']
  lc = pkg['linalg_cuda']
  model, task = env.model, env.task
  n, iters, nv = task.n_substeps, model.opt.solver_iterations, model.nv
  dev, dtype = model.device, model.dtype
  agen = torch.Generator().manual_seed(SEED + 8)
  spec = env.action_spec()
  lo = torch.as_tensor(spec.minimum, dtype=torch.float64)
  hi = torch.as_tensor(spec.maximum, dtype=torch.float64)
  act = lo + (hi - lo) * torch.rand(B_ENV, spec.shape[0], generator=agen,
                                    dtype=torch.float64)

  def counted(fn):
    reset_counts(pkg)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(pkg), time.perf_counter() - t0

  (state, _), reset_launches, reset_wall = counted(lambda: env.reset(
      torch.Generator().manual_seed(SEED + 3), (B_ENV,)))
  (out, _), step_launches, step_wall = counted(lambda: env.step(
      state, act.to(dev, dtype), gen))
  check(reset_launches['cholesky_solve'] == iters and
        sum(reset_launches.values()) == iters,
        f'reset launches at B={B_ENV}: {reset_launches}')
  check(step_launches['cholesky_solve'] == n * (iters + 1) and
        sum(step_launches.values()) == n * (iters + 1),
        f'step launches at B={B_ENV}: {step_launches}')
  for what, t in (('qpos', out.data.qpos), ('qvel', out.data.qvel),
                  ('xpos', out.data.xpos), ('geom_xpos', out.data.geom_xpos),
                  ('cvel', out.data.cvel), ('qacc', state.data.qacc)):
    check(bool(torch.isfinite(t).all()), f'non-finite {what}')
  in_contact = (out.data.contact.dist < 0).any(-1).float().mean().item()

  # The first 8 episodes' step against the CPU float64 port from the card's
  # reset state, at PERF.md §2's limits: qpos 1e-4, qvel 1e-2, the
  # refreshed frames 1e-4 of their max-abs.
  k = 8
  cpu = pkg['manipulation'].load('reorient', 'state_dense', device='cpu',
                                 dtype=torch.float64)
  start = structs.tree_map(lambda x: _to_cpu64(torch, x[:k]), state)
  ref, _ = cpu.step(start, act[:k], torch.Generator())
  errs = _state_errs(torch, out.data, ref.data, k)
  check(errs['qpos'] < 1e-4 and errs['qvel'] < 1e-2 and
        errs['xpos_rel'] < 1e-4 and errs['geom_xpos_rel'] < 1e-4,
        f'env step at B={B_ENV} vs CPU float64: {errs}')

  # Episode 0 alone, without a batch axis, against row 0.
  one = structs.tree_map(lambda x: x[0], state)
  (one_out, _), one_launches, _ = counted(lambda: env.step(
      one, act[0].to(dev, dtype), gen))
  check(one_out.data.qpos.shape == (model.nq,) and
        one_launches['cholesky_solve'] == n * (iters + 1),
        f'unbatched step: {tuple(one_out.data.qpos.shape)}, {one_launches}')
  one_errs = _state_errs(
      torch, types.map_data(out.data, lambda x: x[:1]),
      types.map_data(one_out.data, lambda x: x[None].double().cpu()), 1)
  check(one_errs['qpos'] < 1e-4 and one_errs['qvel'] < 1e-2 and
        one_errs['xpos_rel'] < 1e-4, f'unbatched vs row 0: {one_errs}')

  # K3 on the step's own inputs (the first Newton Hessian and the first
  # Euler matrix M + hD), for the batch and for one episode.
  k3_checks = {}
  _k3_holds(torch, lc, lambda: env.step(state, act.to(dev, dtype), gen),
            B_ENV, nv, 'batched', _K3_STEP, k3_checks)
  _k3_holds(torch, lc, lambda: env.step(one, act[0].to(dev, dtype), gen),
            1, nv, 'unbatched', _K3_STEP, k3_checks)

  # Device time: reset's forward, the step, and its refresh alone (step_n
  # with no substep runs only the refresh).
  fwd_ms, _ = _device_profile(torch, lambda: step.forward(model, state.data),
                              1, launch_counters(pkg))
  step_ms, by_kernel = _device_profile(
      torch, lambda: env.step(state, act.to(dev, dtype), gen), 1,
      launch_counters(pkg))
  refresh_ms, _ = _device_profile(
      torch, lambda: step.step_n(model, out.data, 0, refresh='full'), 1,
      launch_counters(pkg))
  k3 = {key: v for key, v in by_kernel.items() if 'cholesky' in key}
  k3_ms = sum(k3.values())
  check(_ran_design(k3) == 'registers', f'K3 ran {list(k3)}')
  window = _busy_window(torch, lambda: env.step(state, act.to(dev, dtype),
                                                gen), launch_counters(pkg))
  return {'batch': B_ENV,
          'launches': {'reset': reset_launches, 'step': step_launches,
                       'unbatched_step': one_launches},
          'wall_s': {'reset': reset_wall, 'step': step_wall},
          'envs_in_contact': in_contact,
          'cpu_f64_max_err': errs, 'unbatched_vs_row0_max_err': one_errs,
          'k3_vs_plain': k3_checks,
          'device_ms': {'forward': fwd_ms, 'step': step_ms,
                        'refresh_full': refresh_ms},
          'step_window': window, 'k3_device_ms': k3_ms,
          'k3_share': k3_ms / step_ms, 'k3_design': _ran_design(k3)}


def _to_cpu64(torch, x):
  """A card tensor on the CPU, floats in float64."""
  return x.to('cpu', torch.float64) if x.is_floating_point() else x.cpu()


@contextlib.contextmanager
def _picks(hands):
  """While the block runs, keeps the try that each rejection search
  (hands.first_free_chunked) picks, in call order, on the CPU."""
  real, seen = hands.first_free_chunked, []

  def wrapper(*args, **kwargs):
    out = real(*args, **kwargs)
    seen.append(out[2].cpu())
    return out

  hands.first_free_chunked = wrapper
  try:
    yield seen
  finally:
    hands.first_free_chunked = real


def _max_rel(torch, card, ref):
  """Max-abs error of a card tensor against a CPU float64 one, relative
  to the reference's max-abs, at least 1 (a value that is zero in
  float64, such as a cube's spin in free fall, carries float32 noise)."""
  err = (_to_cpu64(torch, card) - ref).abs().max().item()
  return err / max(ref.abs().max().item(), 1.0)


def phase_environment(torch, pkg):
  """manipulation.load('reorient', 'state_dense') on the card: reset of
  B_EPISODES episodes from a seeded CPU generator, then ENV_STEPS control
  steps with seeded actions in the spec's range.  K3's launches are
  checked exactly (8 in reset's forward, 45 per step); the first
  ENV_CHECKED episodes are held against the same calls on the CPU in
  float64, from the same seed."""
  manip, structs = pkg['manipulation'], pkg['structs']
  env = manip.load('reorient', 'state_dense')
  model, task = env.model, env.task
  dev, dtype = model.device, model.dtype
  check(dev.type == 'cuda' and dtype == torch.float32, 'environment device')
  spec = env.action_spec()
  lo = torch.as_tensor(spec.minimum, dtype=torch.float64)
  hi = torch.as_tensor(spec.maximum, dtype=torch.float64)
  agen = torch.Generator().manual_seed(SEED + 7)
  acts = lo + (hi - lo) * torch.rand(ENV_STEPS, B_EPISODES, spec.shape[0],
                                     generator=agen, dtype=torch.float64)
  gen = torch.Generator()
  # Warm-up (first-use caches): a reset and a step of two episodes.
  warm, _ = env.reset(torch.Generator().manual_seed(SEED + 99), (2,))
  env.step(warm, acts[0, :2].to(dev, dtype), gen)
  torch.cuda.synchronize()

  reset_counts(pkg)
  t0 = time.perf_counter()
  with _picks(pkg['hands']) as picks:
    state, ts = env.reset(torch.Generator().manual_seed(SEED), (B_EPISODES,))
  torch.cuda.synchronize()
  reset_wall = time.perf_counter() - t0
  reset_launches = read_counts(pkg)
  check(reset_launches['cholesky_solve'] == model.opt.solver_iterations == 8
        and sum(reset_launches.values()) == 8,
        f'reset launches {reset_launches}')
  card_tries = picks[0] + 1
  states, steps_ts, step_walls, step_launches = [state], [ts], [], []
  for i in range(ENV_STEPS):
    reset_counts(pkg)
    t0 = time.perf_counter()
    state, ts = env.step(state, acts[i].to(dev, dtype), gen)
    torch.cuda.synchronize()
    step_walls.append(time.perf_counter() - t0)
    step_launches.append(read_counts(pkg))
    check(step_launches[-1]['cholesky_solve'] == 45 and
          sum(step_launches[-1].values()) == 45,
          f'step launches {step_launches[-1]}')
    states.append(state)
    steps_ts.append(ts)
  for st, t in zip(states, steps_ts):
    for what, x in (('qpos', st.data.qpos), ('qvel', st.data.qvel),
                    ('reward', t.reward), *t.observation.items()):
      check(bool(torch.isfinite(x).all()), f'non-finite {what}')
  launches = {k: reset_launches[k] + sum(sl[k] for sl in step_launches)
              for k in reset_launches}
  # Device time and idle share of one control step (not counted).
  window = _busy_window(torch, lambda: env.step(
      states[0], acts[0].to(dev, dtype), gen), launch_counters(pkg))

  # K3 on this path's own inputs against its plain version and float64,
  # outside the counted and timed calls: the first Newton Hessian of
  # reset's forward, and the first Newton Hessian and Euler matrix M + hD
  # of a step, at (B_EPISODES, nv, nv) and for one episode without a batch
  # axis (1, nv, nv).
  lc, nv = pkg['linalg_cuda'], model.nv
  k3_checks = {}
  _k3_holds(torch, lc, lambda: env.reset(
      torch.Generator().manual_seed(SEED), (B_EPISODES,)), B_EPISODES, nv,
            'reset', _K3_FORWARD, k3_checks)
  _k3_holds(torch, lc, lambda: env.step(states[0], acts[0].to(dev, dtype),
                                        gen), B_EPISODES, nv, 'step',
            _K3_STEP, k3_checks)
  (one, _), _ = _k3_holds(torch, lc, lambda: env.reset(
      torch.Generator().manual_seed(SEED), ()), 1, nv, 'unbatched_reset',
                     _K3_FORWARD, k3_checks)
  _k3_holds(torch, lc, lambda: env.step(one, acts[0, 0].to(dev, dtype), gen),
            1, nv, 'unbatched_step', _K3_STEP, k3_checks)
  at_b_env = _environment_at_b_env(torch, pkg, env, gen)
  k3_checks.update({f'b{B_ENV}_{key}': v
                    for key, v in at_b_env.pop('k3_vs_plain').items()})

  # The same calls on the CPU in float64, from the same seed; the first
  # ENV_CHECKED episodes compared.  An episode whose placement picked
  # another try on the card (a contact at the margin in float32) is
  # reported and left out.
  cpu = manip.load('reorient', 'state_dense', device='cpu',
                   dtype=torch.float64)
  ref = _episodes(torch, pkg, cpu, SEED, acts)
  k = ENV_CHECKED
  card = _head(structs, states, steps_ts, picks)
  other_try = _other_picks(card, ref)
  rows = torch.tensor([i for i in range(k) if i not in other_try])
  check(len(rows) >= k // 2, f'placements differ in {other_try}')
  errs = _episode_errs(torch, pkg, card, ref, rows)
  for i, e in enumerate(errs):
    check(not _over(e, TASK_LIMITS['reorient']),
          f'environment {i} vs CPU float64: {e}')
  emit({'phase': 'environment', 'batch': B_EPISODES, 'steps': ENV_STEPS,
        'substeps': task.n_substeps, 'npair': model.npair,
        'wall_s': {'reset': reset_wall, 'step': step_walls},
        'launches': {'reset': reset_launches, 'steps': step_launches},
        'step_window': window,
        'placement_tries': card_tries.tolist(),
        'placements_retried': int((card_tries > 1).sum()),
        'placements_used_all_tries': bool((card_tries >= 20).any()),
        'cpu_other_try': other_try,
        'observation_shapes': {key: list(v.shape)
                               for key, v in steps_ts[-1].observation.items()},
        'step_types': [t.step_type.tolist() for t in steps_ts],
        'cpu_f64_max_err': {'reset': errs[0], 'steps': errs[1:]},
        'k3_vs_plain': k3_checks, f'b{B_ENV}': at_b_env})
  return launches, k3_checks


def _timing_row(torch, fn, plain, lib, b, n, kind):
  """A kernel row's timing fields at (b, n, n) float32: the plain
  version's and the library call's device ms, the bound, and the
  wrapper's per-call ms."""
  bound_ms, bound_by = _bound(b, n, 4, kind)
  return {'plain_ms': _device_ms(torch, plain, 5), 'bound_ms': bound_ms,
          'bound_by': bound_by, 'library_ms': _device_ms(torch, lib, 50),
          'call_ms': _call_ms(torch, fn, 100), 'shape': [b, n, n],
          'dtype': 'float32'}


def _k3_row(torch, lc, h, g, path, launches, err):
  """K3's kernels-line row on a path's own Newton Hessians (rows, n, n),
  whose hold (_k3_holds) gave `err` against the plain version: the design
  that ran and the shared design's time in turns with it
  (_design_turns), and _timing_row's fields (the library call is
  cholesky_ex + cholesky_solve)."""
  fn = lambda: lc.cholesky_solve(h, g)
  ms, extra = _design_turns(
      torch, lc, 'cholesky_solve', lc._MODE_SOLVE, h.shape[-1], fn,
      lambda: lc._launch(lc._MODE_SOLVE, 'cholesky_solve', h, g,
                         design='shared'))
  g3 = g[..., None]
  return {'max_abs_err': err, 'ms': ms, 'kernel_ms': ms, **extra,
          **_timing_row(torch, fn, lambda: lc.solve_plain(h, g),
                        lambda: torch.cholesky_solve(
                            g3, torch.linalg.cholesky_ex(h)[0]),
                        h.shape[0], h.shape[-1], 'solve'),
          'path': path, 'launches': launches}


def _action_bounds(torch, spec):
  """The action spec's bounds in float64, unlimited ones as -1 and 1 (as
  scripts/bench_suite.py draws them)."""
  lo = torch.as_tensor(spec.minimum, dtype=torch.float64)
  hi = torch.as_tensor(spec.maximum, dtype=torch.float64)
  return (torch.where(torch.isfinite(lo), lo, -torch.ones_like(lo)),
          torch.where(torch.isfinite(hi), hi, torch.ones_like(hi)))


def _task_actions(torch, env, seed):
  """(ENV_STEPS, B_EPISODES, nu) seeded actions on the CPU in float64, in
  a band of 0.3 of the spec's range around its middle (the convention of
  `controls`)."""
  lo, hi = _action_bounds(torch, env.action_spec())
  agen = torch.Generator().manual_seed(seed + 7)
  u = torch.rand(ENV_STEPS, B_EPISODES, lo.shape[0], generator=agen,
                 dtype=torch.float64)
  return lo + (hi - lo) * (0.5 + 0.3 * (u - 0.5))


def _episodes(torch, pkg, env, seed, acts):
  """reset of B_EPISODES episodes from `seed` on env's device; the first
  ENV_CHECKED then take a step per row of `acts`.  Returns (the state and
  the time step of each call, over those episodes; the try each of the
  reset's rejection searches picked for them)."""
  structs = pkg['structs']
  dev, dtype, k = env.model.device, env.model.dtype, ENV_CHECKED
  with _picks(pkg['hands']) as picks:
    state, ts = env.reset(torch.Generator().manual_seed(seed), (B_EPISODES,))
  state, ts = structs.tree_map(lambda x: x[:k], (state, ts))
  states, tss, gen = [state], [ts], torch.Generator()
  for a in acts[:, :k]:
    state, ts = env.step(state, a.to(dev, dtype), gen)
    states.append(state)
    tss.append(ts)
  return states, tss, [p[:k] for p in picks]


def _head(structs, states, tss, picks):
  """The first ENV_CHECKED episodes of a run's states, time steps and
  rejection picks, as _episodes returns them."""
  k = ENV_CHECKED
  return ([structs.tree_map(lambda x: x[:k], st) for st in states],
          [structs.tree_map(lambda x: x[:k], t) for t in tss],
          [p[:k] for p in picks])


def _other_picks(run, ref):
  """The episodes whose rejection searches picked another try in `run`
  than in `ref` (a contact at the margin in float32)."""
  return [i for i in range(ENV_CHECKED)
          if any(int(a[i]) != int(b[i]) for a, b in zip(run[2], ref[2]))]


_FLAGS = ('successes', 'success_change_counter', 'exceeded_single_goal_time',
          'success_registered', 'goal_changed', 'failure_termination',
          'goal_ok')


def _episode_errs(torch, pkg, run, ref, rows):
  """Per call (reset, then each step), episodes `rows` of a run
  (_episodes) against a CPU float64 run: the max-abs error of qpos, qvel
  and the goal; of the goal distance, reward and observations relative to
  the reference's max-abs (at least 1); whether step_type and every
  task-state flag are equal."""
  structs = pkg['structs']

  def sub(x):
    return structs.tree_map(lambda y: y[rows.to(y.device)], x)

  def err(a, b):
    return (_to_cpu64(torch, a) - b).abs().max().item() if b.numel() else 0.0

  out = []
  for st, t, cst, cts in zip(*(map(sub, x) for x in (*run[:2], *ref[:2]))):
    out.append({
        'qpos': err(st.data.qpos, cst.data.qpos),
        'qvel': err(st.data.qvel, cst.data.qvel),
        'goal': err(st.task.goal, cst.task.goal),
        'goal_distance_rel': _max_rel(torch, st.task.goal_distance,
                                      cst.task.goal_distance),
        'reward_rel': _max_rel(torch, t.reward, cts.reward),
        'obs_rel': max(_max_rel(torch, t.observation[key], v)
                       for key, v in cts.observation.items()),
        'step_type_equal': bool((t.step_type.cpu() == cts.step_type).all()),
        'flags_equal': all(bool((getattr(st.task, f).cpu()
                                 == getattr(cst.task, f)).all())
                           for f in _FLAGS)})
  return out


def _over(e, lim):
  """The entries of one call's errors (_episode_errs) outside the task's
  limits; NaN is outside."""
  bounds = {'qpos': lim['qpos'], 'qvel': lim['qvel'], 'goal': lim['goal'],
            'goal_distance_rel': lim['rel'], 'reward_rel': lim['rel'],
            'obs_rel': lim['obs']}
  return ([key for key, b in bounds.items() if not e[key] <= b]
          + [key for key in ('step_type_equal', 'flags_equal') if not e[key]])


def phase_task(torch, pkg, domain, variant):
  """manipulation.load(domain, variant) on the card: reset of B_EPISODES
  episodes from a seeded CPU generator and ENV_STEPS steps with seeded
  actions.  K3's launches: 8 in reset's forward and one settle of 2
  substeps (9 per substep: 8 Newton iterations and the Euler solve) for
  reach's goal search (every try in one round at this batch) or the
  hands' settle (juggle); 9 per step.  The first ENV_CHECKED episodes are
  held against the same calls on the CPU in float64 at TASK_LIMITS (an
  episode whose rejection search picked another try in float32 is
  reported and left out; juggle has none); K3 against its plain version
  and float64 on a step's own Newton Hessian and Euler matrix, at
  (B_EPISODES, nv, nv) and for one episode without a batch axis."""
  manip, structs, lc = pkg['manipulation'], pkg['structs'], pkg['linalg_cuda']
  name = f'{domain}.{variant}'
  env = manip.load(domain, variant)
  model, task = env.model, env.task
  dev, dtype, nv = model.device, model.dtype, model.nv
  iters = model.opt.solver_iterations
  per_step = task.n_substeps * (iters + 1)
  check(dev.type == 'cuda' and dtype == torch.float32 and
        model.opt.solver_refactor_every == 1, f'{name} model')
  lim = TASK_LIMITS[domain]
  acts = _task_actions(torch, env, SEED)
  gen = torch.Generator()
  warm, _ = env.reset(torch.Generator().manual_seed(SEED + 99), (2,))
  env.step(warm, acts[0, :2].to(dev, dtype), gen)
  torch.cuda.synchronize()

  reset_counts(pkg)
  t0 = time.perf_counter()
  with _picks(pkg['hands']) as picks:
    state, ts = env.reset(torch.Generator().manual_seed(SEED), (B_EPISODES,))
  torch.cuda.synchronize()
  reset_wall = time.perf_counter() - t0
  reset_launches = read_counts(pkg)
  k3 = reset_launches['cholesky_solve']
  check(sum(reset_launches.values()) == k3 == iters + 2 * (iters + 1),
        f'{name} reset launches {reset_launches}')
  check(bool(state.task.goal_ok.all()), f'{name} goal sampling failed')
  states, tss, walls, step_launches = [state], [ts], [], []
  for i in range(ENV_STEPS):
    reset_counts(pkg)
    t0 = time.perf_counter()
    state, ts = env.step(state, acts[i].to(dev, dtype), gen)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    step_launches.append(read_counts(pkg))
    check(step_launches[-1]['cholesky_solve'] == per_step and
          sum(step_launches[-1].values()) == per_step,
          f'{name} step launches {step_launches[-1]}')
    check(not bool(state.task.goal_changed.any()), f'{name} goal switched')
    states.append(state)
    tss.append(ts)
  for st, t in zip(states, tss):
    for what, x in (('qpos', st.data.qpos), ('qvel', st.data.qvel),
                    ('reward', t.reward), *t.observation.items()):
      check(bool(torch.isfinite(x).all()), f'{name}: non-finite {what}')
  launches = {k: reset_launches[k] + sum(sl[k] for sl in step_launches)
              for k in reset_launches}
  window = _busy_window(torch, lambda: env.step(
      states[0], acts[0].to(dev, dtype), gen), launch_counters(pkg))
  _, by_kernel = _device_profile(torch, lambda: env.step(
      states[0], acts[0].to(dev, dtype), gen), 1, launch_counters(pkg))
  design = _ran_design([k for k in by_kernel if 'cholesky' in k])
  check(design == lc._design(nv, dtype, lc._MODE_SOLVE),
        f'{name}: K3 ran {design}')

  # K3 on this path's own inputs, outside the counted and timed calls.
  k3_checks = {}
  _, seen = _k3_holds(torch, lc, lambda: env.step(
      states[0], acts[0].to(dev, dtype), gen), B_EPISODES, nv, 'step',
                      _K3_STEP, k3_checks)
  one = structs.tree_map(lambda x: x[0], states[0])
  _k3_holds(torch, lc, lambda: env.step(one, acts[0, 0].to(dev, dtype), gen),
            1, nv, 'unbatched_step', _K3_STEP, k3_checks)

  # The same calls on the CPU in float64 from the same seed.
  k = ENV_CHECKED
  card = _head(structs, states, tss, picks)
  ref = _episodes(torch, pkg, manip.load(domain, variant, device='cpu',
                                         dtype=torch.float64), SEED, acts)
  other = _other_picks(card, ref)
  rows = torch.tensor([i for i in range(k) if i not in other])
  check(len(rows) >= k // 2, f'{name}: rejection picks differ in {other}')
  errs = _episode_errs(torch, pkg, card, ref, rows)
  for i, e in enumerate(errs):
    check(not _over(e, lim), f'{name} call {i} vs CPU float64: {e}')
  tree = (_tree_sweep_hold(torch, pkg, task, model, states[0].data)
          if model.nmocap > 1 else None)
  emit({'phase': domain, 'task': name, 'batch': B_EPISODES,
        'steps': ENV_STEPS, 'substeps': task.n_substeps, 'nq': model.nq,
        'nv': nv, 'nu': model.nu, 'neq': model.neq, 'nmocap': model.nmocap,
        'npair': model.npair, 'k3_design': design,
        'wall_s': {'reset': reset_wall, 'step': walls},
        'launches': {'reset': reset_launches, 'steps': step_launches},
        'step_window': window, 'rejection_picks': [p.tolist() for p in picks],
        'cpu_other_pick': other, 'limits': lim,
        'observation_shapes': {key: list(v.shape)
                               for key, v in tss[-1].observation.items()},
        'step_types': [t.step_type.tolist() for t in tss],
        'cpu_f64_max_err': {'reset': errs[0], 'steps': errs[1:]},
        'k3_vs_plain': k3_checks, 'tree_sweep_hold': tree})
  return {'launches': launches,
          'k3_inputs': seen[('cholesky_solve', 'newton_iter')],
          'k3_err': k3_checks['step_newton_hessian']}


def _worst(vals):
  """The largest of floats, NaN if any is; all of booleans."""
  if isinstance(vals[0], bool):
    return all(vals)
  return float('nan') if any(v != v for v in vals) else max(vals)


def phase_hold_readings(torch, pkg, seeds):
  """The reach and juggle phases' hold against the CPU float64 port, on
  `seeds`, to choose TASK_LIMITS: the readings of sound runs (the card;
  the port on the CPU in float32) and of two faulted card runs (every
  float32 matrix product in TF32; K3's solution rounded to bfloat16), each
  the worst over reset and the steps, with the entries over TASK_LIMITS.
  A faulted run that raises is reported as such."""
  manip, lc = pkg['manipulation'], pkg['linalg_cuda']
  real_k3 = lc.cholesky_solve

  def k3_bf16(fn):
    lc.cholesky_solve = lambda h, g: real_k3(h, g).bfloat16().to(g.dtype)
    try:
      return fn()
    finally:
      lc.cholesky_solve = real_k3

  for domain, variant in TASK_PHASES:
    lim = TASK_LIMITS[domain]
    card = manip.load(domain, variant)
    cpu = {dt: manip.load(domain, variant, device='cpu', dtype=dt)
           for dt in (torch.float32, torch.float64)}
    readings = {}
    for seed in seeds:
      acts = _task_actions(torch, card, seed)
      ref = _episodes(torch, pkg, cpu[torch.float64], seed, acts)
      run = lambda e: (lambda: _episodes(torch, pkg, e, seed, acts))
      for what, fn, faulted in (
          ('card', run(card), False),
          ('cpu_float32', run(cpu[torch.float32]), False),
          ('card_tf32', lambda: tf32(torch, run(card)), True),
          ('card_k3_bfloat16', lambda: k3_bf16(run(card)), True)):
        entry = {'seed': seed}
        try:
          got = fn()
        except Exception as exc:  # noqa: BLE001 (a faulted run may raise)
          if not faulted:
            raise
          readings.setdefault(what, []).append(
              {**entry, 'raised': f'{type(exc).__name__}: {exc}'[:300]})
          continue
        other = _other_picks(got, ref)
        rows = torch.tensor([i for i in range(ENV_CHECKED) if i not in other])
        errs = _episode_errs(torch, pkg, got, ref, rows)
        worst = {key: _worst([e[key] for e in errs]) for key in errs[0]}
        readings.setdefault(what, []).append(
            {**entry, 'other_pick': other, 'worst': worst,
             'over_limits': _over(worst, lim)})
    emit({'phase': 'hold_readings', 'task': f'{domain}.{variant}',
          'batch': B_EPISODES, 'episodes': ENV_CHECKED, 'steps': ENV_STEPS,
          'limits': lim, 'readings': readings})


def _tree_sweep_hold(torch, pkg, task, model, data):
  """build_tree_sweep (K5 + K6) on a model with several mocap bodies, on
  the phase's reset states, against its plain version: float32 to 1e-4
  and float64 to 1e-10 of each output's max-abs; each mocap body's world
  pose is its own component-major rows (row c * nmocap + m)."""
  tc = pkg['tree_cuda']
  out = {}
  for dtype, lim in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
    # The float64 model is compiled in float64 (a float32 model cast up
    # has quaternions off unit length by float32 rounding, and the
    # kernel's level-by-level and the plain version's pointer-jumping
    # compositions then part at that size).
    m = model if dtype == torch.float32 else task.compile(device=model.device,
                                                          dtype=dtype)
    ins = _tree_inputs(torch, data, dtype)
    got = tc.build_tree_sweep(m)(*ins)
    want = tc.tree_sweep_plain(m, *ins)
    for key, w in want.items():
      err = (got[key] - w).abs().max().item()
      scale = max(w.abs().max().item(), 1.0)
      check(bool(torch.isfinite(got[key]).all()) and err <= lim * scale,
            f'tree sweep {dtype} {key}: {err} > {lim} * {scale}')
      out[f'{key}_{str(dtype)[6:]}'] = err / scale
    nb, nm = m.nbody, m.nmocap
    for k in range(nm):
      body = m.body_mocapid.index(k)
      rows = torch.arange(3, device=ins[0].device) * nb + body
      check(bool((got['xpos'][rows] == ins[2][torch.arange(
          3, device=ins[0].device) * nm + k]).all()),
            f'mocap body {k}: xpos rows')
  out.update({'batch': int(data.qpos.shape[0]), 'nmocap': model.nmocap,
              'nbody': model.nbody, 'nv': model.nv})
  return out


def phase_reach_oracle(torch, pkg):
  """examples/oracle_reach.py on the card: ORACLE_EPISODES reach
  state_sparse episodes from a seeded CPU generator, control =
  hand.joint_positions_to_control(goal[15:]) every step (the goal switches
  after 5 in-threshold steps), until every episode has registered a solve
  and seen reward 0, at most ORACLE_STEPS steps.  Every episode must (the
  hold of JAX's tests/test_suite.py on its one episode)."""
  manip = pkg['manipulation']
  env = manip.load('reach', 'state_sparse')
  hand, dev = env.task.hand, env.model.device
  gen = torch.Generator().manual_seed(SEED + 42)
  state, _ = env.reset(gen, (ORACLE_EPISODES,))
  best = torch.full((ORACLE_EPISODES,), -float('inf'), device=dev)
  solved = torch.zeros(ORACLE_EPISODES, dtype=torch.int32, device=dev)
  ret = torch.zeros(ORACLE_EPISODES, device=dev)
  first_step = torch.full((ORACLE_EPISODES,), -1, dtype=torch.int64)
  switches = 0
  t0 = time.perf_counter()
  steps = 0
  for steps in range(1, ORACLE_STEPS + 1):
    ctrl = hand.joint_positions_to_control(state.task.goal[..., 15:])
    state, ts = env.step(state, ctrl, gen)
    best = torch.maximum(best, ts.reward)
    ret = ret + ts.reward
    solved = torch.maximum(solved, state.task.successes)
    switches += int(state.task.goal_changed.sum())
    hit = ((solved >= 1) & (best == 0)).cpu()
    first_step = torch.where(hit & (first_step < 0), steps, first_step)
    check(bool(torch.isfinite(state.data.qpos).all()), 'oracle: non-finite')
    if bool(hit.all()):
      break
  wall = time.perf_counter() - t0
  hit = ((solved >= 1) & (best == 0)).cpu()
  out = {'phase': 'reach_oracle', 'episodes': ORACLE_EPISODES,
         'steps': steps, 'max_steps': ORACLE_STEPS,
         'success_rate': hit.float().mean().item(),
         'mean_return': ret.mean().item(),
         'steps_to_first_solve': first_step.tolist(),
         'successes': solved.tolist(), 'best_reward': best.tolist(),
         'goal_switches': switches, 'wall_s': wall,
         'wall_s_per_step': wall / steps}
  if not bool(hit.all()):
    out['final_fingertip_distances'] = state.task.goal_distance[
        ~hit.to(dev)].tolist()
  emit(out)
  check(bool(hit.all()), f'oracle missed a goal: {out}')


def phase_suite(torch, pkg):
  """scripts/bench_suite.py on the card: every manipulation.ALL_NAMES task
  through envs.batched.BatchedEnvironment.step_with_metrics under uniform
  random actions (drawn on the card), B_SUITE episodes, SUITE_WARMUP
  steps, then SUITE_STEPS timed steps.  Per task: env steps/s, substeps/s,
  episodes, mean return, K3 launches (timed steps), the device idle share
  of one step; for reach.state_dense and juggle.state_sparse, K3 held
  against its plain version and float64 on a step's own Newton Hessian
  and Euler matrix at (B_SUITE, nv, nv), and the Hessian for the kernels
  line."""
  manip, lc = pkg['manipulation'], pkg['linalg_cuda']
  from dexterity_tpu_torch.envs import batched
  from dexterity_tpu_torch.utils import metrics as metrics_lib
  tasks, k3 = {}, {}
  for name in manip.ALL_NAMES:
    env = manip.load(*name.split('.'))
    model, task = env.model, env.task
    dev, dtype = model.device, model.dtype
    benv = batched.BatchedEnvironment(env, B_SUITE)
    lo, hi = (x.to(dev, dtype) for x in _action_bounds(
        torch, env.action_spec()))
    gen = torch.Generator().manual_seed(SEED + 11)
    agen = torch.Generator(device=dev).manual_seed(SEED + 12)

    def actions():
      return lo + (hi - lo) * torch.rand(B_SUITE, lo.shape[0], generator=agen,
                                         device=dev, dtype=dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = benv.reset(gen)
    torch.cuda.synchronize()
    reset_wall = time.perf_counter() - t0
    metrics = metrics_lib.init(B_SUITE, dtype=dtype, device=dev)
    for _ in range(SUITE_WARMUP):
      state, _, metrics = benv.step_with_metrics(state, actions(), metrics,
                                                 gen)
    torch.cuda.synchronize()
    reset_counts(pkg)
    t0 = time.perf_counter()
    for _ in range(SUITE_STEPS):
      state, ts, metrics = benv.step_with_metrics(state, actions(), metrics,
                                                  gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(pkg)
    check(bool(torch.isfinite(state.data.qpos).all()),
          f'suite {name}: non-finite state')
    iters = model.opt.solver_iterations
    check(launches['cholesky_solve'] >= SUITE_STEPS * task.n_substeps
          * (iters + 1), f'suite {name} launches {launches}')
    summ = metrics_lib.summary(metrics)
    window = _busy_window(torch, lambda: env.step(state, actions(), gen),
                          launch_counters(pkg))
    holds = {}
    if name in ('reach.state_dense', 'juggle.state_sparse'):
      _, seen = _k3_holds(torch, lc, lambda: env.step(state, actions(), gen),
                          B_SUITE, model.nv, 'step', _K3_STEP, holds)
      k3[name] = (*seen[('cholesky_solve', 'newton_iter')],
                  launches['cholesky_solve'], holds['step_newton_hessian'])
    tasks[name] = {
        'batch': B_SUITE, 'steps': SUITE_STEPS, 'warmup': SUITE_WARMUP,
        'substeps': task.n_substeps, 'reset_wall_s': reset_wall,
        'wall_s': wall, 'env_steps_per_s': B_SUITE * SUITE_STEPS / wall,
        'env_substeps_per_s': B_SUITE * SUITE_STEPS * task.n_substeps / wall,
        'episodes': summ['episodes'], 'mean_return': summ['mean_return'],
        'mean_live_return': metrics.cur_return.mean().item(),
        'k3_launches': launches['cholesky_solve'], 'launches': launches,
        'step_window': window, 'k3_vs_plain': holds,
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9}
    emit({'phase': 'suite', 'task': name, **tasks[name]})
    del state, metrics, benv, env
    torch.cuda.empty_cache()
  emit({'phase': 'suite_summary', 'batch': B_SUITE,
        'reduced': [f'timed steps {SUITE_REFERENCE_STEPS} -> {SUITE_STEPS}'],
        'env_steps_per_s': {k: v['env_steps_per_s'] for k, v in tasks.items()},
        'device_idle_share': {k: v['step_window']['device_idle_share']
                              for k, v in tasks.items()}})
  return k3


def _keep_in_hand(torch, qadr):
  """scripts/eval_closed_loop_batch.py's planning shaping (:66-76), as the
  port's batched extra_reward_fn: (model, data (M, ...), goals) -> (M,).
  Reads qpos only (valid under plan_refresh='none')."""
  cx, cy, cz = SPAWN_CENTER

  def shaping(model, data, goals):
    del model, goals
    pos = data.qpos[..., qadr:qadr + 3]
    horiz = (pos[..., 0] - cx) ** 2 + (pos[..., 1] - cy) ** 2
    low = (cz - SHAPING['margin'] - pos[..., 2]).clamp_min(0.0)
    return -SHAPING['horiz'] * horiz - SHAPING['drop'] * low * low

  return shaping


def phase_closed_loop(torch, pkg, goals, max_steps, seed, bar=False,
                      max_wall=None, smi=''):
  """Closed-loop reorient MPC at scripts/eval_closed_loop_batch.py's
  configuration: `goals` episodes in lockstep from GoalEnvironment.reset;
  each control step plans every episode with one solve_batch and steps
  the environment; finished episodes are frozen in place (their state
  and plan kept), and the loop ends when every episode has ended or
  after `max_steps` (or `max_wall` seconds).  Success: the episode ended
  solved (0.1 rad) within the steps; a fall is a failure.  Then one
  solve_batch and one env.step from the final state under the profiler:
  their wall, device busy time and idle share."""
  import numpy as np
  ps, manip, structs = pkg['ps'], pkg['manipulation'], pkg['structs']
  c = CLOSED_LOOP
  env = manip.load('reorient', 'state_dense')
  task = env.task
  dev = env.model.device
  cfg = ps.PredictiveSamplingConfig(
      horizon=c['horizon'], num_samples=c['samples'],
      noise_scale=c['noise'], num_knots=c['knots'],
      temperature=c['temperature'], plan_substeps=c['plan_substeps'],
      iterations=c['iterations'], noise_decay=c['noise_decay'],
      failure_penalty=c['failure_penalty'],
      solver_iterations=c['solver_iterations'],
      ls_iterations=c['ls_iterations'],
      solver_refactor_every=c['refactor'], plan_midphase_cap=c['midphase'],
      plan_contact_top_k=c['top_k'])
  planner = ps.PredictiveSampling(
      task, cfg, extra_reward_fn=_keep_in_hand(torch, task._prop_qadr))
  gen = torch.Generator().manual_seed(seed)
  pgen = torch.Generator(device=dev).manual_seed(seed)
  t_start = time.perf_counter()
  state, _ = env.reset(gen, (goals,))
  pst = planner.init_state(streams=goals)
  start_err = state.task.goal_distance[:, 0].cpu()
  done = torch.zeros(goals, dtype=torch.bool, device=dev)
  solved = torch.zeros_like(done)
  steps_to_solve = torch.full((goals,), max_steps, dtype=torch.int32,
                              device=dev)
  walls, cut, steps = [], False, 0
  for i in range(max_steps):
    t0 = time.perf_counter()
    actions, pst2 = planner.solve_batch(state.data, state.task.goal, pst,
                                        pgen)
    state2, ts = env.step(state, actions, gen)
    ended = ts.step_type == 2
    newly_solved = ~done & ended & (state2.task.successes >= 1)
    solved = solved | newly_solved
    steps_to_solve = torch.where(newly_solved, i + 1, steps_to_solve)
    # Freeze finished episodes: they keep their terminal state and plan.
    before = state
    state = structs.where_rows(done, state, state2)
    pst = structs.where_rows(done, pst, pst2)
    if bool(done.any()):
      check(bool((state.data.qpos[done] == before.data.qpos[done]).all()
                 and (state.task.goal_distance[done]
                      == before.task.goal_distance[done]).all()),
            f'a frozen episode moved at step {i}')
    done = done | ended
    for what, x in (('qpos', state.data.qpos), ('qvel', state.data.qvel),
                    ('actions', actions), ('best_return', pst.best_return)):
      check(bool(torch.isfinite(x[~done] if what == 'actions' else x).all()),
            f'non-finite {what} at control step {i}')
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    steps = i + 1
    if bar and steps % 10 == 0:
      emit({'phase': 'closed_loop_progress', 'seed': seed, 'steps': steps,
            'ended': int(done.sum()), 'solved': int(solved.sum()),
            'fell': int(state.task.failure_termination.sum()),
            'wall_s': time.perf_counter() - t_start})
    if bool(done.all()):
      break
    if max_wall is not None and time.perf_counter() - t_start > max_wall:
      cut = True
      break
  wall = time.perf_counter() - t_start
  # K1 and K2 on this path's own inputs, at (goals x samples, nv, nv): one
  # solve_batch from the final state, outside the loop and its results.
  kernel_checks = _k12_holds(
      torch, pkg['linalg_cuda'], lambda: planner.solve_batch(
          state.data, state.task.goal, pst, pgen),
      goals * c['samples'], planner.model.nv, 'closed-loop')
  # Host and device share of one control step's two halves, from the
  # final state (outside the loop and its results).
  windows = {
      'solve_batch': _busy_window(torch, lambda: planner.solve_batch(
          state.data, state.task.goal, pst, pgen)),
      'env_step': _busy_window(torch, lambda: env.step(
          state, pst.nominal[:, 0], gen))}
  err = state.task.goal_distance[:, 0].cpu()
  fell = state.task.failure_termination.cpu()
  solved_c = solved.cpu()
  summary = {
      'goals': goals,
      'success_rate': float(solved_c.double().mean()),
      'fell_rate': float(fell.double().mean()),
      'mean_steps_solved': (float(steps_to_solve.cpu()[solved_c]
                                  .double().mean())
                            if bool(solved_c.any()) else None),
      'median_final_err_rad': float(np.median(err.double().numpy())),
      'config': {**{k: c[k] for k in ('samples', 'horizon', 'knots',
                                      'temperature', 'noise', 'iterations',
                                      'noise_decay', 'failure_penalty',
                                      'plan_substeps')},
                 'shaping': True,
                 'shape': [SHAPING['horiz'], SHAPING['drop'],
                           SHAPING['margin'], SHAPING['vel']],
                 'steps': max_steps, 'seed': seed},
      'wall_s': wall, 'backend': 'cuda', 'plan_refac': c['refactor'],
      'device': torch.cuda.get_device_name(0), 'card': smi,
      'steps_run': steps, 'ended': int(done.sum()),
      'solved': int(solved_c.sum()), 'cut_by_max_wall': cut,
      'median_start_err_rad': float(np.median(start_err.double().numpy())),
      'wall_s_per_control_step': walls, 'control_step_windows': windows,
      'kernels_vs_plain': kernel_checks}
  if not bar:
    summary['reduced'] = [f'control steps {CL_STEPS_BEFORE} -> {max_steps}']
  emit({'phase': 'closed_loop_bar' if bar else 'closed_loop', **summary})


# ---------------------------------------------------------------------------
# Gradient planners: iLQR, SQP and the hybrid MPC step
# ---------------------------------------------------------------------------


def _keep_in_hand_cost(torch, qadr):
  """scripts/eval_ilqr.py's keep_in_hand_cost (:65-71), the shaping of
  _keep_in_hand with its sign flipped: the planners' batched
  extra_cost_fn."""
  reward = _keep_in_hand(torch, qadr)
  return lambda model, data, goals: -reward(model, data, goals)


def _ilqr_launches(cfg, substeps):
  """K1, K2 and K3 launches of one ILQR.solve (or SQP.solve) with every
  substep's Newton at 4 iterations: the rollout and the line search (or
  merit rollout) run H control steps each, the linearization one
  forward-mode pass (c = 1).  Refactor every 4: 1 K1 + 3 K2 per substep,
  plus one tangent K2 for each in the linearization; refactor every 1: 4
  K3 per substep, plus one tangent K3 each."""
  h, s, c = cfg['horizon'], substeps, 1
  its = cfg['iterations']
  if cfg['solver_refactor_every'] == 1:
    return {'cholesky_solve_factor': 0, 'cholesky_resolve_const': 0,
            'cholesky_solve': its * (4 * 2 * h * s + 8 * c * s)}
  return {'cholesky_solve_factor': its * (2 * h * s + c * s),
          'cholesky_resolve_const': its * (3 * 2 * h * s + 7 * c * s),
          'cholesky_solve': 0}


def _solve_recording(planner, *args):
  """planner.solve(*args) with each iteration's selection recorded:
  returns the solve's result and, per iteration, (the alpha = 0
  candidate's cost, the cost kept), both computed in one batch."""
  seen, real = [], planner._select

  def select(us, cands, costs, cost_prev, reg):
    out = real(us, cands, costs, cost_prev, reg)
    seen.append((costs[0].clone(), out[1].clone()))
    return out

  planner._select = select
  try:
    return planner.solve(*args), seen
  finally:
    del planner._select


def _check_no_regress(torch, label, iters):
  """Every iteration keeps a cost no higher than its alpha = 0
  candidate's (the nominal replayed in the same batch), so a solve never
  regresses; returns the per-iteration costs."""
  for i, (c0, kept) in enumerate(iters):
    c0 = torch.where(torch.isnan(c0), torch.full_like(c0, float('inf')), c0)
    check(bool((kept <= c0).all()),
          f'{label} iteration {i}: kept {kept.tolist()} above the '
          f'alpha = 0 cost {c0.tolist()}')
  return [{'alpha0': c0.tolist(), 'kept': kept.tolist()}
          for c0, kept in iters]


def _tangent_holds(torch, lc, seen, label):
  """Each captured tangent launch (_capture_first on the rules' entries
  _rule_resolve and _rule_solve) against its plain rule and float64 on
  the path's own inputs: K2's (fac, dg) (the matrix it factors is
  L L^T), K3's (H, dg - dH x)."""
  out = {}
  for (entry, _), (a, g) in sorted(seen.items()):
    # Rows whose tangent rhs is zero (a unit tangent the step does not
    # reach) solve to zero and have no backward error to read.
    live = g.abs().amax(-1) > 0
    a, g = a[live], g[live]
    if entry == '_rule_solve':
      errs = _vs_plain(torch, lc, 'cholesky_solve', a, g, f'{label} {entry}')
    else:
      f64 = a.double()
      ll = (torch.tril(f64, -1) + torch.diag_embed(
          1 / torch.diagonal(f64, dim1=-2, dim2=-1)))
      errs = _vs_plain(torch, lc, 'cholesky_resolve_const', ll @ ll.mT, g,
                       f'{label} {entry}', fac=a)
    out.update({f'{entry}{k}': v for k, v in errs.items()})
  return out


_LIN_NAMES = ('fx', 'fu', 'cx', 'cu')


def _lin_blocks(torch, got, ref):
  """Per (goal, t) block, the max-abs error of each of (fx, fu, cx, cu)
  against the reference's, relative to the reference block's max-abs:
  {name: (G, H)} on the CPU in float64."""
  out = {}
  for name, a, b in zip(_LIN_NAMES, got, ref):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    err = (a - b).abs().flatten(2).amax(-1)
    out[name] = err / b.abs().flatten(2).amax(-1).clamp_min(1e-30)
  return out


def _lin_moves(torch, lin, x64, nudges):
  """How far each (goal, t) block moves under relative changes of the
  states: the largest of _lin_blocks over (fx, fu, cx, cu) and over
  `nudges`, lin(x) being the linearization at the float64 states x
  (cast by lin to its own dtype)."""
  base = lin(x64)
  moved = torch.zeros(x64.shape[:2], dtype=torch.float64)
  for nudge in nudges:
    for err in _lin_blocks(torch, lin(x64 * (1 + nudge)), base).values():
      moved = torch.maximum(moved, err)
  return base, moved


def _lin_faulted(torch, lc, fn):
  """fn's linearization under the faults the hold must catch: TF32 matrix
  products, and K2's tangent rounded to bfloat16 (the rules' entry
  _rule_resolve patched)."""
  out = {'tf32': tf32(torch, fn)}
  real = lc._rule_resolve

  def rounded(fac, g):
    x = real(fac, g)
    return x.bfloat16().to(x.dtype)

  lc._rule_resolve = rounded
  try:
    out['k2_tangent_bf16'] = fn()
  finally:
    lc._rule_resolve = real
  return out


def _lin_hold(torch, pkg, planner, cpu64, cpu32, data, goals, xs, us, lin):
  """The linearization hold (LIN_LIMITS) in goal 0's H blocks, and the
  first backward pass on the CPU float64 port for the LIN_WITNESS goals.
  `lin` is the card's linearization of every goal at (xs, us), the
  solve's first.  Returns the phase's readings."""
  tmap = pkg['types'].map_data
  w = list(LIN_WITNESS)
  d64 = tmap(data, lambda x: _to_cpu64(torch, x[w]))
  g64, u64 = _to_cpu64(torch, goals[w]), _to_cpu64(torch, us[w])
  x64 = _to_cpu64(torch, xs[w])
  t0 = time.perf_counter()
  ref = cpu64._linearize(d64, g64, x64, u64)
  t_ref = time.perf_counter() - t0
  reg = torch.full((len(w),), ILQR['reg_init'], dtype=torch.float64)
  ks64, _ = cpu64._backward_pass(*ref, reg)
  ref0 = [a[:1] for a in ref]
  one = lambda d: tmap(d, lambda x: x[:1])
  d32 = tmap(one(data), lambda x: x.cpu())
  t0 = time.perf_counter()
  _, moved64 = _lin_moves(
      torch, lambda x: cpu64._linearize(one(d64), g64[:1], x, u64[:1]),
      x64[:1], LIN_NUDGES_F64)
  cpu_f32, moved32 = _lin_moves(
      torch, lambda x: cpu32._linearize(d32, goals[:1].cpu(), x.float(),
                                        us[:1].cpu()),
      x64[:1], LIN_NUDGES_F32)
  t_nudges = time.perf_counter() - t0
  held = ((moved64 <= 1e-9) & (moved32 <= LIN_RESOLVED))[0]
  check(bool(held.any()), 'ilqr linearization: no block resolved in both '
        f'precisions ({moved64.tolist()}, {moved32.tolist()})')
  runs = {'card': [a[:1] for a in lin], 'cpu_f32': cpu_f32,
          **_lin_faulted(torch, pkg['linalg_cuda'], lambda: planner._linearize(
              one(data), goals[:1], xs[:1], us[:1]))}
  readings = {}
  for run, got in runs.items():
    errs = {k: v[0] for k, v in _lin_blocks(torch, got, ref0).items()}
    if run in ('card', 'cpu_f32'):
      for name, err in errs.items():
        check(bool(torch.isfinite(err).all()),
              f'ilqr linearization {name}, {run}: not finite')
        check(float(err[held].max()) <= LIN_LIMITS[name],
              f'ilqr linearization {name}, {run} vs CPU float64 in the held '
              f'blocks: {err[held].tolist()}')
    readings[run] = {
        'held_max': {k: float(v[held].max()) for k, v in errs.items()},
        'other_max': {k: float(v[~held].max()) if (~held).any() else None
                      for k, v in errs.items()},
        'over_limit': sorted(k for k, v in errs.items()
                             if float(v[held].max()) > LIN_LIMITS[k]),
        'per_block': {k: v.tolist() for k, v in errs.items()}}
  return {'blocks': f'goal 0, t = 0..{xs.shape[1] - 1}',
          'held': held.nonzero().flatten().tolist(),
          'moved_f64': moved64[0].tolist(), 'moved_f32': moved32[0].tolist(),
          'readings': readings, 'limits': LIN_LIMITS,
          'cpu_s': {'f64_reference': t_ref, 'nudges_and_f32': t_nudges},
          'witness_goals': w,
          'nan_gain_steps_cpu_f64': torch.isnan(ks64).any(-1).sum(-1).tolist()}


def _ilqr_busy(torch, planner, data, goals, us, xs, lin, reg, iterations):
  """Device busy time of one solve, from one profiled window per stage
  (a full solve launches millions of kernels, more than the profiler's
  trace should hold): the rollout's control step at G rows, the line
  search's at L x G rows (cost and step), one linearization pass and one
  backward pass (at the plan us, its rollout xs and linearization lin);
  the solve's busy time is their sum weighted by the counts one solve
  runs (H steps each, per iteration)."""
  g = us.shape[0]
  x0 = planner._pack(data)
  n_l = planner.config.line_search_steps
  tmpl, goal_rows = planner._rows(
      data, goals, torch.arange(g, device=us.device).repeat(n_l))
  x_l, u_l = x0.repeat(n_l, 1), us[:, 0].repeat(n_l, 1)
  windows = {
      'rollout_step': _busy_window(torch, lambda: planner._f(data, x0,
                                                             us[:, 0])),
      'line_search_step': _busy_window(torch, lambda: (
          planner._cost(tmpl, goal_rows, x_l, u_l),
          planner._f(tmpl, x_l, u_l))),
      'linearization': _busy_window(torch, lambda: planner._linearize(
          data, goals, xs, us)),
      'backward_pass': _busy_window(torch, lambda: planner._backward_pass(
          *lin, reg))}
  h = us.shape[1]
  busy_ms = iterations * (
      h * (windows['rollout_step']['device_busy_ms']
           + windows['line_search_step']['device_busy_ms'])
      + windows['linearization']['device_busy_ms']
      + windows['backward_pass']['device_busy_ms'])
  return busy_ms, windows


def phase_ilqr(torch, pkg, smi):
  """ILQR.solve at scripts/eval_ilqr.py's configuration for ILQR_GOALS
  goals from GoalEnvironment.reset, the keep-in-hand shaping as its cost.
  Warm-up: one solve at H = 2.  Then one full solve, timed: wall,
  solves/s, peak memory, and exact K1/K2 launches (primal and tangent);
  finite actions within the bounds, each iteration's cost no higher than
  its alpha = 0 candidate's; each tangent launch against its plain rule
  on the path's own inputs.  From the solve's first nominal: the steps of
  the first backward pass whose gains are NaN, on the card and on the CPU
  float64 port (_lin_hold), the linearization hold, and an estimate of
  the device busy time and idle share from stage windows (_ilqr_busy)."""
  ilqr, manip, lc = pkg['ilqr'], pkg['manipulation'], pkg['linalg_cuda']
  env = manip.load('reorient', 'state_dense')
  task = env.task
  gen = torch.Generator().manual_seed(SEED + 6)
  state, _ = env.reset(gen, (ILQR_GOALS,))
  data, goals = state.data, state.task.goal
  cost_fn = _keep_in_hand_cost(torch, task._prop_qadr)
  planner = ilqr.ILQR(task, ilqr.ILQRConfig(**ILQR), extra_cost_fn=cost_fn)
  check(planner.model.device.type == 'cuda' and
        (planner.nx, planner.nu) == (61, 20), 'planner model')
  t0 = time.perf_counter()
  small = ilqr.ILQR(task, ilqr.ILQRConfig(**dict(ILQR, horizon=2)),
                    extra_cost_fn=cost_fn)
  small.solve(data, goals, small.init_state(streams=ILQR_GOALS))
  torch.cuda.synchronize()
  warm_s = time.perf_counter() - t0

  st0 = planner.init_state(streams=ILQR_GOALS)
  torch.cuda.reset_peak_memory_stats()
  base_mem = torch.cuda.memory_allocated()
  reset_counts(pkg)
  t0 = time.perf_counter()
  ((action, st), iters), seen = _capture_first(
      lc, ['_rule_resolve'], lambda: _solve_recording(planner, data, goals,
                                                       st0))
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = read_counts(pkg)
  peak = torch.cuda.max_memory_allocated()
  want = _ilqr_launches(ILQR, planner.n_plan_substeps)
  check({k: launches[k] for k in want} == want,
        f'ilqr launches {launches}, want {want}')
  lo, hi = planner._lo, planner._hi
  check(bool(torch.isfinite(action).all()), 'ilqr: non-finite actions')
  check(bool(((action >= lo) & (action <= hi)).all()),
        'ilqr: actions off range')
  per_iter = _check_no_regress(torch, 'ilqr', iters)
  # The nominal's cost at G rows, beside its replay at L x G rows in the
  # first iteration: the two batches round apart, and the contact
  # dynamics carry that over 32 steps.
  nominal = planner.trajectory_cost(data, goals, planner._pack(data), st0.us)
  tangent = _tangent_holds(torch, lc, seen, 'ilqr')

  # The first iteration's linearization (K1's first launch in it kept
  # for the kernels line) and backward pass from the mid-range plan: the
  # steps whose gains are NaN (a quu factorization that failed), and the
  # linearization hold against the CPU float64 port.
  xs0 = planner._rollout(data, planner._pack(data), st0.us)
  lin0, k1_seen = _capture_first(
      lc, ['cholesky_solve_factor'],
      lambda: planner._linearize(data, goals, xs0, st0.us))
  reg0 = torch.full((ILQR_GOALS,), ILQR['reg_init'], dtype=planner.dtype,
                    device=data.qpos.device)
  ks0, _ = planner._backward_pass(*lin0, reg0)
  nan_gain_steps = torch.isnan(ks0).any(-1).sum(-1).tolist()
  cpu = ilqr.ILQR(task, ilqr.ILQRConfig(**ILQR), extra_cost_fn=cost_fn,
                  device='cpu', dtype=torch.float64)
  cpu32 = ilqr.ILQR(task, ilqr.ILQRConfig(**ILQR), extra_cost_fn=cost_fn,
                    device='cpu', dtype=torch.float32)
  hold = _lin_hold(torch, pkg, planner, cpu, cpu32, data, goals, xs0, st0.us,
                   lin0)
  busy_ms, windows = _ilqr_busy(torch, planner, data, goals, st0.us, xs0,
                                lin0, reg0, ILQR['iterations'])
  emit({'phase': 'ilqr', 'start': 'GoalEnvironment.reset',
        'goals': ILQR_GOALS, 'config': ILQR, 'reduced': [],
        'nx': planner.nx, 'nu': planner.nu,
        'linearization_rows': ILQR_GOALS * ILQR['horizon'] * 81,
        'wall_s': wall, 'solves_per_s': ILQR_GOALS / wall,
        'warmup_s_h2': warm_s, 'launches': launches,
        'launches_want': want, 'peak_memory_gb': peak / 1e9,
        'memory_before_gb': base_mem / 1e9,
        'device_busy_ms_estimate': busy_ms,
        'device_idle_share_estimate': max(0.0, 1 - busy_ms / (wall * 1e3)),
        'busy_windows': windows, 'cost': st.cost.tolist(),
        'iterations_cost': per_iter, 'nominal_cost_g_rows': nominal.tolist(),
        'linearization_vs_cpu_f64': hold,
        'improved': sum(int((c['kept'][g] < c['alpha0'][g]))
                        for c in per_iter for g in range(ILQR_GOALS)),
        'nan_gain_steps_first_iteration': nan_gain_steps,
        'tangent_launches_vs_plain': tangent, 'card': smi})
  return dict(launches=launches, seen=seen, k1=next(iter(k1_seen.values())),
              planner=planner, data=data, goals=goals, us=st0.us,
              err=max(v for k, v in tangent.items() if k.endswith(
                  ('_rule_resolve', '_rule_resolve_vs_f64'))))


def phase_ilqr_k3(torch, pkg):
  """ILQR.solve at solver_refactor_every = 1 (the reference's round-4
  setting): the exact Newton solves with K3, its tangents through K3's
  rule.  H = 4, 1 iteration, 2 goals: K3's launches exactly, and its
  tangent launch against the plain rule on the path's own inputs."""
  ilqr, manip, lc = pkg['ilqr'], pkg['manipulation'], pkg['linalg_cuda']
  env = manip.load('reorient', 'state_dense')
  gen = torch.Generator().manual_seed(SEED + 7)
  state, _ = env.reset(gen, (ILQR_K3_GOALS,))
  cfg = dict(ILQR, **ILQR_K3)
  planner = ilqr.ILQR(env.task, ilqr.ILQRConfig(**cfg),
                      extra_cost_fn=_keep_in_hand_cost(
                          torch, env.task._prop_qadr))
  st0 = planner.init_state(streams=ILQR_K3_GOALS)
  reset_counts(pkg)
  t0 = time.perf_counter()
  (action, st), seen = _capture_first(
      lc, ['_rule_solve'], lambda: planner.solve(state.data, state.task.goal,
                                                 st0))
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = read_counts(pkg)
  want = _ilqr_launches(cfg, planner.n_plan_substeps)
  check({k: launches[k] for k in want} == want,
        f'ilqr_k3 launches {launches}, want {want}')
  check(bool(torch.isfinite(action).all() and torch.isfinite(st.cost).all()),
        'ilqr_k3: non-finite')
  check(set(seen) == {('_rule_solve', 'jvp')},
        f'ilqr_k3 tangent launches {set(seen)}')
  tangent = _tangent_holds(torch, lc, seen, 'ilqr_k3')
  emit({'phase': 'ilqr_k3', 'goals': ILQR_K3_GOALS, 'config': cfg,
        'reduced': ['horizon 32 -> 4', 'iterations 4 -> 1', 'goals 8 -> 2'],
        'wall_s': wall, 'launches': launches, 'launches_want': want,
        'tangent_launches_vs_plain': tangent})
  return dict(launches=launches, seen=seen,
              err=max(v for k, v in tangent.items() if k.endswith(
                  ('_rule_solve', '_rule_solve_vs_f64'))))


def phase_sqp(torch, pkg, ilqr_out):
  """SQP.solve at the iLQR phase's configuration with SQP_ITERATIONS
  outer iteration(s), from the same states and goals: wall, exact
  launches, a finite plan within the bounds and a cost no higher than
  its alpha = 0 candidate's."""
  sqp = pkg['sqp']
  base = ilqr_out['planner']
  data, goals = ilqr_out['data'], ilqr_out['goals']
  cfg = dict(ILQR, iterations=SQP_ITERATIONS)
  planner = sqp.SQP(base.task, sqp.SQPConfig(**cfg),
                    extra_cost_fn=base.extra_cost_fn)
  st0 = planner.init_state(streams=ILQR_GOALS)
  reset_counts(pkg)
  t0 = time.perf_counter()
  (action, st), iters = _solve_recording(planner, data, goals, st0)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = read_counts(pkg)
  want = _ilqr_launches(cfg, planner.n_plan_substeps)
  check({k: launches[k] for k in want} == want,
        f'sqp launches {launches}, want {want}')
  per_iter = _check_no_regress(torch, 'sqp', iters)
  # A solve whose every candidate diverged keeps its plan and reports an
  # infinite cost, as the reference does.
  check(bool(torch.isfinite(st.us).all() and not torch.isnan(st.cost).any()),
        'sqp: non-finite plan')
  check(bool(((st.us >= planner._lo) & (st.us <= planner._hi)).all()),
        'sqp: plan off range')
  emit({'phase': 'sqp', 'goals': ILQR_GOALS, 'config': cfg,
        'qp_iterations': planner.config.qp_iterations,
        'reduced': [f'iterations 4 -> {SQP_ITERATIONS}'], 'wall_s': wall,
        'solves_per_s': ILQR_GOALS / wall, 'launches': launches,
        'launches_want': want, 'cost': st.cost.tolist(),
        'iterations_cost': per_iter,
        'improved': sum(int((c['kept'][g] < c['alpha0'][g]))
                        for c in per_iter for g in range(ILQR_GOALS))})


def phase_hybrid(torch, pkg):
  """scripts/eval_ilqr.py's hybrid control step (one_solve, :115-129) for
  HYBRID_GOALS goals from GoalEnvironment.reset, HYBRID_STEPS control
  steps: predictive sampling's solve_batch at its PS configuration, the
  iLQR warm start from its plan, the two trajectory costs that pick the
  seed, ILQR.solve with its iterations cut to 1, then env.step; finished
  episodes frozen as phase_closed_loop freezes them.  Wall per control
  step; no success rate is checked."""
  ilqr, ps, manip = pkg['ilqr'], pkg['ps'], pkg['manipulation']
  structs = pkg['structs']
  env = manip.load('reorient', 'state_dense')
  task = env.task
  dev = env.model.device
  qadr = task._prop_qadr
  ps_planner = ps.PredictiveSampling(
      task, ps.PredictiveSamplingConfig(**HYBRID_PS),
      extra_reward_fn=_keep_in_hand(torch, qadr))
  cfg = dict(ILQR, iterations=1)
  planner = ilqr.ILQR(task, ilqr.ILQRConfig(**cfg),
                      extra_cost_fn=_keep_in_hand_cost(torch, qadr))
  gen = torch.Generator().manual_seed(SEED + 8)
  pgen = torch.Generator(device=dev).manual_seed(SEED + 8)
  state, _ = env.reset(gen, (HYBRID_GOALS,))
  ist = planner.init_state(streams=HYBRID_GOALS)
  pst = ps_planner.init_state(streams=HYBRID_GOALS)
  done = torch.zeros(HYBRID_GOALS, dtype=torch.bool, device=dev)
  walls, parts, picked = [], [], []
  for i in range(HYBRID_STEPS):
    t0 = time.perf_counter()
    data, goals = state.data, state.task.goal
    _, pst2 = ps_planner.solve_batch(data, goals, pst, pgen)
    t_ps = time.perf_counter()
    warm = planner.warm_start(pst2.nominal)
    x0 = planner._pack(data)
    c_warm = planner.trajectory_cost(data, goals, x0, warm.us)
    c_nom = planner.trajectory_cost(data, goals, x0, ist.us)
    take = c_warm < c_nom
    seed = torch.where(take[:, None, None], warm.us, ist.us)
    t_seed = time.perf_counter()
    action, ist2 = planner.solve(data, goals, ilqr.ILQRState(
        us=seed, cost=ist.cost))
    t_solve = time.perf_counter()
    state2, ts = env.step(state, action, gen)
    ended = ts.step_type == 2
    before = state
    state = structs.where_rows(done, state, state2)
    ist = structs.where_rows(done, ist, ist2)
    pst = structs.where_rows(done, pst, pst2)
    if bool(done.any()):
      check(bool((state.data.qpos[done] == before.data.qpos[done]).all()),
            f'hybrid: a frozen episode moved at step {i}')
    done = done | ended
    check(bool(torch.isfinite(action[~done]).all()
               and torch.isfinite(state.data.qpos).all()),
          f'hybrid: non-finite at control step {i}')
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    walls.append(t_end - t0)
    parts.append({'solve_batch_s': t_ps - t0,
                  'warm_start_and_costs_s': t_seed - t_ps,
                  'ilqr_solve_s': t_solve - t_seed,
                  'env_step_s': t_end - t_solve})
    picked.append(int(take.sum()))
  emit({'phase': 'hybrid', 'goals': HYBRID_GOALS, 'steps': HYBRID_STEPS,
        'ps_config': HYBRID_PS, 'ilqr_config': cfg,
        'reduced': ['iLQR iterations 4 -> 1', 'goals 16 -> 4',
                    f'control steps 300 -> {HYBRID_STEPS}'],
        'wall_s_per_control_step': walls, 'parts': parts,
        'sampled_plan_picked': picked, 'ended': int(done.sum()),
        'median_goal_distance': float(
            state.task.goal_distance[:, 0].median())})


def _ik_solvers(pkg, torch):
  """The Adroit IK solver on the card (float32) and on the CPU in float64
  and float32."""
  ik, hands = pkg['ik_solver'], pkg['hands']
  return (ik.IKSolver(hands.AdroitHand()),
          *(ik.IKSolver(hands.AdroitHand(), device='cpu', dtype=dt)
            for dt in (torch.float64, torch.float32)))


def _ik_targets(torch, cpu64, n, seed):
  """n target sets (n, k, 3) in float64: the fingertips' FK at joint
  positions uniform in 0.8 of the ranges (examples/inverse_kinematics.py).
  """
  lo, hi = torch.as_tensor(cpu64._lo), torch.as_tensor(cpu64._hi)
  u = torch.rand((n, lo.shape[0]), generator=torch.Generator().manual_seed(
      seed), dtype=torch.float64)
  return cpu64._tips(cpu64._fk(0.8 * lo + 0.8 * (hi - lo) * u))


def _tf32_round(torch, x):
  """float32 x rounded to TF32's 10-bit mantissa (to nearest, ties to
  even), as a TF32 matrix product rounds its operands."""
  i = x.contiguous().view(torch.int32)
  return ((i + 0xFFF + ((i >> 13) & 1)) & -8192).view(torch.float32)


def _ik_qdot_readings(torch, solver, cpu64, cpu32, inits, targets):
  """The first iteration's q-dot of rows (inits (N, A, nj), targets (N, k,
  3), both float64 on the CPU) against the CPU float64 port at the card's
  float32 states, relative to the reference's max-abs: the card, the CPU
  float32 port, and two card runs with TF32 products: `card_tf32_switch`
  sets torch's TF32 switch (cuBLAS may keep FP32 kernels at these
  shapes), and `card_tf32` (the fault the hold must catch) rounds the
  stacked Jacobian, the operand of JᵀJ and Jᵀv, to TF32."""
  n, a, nj = inits.shape
  q0 = inits.reshape(n * a, nj).to(torch.float32)
  t = targets.to(torch.float32).repeat_interleave(a, dim=0)
  ref = cpu64._qdot(cpu64._fk(q0.double()), t.double())

  def rel(got):
    return ((got.to('cpu', torch.float64) - ref).abs().max()
            / ref.abs().max()).item()

  def card():
    qc, tc = q0.to(solver.model.device), t.to(solver.model.device)
    return solver._qdot(solver._fk(qc), tc)

  out = {'card': rel(card()),
         'cpu_float32': rel(cpu32._qdot(cpu32._fk(q0), t))}
  out['card_tf32_switch'] = tf32(torch, lambda: rel(card()))
  mapper = type(solver._mapper)
  real = mapper.stacked_jacobian
  mapper.stacked_jacobian = lambda self, data: _tf32_round(
      torch, real(self, data))
  try:
    out['card_tf32'] = rel(card())
  finally:
    mapper.stacked_jacobian = real
  return out


def phase_ik_readings(torch, pkg, seeds):
  """The ik phase's q-dot hold on `seeds` (IK_HELD_SETS sets x IK_ATTEMPTS
  attempts each), sound and faulted: the readings IK_QDOT_LIMIT is set
  from."""
  solver, cpu64, cpu32 = _ik_solvers(pkg, torch)
  readings = []
  for seed in seeds:
    targets = _ik_targets(torch, cpu64, IK_HELD_SETS, SEED + 11 + seed)
    inits = cpu64._initial_configurations(
        IK_HELD_SETS, IK_ATTEMPTS, torch.Generator().manual_seed(SEED + seed))
    readings.append({'seed': seed, **_ik_qdot_readings(
        torch, solver, cpu64, cpu32, inits, targets)})
  emit({'phase': 'ik_readings', 'sets': IK_HELD_SETS,
        'attempts': IK_ATTEMPTS, 'readings': readings,
        'sound_max': max(max(r['card'], r['cpu_float32']) for r in readings),
        'faulted_min': min(r['card_tf32'] for r in readings)})


def phase_ik(torch, pkg, smi):
  """IKSolver.solve_batch on the card (Adroit, float32): IK_SETS feasible
  target sets x IK_ATTEMPTS attempts, up to IK_MAX_STEPS steps.  One
  warm-up and IK_TIMED timed calls: target sets/s, the loop's iterations,
  launches per iteration, device busy and idle of one call, peak memory;
  K1-K6 launches (the path runs none).  Holds: each solved set's FK in
  float64 within 1.5 tol of its targets and its joints in range; at least
  IK_SOLVED_MIN solved; all tips 2 m overhead fails; the first
  iteration's q-dot of IK_HELD_SETS sets within IK_QDOT_LIMIT of the CPU
  float64 port, the TF32 fault outside it.  Reported: success agreement
  with the CPU float64 port from the same starts, IK_HELD_SETS sets."""
  solver, cpu64, cpu32 = _ik_solvers(pkg, torch)
  dev = solver.model.device
  check(dev.type == 'cuda' and solver.model.dtype == torch.float32,
        'ik device')
  targets64 = _ik_targets(torch, cpu64, IK_SETS, SEED + 11)
  targets = targets64.to(dev, torch.float32)

  def solve():
    return solver.solve_batch(targets, gen=torch.Generator().manual_seed(
        SEED), linear_tol=IK_TOL, max_steps=IK_MAX_STEPS,
                              num_attempts=IK_ATTEMPTS)

  solve()
  torch.cuda.synchronize()
  reset_counts(pkg)
  torch.cuda.reset_peak_memory_stats()
  walls = []
  for _ in range(IK_TIMED):
    t0 = time.perf_counter()
    qpos, ok = solve()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
  peak = torch.cuda.max_memory_allocated()
  launches = read_counts(pkg)
  check(sum(launches.values()) == 0, f'ik launched {launches}')
  window = _busy_window(torch, solve)
  inits = solver._initial_configurations(
      IK_SETS, IK_ATTEMPTS, torch.Generator().manual_seed(SEED))
  rows = IK_SETS * IK_ATTEMPTS
  _, _, steps = solver._attempt(
      inits.reshape(rows, -1).to(dev, torch.float32),
      targets.repeat_interleave(IK_ATTEMPTS, dim=0), IK_TOL, IK_MAX_STEPS)
  iterations = int(steps.max())

  # Holds: FK of each solved set in float64, the joint limits (the card
  # model's float32 limits), the success count, the overhead set.
  q64 = qpos.to('cpu', torch.float64)
  fk_err = torch.linalg.vector_norm(cpu64._tips(cpu64._fk(q64)) - targets64,
                                    dim=-1).amax(-1)
  solved = ok.cpu()
  check(bool((fk_err[solved] <= 1.5 * IK_TOL).all()),
        f'ik: a solved set misses its targets by {fk_err[solved].max()}')
  check(bool(((q64 >= torch.as_tensor(solver._lo))
              & (q64 <= torch.as_tensor(solver._hi))).all()),
        'ik: a joint outside its range')
  check(int(solved.sum()) >= IK_SOLVED_MIN,
        f'ik: {int(solved.sum())} of {IK_SETS} solved')
  _, over_ok = solver.solve(torch.tensor([[0.0, 0.0, 2.0]] * 5, device=dev),
                            num_attempts=IK_ATTEMPTS)
  check(not bool(over_ok), 'ik: the 2 m overhead targets were solved')
  qdot = _ik_qdot_readings(torch, solver, cpu64, cpu32,
                           inits[:IK_HELD_SETS], targets64[:IK_HELD_SETS])
  if IK_QDOT_LIMIT is not None:
    check(qdot['card'] <= IK_QDOT_LIMIT, f'ik: q-dot vs CPU float64 {qdot}')
    check(qdot['card_tf32'] > IK_QDOT_LIMIT,
          f'ik: the q-dot hold misses TF32 products {qdot}')
  _, ok_cpu = cpu64._best(inits[:IK_HELD_SETS], targets64[:IK_HELD_SETS],
                          IK_TOL, IK_MAX_STEPS)
  emit({'phase': 'ik', 'hand': 'adroit', 'sets': IK_SETS,
        'attempts': IK_ATTEMPTS, 'rows': rows, 'max_steps': IK_MAX_STEPS,
        'tol': IK_TOL, 'wall_s': walls,
        'target_sets_per_s': IK_SETS * len(walls) / sum(walls),
        'iterations': iterations, 'row_steps_median': int(steps.median()),
        'rows_at_max_steps': int((steps == IK_MAX_STEPS).sum()),
        'launches_per_iteration': window['kernel_launches'] / iterations,
        'window': window, 'peak_memory_bytes': peak,
        'solved': int(solved.sum()), 'fk_err_max_solved': float(
            fk_err[solved].max()) if bool(solved.any()) else None,
        'overhead_solved': bool(over_ok),
        'qdot_rel_err': qdot, 'qdot_limit': IK_QDOT_LIMIT,
        'success_equal_cpu_f64': int((ok_cpu == solved[:IK_HELD_SETS]).sum()),
        'success_compared': IK_HELD_SETS, 'kernel_launches': launches,
        'card': smi})


def _wrapped_task(pkg, alpha):
  """reorient.state_dense with its hand effector in
  SmoothAction(PreviousAction(.), alpha)."""
  task = pkg['manipulation'].build_task('reorient', 'state_dense')
  sm, pa = pkg['smooth_action'], pkg['previous_action']
  task._hand_effectors = tuple(sm.SmoothAction(pa.PreviousAction(e), alpha)
                               for e in task._hand_effectors)
  return task


def _wrapped_run(torch, pkg, device, dtype, batch, acts):
  """A BatchedEnvironment of the wrapped reorient task on `device`: reset
  of B_EPISODES episodes (the first `batch` kept), the steps of `acts`
  with WRAP_RESET_ROWS reset before the last.  Returns the run (states
  and time steps after reset and each step, as _episode_errs takes
  them), the state right after the forced reset, and the tries each
  rejection search picked (reset's; the forced reset's)."""
  env = pkg['environment'].GoalEnvironment(_wrapped_task(pkg, WRAP_ALPHA),
                                           device=device, dtype=dtype)
  benv = pkg['batched'].BatchedEnvironment(env, B_EPISODES)
  structs = pkg['structs']
  with _picks(pkg['hands']) as picks:
    state, ts = benv.reset(torch.Generator().manual_seed(SEED + 5))
  state, ts = structs.tree_map(lambda x: x[:batch], (state, ts))
  gen = torch.Generator().manual_seed(SEED + 6)
  states, tss = [state], [ts]
  for i, a in enumerate(acts[:, :batch]):
    if i == len(acts) - 1:
      done = torch.zeros(batch, dtype=torch.bool, device=env.device)
      done[list(WRAP_RESET_ROWS)] = True
      with _picks(pkg['hands']) as reset_picks:
        state = benv._merge_resets(state, done, gen)
      after_reset = state
    state, ts = benv.step(state, a.to(env.device, env.dtype), gen)
    states.append(state)
    tss.append(ts)
  return (states, tss), after_reset, ([p[:ENV_CHECKED] for p in picks],
                                      reset_picks), env


def phase_wrappers(torch, pkg):
  """The effector wrappers in a batched reorient environment on the card
  (B_EPISODES episodes, ENV_STEPS steps, WRAP_RESET_ROWS reset before the
  last), against the same run on the CPU in float64 (its first
  ENV_CHECKED episodes): the state at TASK_LIMITS['reorient'], the
  wrapper state equal (flags exactly, commands within float32 rounding),
  the reset rows' smoothing restarted; then a checkpoint save / load of
  the card's state, bit-equal."""
  structs, ckpt = pkg['structs'], pkg['checkpoint']
  k = ENV_CHECKED
  cpu_env = pkg['environment'].GoalEnvironment(
      _wrapped_task(pkg, WRAP_ALPHA), device='cpu', dtype=torch.float64)
  acts = _task_actions(torch, cpu_env, SEED + 2)
  t0 = time.perf_counter()
  card, card_reset, card_picks, env = _wrapped_run(
      torch, pkg, None, torch.float32, B_EPISODES, acts)
  torch.cuda.synchronize()
  card_wall = time.perf_counter() - t0
  ref, ref_reset, ref_picks, _ = _wrapped_run(torch, pkg, 'cpu',
                                              torch.float64, k, acts)
  prefix = env.task.hand_effectors[0].prefix
  head = ([structs.tree_map(lambda x: x[:k], st) for st in card[0]],
          [structs.tree_map(lambda x: x[:k], t) for t in card[1]])
  other = _other_picks((None, None, card_picks[0]), (None, None,
                                                     ref_picks[0]))
  if any(int(a[i]) != int(b[i]) for a, b in zip(card_picks[1], ref_picks[1])
         for i in range(len(WRAP_RESET_ROWS))):
    other = sorted(set(other) | set(WRAP_RESET_ROWS))
  rows = torch.tensor([i for i in range(k) if i not in other])
  check(len(rows) >= k // 2, f'wrappers: placements differ in {other}')
  errs = _episode_errs(torch, pkg, head, ref, rows)
  for i, e in enumerate(errs):
    check(not _over(e, TASK_LIMITS['reorient']),
          f'wrappers: call {i} vs CPU float64: {e}')
  # The wrapper state, every checked row, after each call.
  eff_err = 0.0
  for st, cst in zip(head[0], ref[0]):
    got, want = st.eff_state[prefix], cst.eff_state[prefix]
    check(sorted(got) == ['previous_action', 'smooth_first', 'smooth_prev'],
          f'wrappers: state keys {sorted(got)}')
    check(bool((got['smooth_first'].cpu() == want['smooth_first']).all()),
          'wrappers: smooth_first differs from the CPU')
    for key in ('smooth_prev', 'previous_action'):
      eff_err = max(eff_err, (_to_cpu64(torch, got[key]) - want[key]).abs()
                    .max().item())
  check(eff_err <= 1e-6, f'wrappers: effector state vs CPU {eff_err}')
  # The reset rows start afresh; the others go on smoothing.
  reset_rows = torch.zeros(B_EPISODES, dtype=torch.bool)
  reset_rows[list(WRAP_RESET_ROWS)] = True
  first = card_reset.eff_state[prefix]['smooth_first'].cpu()
  check(bool((first == reset_rows).all()), f'wrappers: smooth_first {first}')
  last = card[0][-1].eff_state[prefix]['smooth_prev']
  cmd = torch.clamp(acts[-1].to(env.device, env.dtype), env._act_min,
                    env._act_max)
  dev_rows = reset_rows.to(env.device)
  check(torch.equal(last[dev_rows], cmd[dev_rows]),
        'wrappers: a reset row smoothed its first command')
  check(bool(((last[~dev_rows] - cmd[~dev_rows]).abs().amax(-1) > 0).all()),
        'wrappers: a running row stopped smoothing')
  # Checkpoint round trip of the card's last state.
  final = card[0][-1]
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, 'state')
    ckpt.save(path, final)
    back = ckpt.load(path, structs.tree_map(torch.zeros_like, final))
  leaves, got = structs.tree_leaves(final), structs.tree_leaves(back)
  check(len(leaves) == len(got) and all(
      a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
      for a, b in zip(leaves, got)), 'wrappers: checkpoint round trip')
  emit({'phase': 'wrappers', 'batch': B_EPISODES, 'steps': ENV_STEPS,
        'alpha': WRAP_ALPHA, 'reset_rows': list(WRAP_RESET_ROWS),
        'card_wall_s': card_wall, 'cpu_other_try': other,
        'cpu_f64_max_err': {'reset': errs[0], 'steps': errs[1:]},
        'eff_state_max_err': eff_err,
        'checkpoint_leaves': len(leaves), 'checkpoint_bit_equal': True})


# ---------------------------------------------------------------------------
# Multi-device planner and the MJCF toolchain
# ---------------------------------------------------------------------------


def phase_sharded(torch, pkg, planner_out):
  """sharded_solve_batch at the bench configuration on a world of one
  NCCL rank (a FileStore in a temporary directory, no TCP port), bit-equal
  to solve_batch from the same generator seed, with its K1/K2 launches;
  one MPPI sharded_solve bit-equal to solve; the all-gather's time."""
  import dataclasses

  import torch.distributed as dist
  sharding, distributed = pkg['sharding'], pkg['distributed']
  types = pkg['types']
  planner = planner_out['planner']
  data_b, goals = planner_out['data'], planner_out['goals']
  dev = planner.device
  per_solve = ITERATIONS * H * planner.n_plan_substeps * 2

  def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        (a[0], a[1].nominal, a[1].best_return),
        (b[0], b[1].nominal, b[1].best_return)))

  def timed(fn):
    torch.cuda.synchronize()
    reset_counts(pkg)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts(pkg)

  def launches_ok(launches):
    return (launches['cholesky_solve_factor'] == per_solve
            and launches['cholesky_resolve_const'] == per_solve
            and launches['cholesky_solve'] == 0
            and launches['cholesky_factor'] == 0
            and launches['tree_sweep_fk'] == launches['tree_sweep_dyn'] == 0)

  with tempfile.TemporaryDirectory() as tmp:
    check(sharding.initialize_distributed(f'file://{tmp}/store', 1, 0),
          'no process group')
    try:
      check(dist.get_backend() == 'nccl', f'backend {dist.get_backend()}')
      mesh = sharding.make_mesh()
      check(mesh.size() == 1 and mesh.device_type == 'cuda', 'mesh')
      calls = []
      for i in range(1 + SHARDED_TIMED):
        seed = SEED + 10 + i
        pst = planner.init_state(streams=STREAMS)
        sharded, wall_s, launches = timed(
            lambda: distributed.sharded_solve_batch(
                planner, mesh, data_b, goals, pst,
                torch.Generator(device=dev).manual_seed(seed)))
        plain, wall_u, _ = timed(lambda: planner.solve_batch(
            data_b, goals, pst, torch.Generator(device=dev).manual_seed(seed)))
        check(same(sharded, plain),
              f'sharded_solve_batch differs from solve_batch (call {i})')
        check(launches_ok(launches), f'sharded launches {launches}')
        calls.append({'warmup': i == 0, 'seed': seed,
                      'sharded_wall_s': wall_s, 'solve_batch_wall_s': wall_u,
                      'launches': launches})
      # MPPI: the planner's selection rule read at call time.
      saved = planner.config
      planner.config = dataclasses.replace(saved,
                                           temperature=MPPI_TEMPERATURE)
      try:
        data0 = types.map_data(data_b, lambda x: x[0])
        pst0 = planner.init_state()
        mppi_s, mppi_wall, mppi_launches = timed(
            lambda: distributed.sharded_solve(
                planner, mesh, data0, goals[0], pst0,
                torch.Generator(device=dev).manual_seed(SEED + 20)))
        mppi_u, mppi_wall_u, _ = timed(lambda: planner.solve(
            data0, goals[0], pst0,
            torch.Generator(device=dev).manual_seed(SEED + 20)))
      finally:
        planner.config = saved
      check(same(mppi_s, mppi_u), 'MPPI sharded_solve differs from solve')
      check(launches_ok(mppi_launches), f'MPPI launches {mppi_launches}')
      check(bool(torch.isfinite(mppi_s[0]).all()), 'non-finite MPPI action')
      # The all-gather of one iteration's returns (G·N floats), back to
      # back: its share of a sharded call.
      returns = torch.zeros(STREAMS * SAMPLES, dtype=planner.dtype,
                            device=dev)
      group = mesh.get_group()
      gather_ms = _call_ms(
          torch, lambda: distributed.gather_rows(returns, group), GATHER_REPS)
    finally:
      dist.destroy_process_group()
  timed_calls = calls[1:]
  emit({'phase': 'sharded', 'backend': 'nccl', 'world': 1,
        'store': 'FileStore',
        'config': {'streams': STREAMS, 'samples': SAMPLES,
                   'iterations': ITERATIONS, 'horizon': H, **PLAN},
        'calls': calls, 'bit_equal_to_solve_batch': True,
        'sharded_wall_s_per_call': [c['sharded_wall_s'] for c in timed_calls],
        'solve_batch_wall_s_per_call': [c['solve_batch_wall_s']
                                        for c in timed_calls],
        'launches_per_call': calls[-1]['launches'],
        'mppi': {'temperature': MPPI_TEMPERATURE, 'bit_equal_to_solve': True,
                 'sharded_wall_s': mppi_wall, 'solve_wall_s': mppi_wall_u,
                 'launches': mppi_launches,
                 'best_return': float(mppi_s[1].best_return)},
        'all_gather_ms': gather_ms,
        'all_gather_bytes': returns.numel() * returns.element_size(),
        'all_gathers_per_call': ITERATIONS + 1})


def _model_diff(torch, types, m0, m1):
  """A reparsed model against the original: every field, the geom rows
  the export keeps (all but mesh geoms) and the pair tables by geom name.
  Returns (structure differences, largest relative difference of a float
  array, its field)."""
  import dataclasses
  keep = [i for i in range(m0.ngeom)
          if m0.geom_type[i] != int(types.GeomType.MESH)]
  keep_t = torch.as_tensor(keep, dtype=torch.int64, device=m0.device)
  bad, worst, where = [], 0.0, None
  for f in dataclasses.fields(types.Model):
    if not f.init:
      continue
    a, b = getattr(m0, f.name), getattr(m1, f.name)
    if f.name == 'opt':
      for o in dataclasses.fields(a):
        x, y = getattr(a, o.name), getattr(b, o.name)
        if not (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y):
          bad.append(f'opt.{o.name}')
      continue
    if f.name == 'ngeom':
      a = len(keep)
    elif f.name in ('pair_geom1', 'pair_geom2'):
      a = tuple(m0.geom_names[i] for i in a)
      b = tuple(m1.geom_names[i] for i in b)
    elif f.name.startswith('geom_'):
      a = a[keep_t] if isinstance(a, torch.Tensor) else tuple(
          a[i] for i in keep)
    if not isinstance(a, torch.Tensor):
      if a != b:
        bad.append(f.name)
      continue
    if a.shape != b.shape or a.dtype != b.dtype:
      bad.append(f'{f.name} shape')
      continue
    if not a.is_floating_point():
      if not torch.equal(a, b):
        bad.append(f.name)
      continue
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
      bad.append(f'{f.name} non-finite')
      continue
    if bool(fa.any()):
      rel = ((a - b).abs()[fa] / a.abs()[fa].clamp_min(1e-30)).max().item()
      if rel > worst:
        worst, where = rel, f.name
  return bad, worst, where


def _mjcf_roll(torch, pkg, model, qpos, ctrl):
  """MJCF_STEPS environment steps (step_n, one substep each, full
  refresh) of the rows from qpos under ctrl: final (qpos, qvel) on the
  CPU in float64, K3 launches, wall."""
  types, step = pkg['types'], pkg['step']
  d = types.make_data(model, (qpos.shape[0],)).replace(
      qpos=qpos.to(model.device, model.dtype))
  torch.cuda.synchronize()
  reset_counts(pkg)
  t0 = time.perf_counter()
  for u in ctrl:
    d = step.step_n(model, d.replace(ctrl=u.to(model.device, model.dtype)),
                    1, refresh='full')
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = read_counts(pkg)
  return (_to_cpu64(torch, d.qpos), _to_cpu64(torch, d.qvel),
          launches['cholesky_solve'], wall)


def _export_at(export, spec, digits):
  """export_mjcf(spec, keep_visual=True) with its vector attributes printed
  at `digits` significant digits (the fault the mjcf hold must catch)."""
  import numpy as np
  fmt = export._fmt
  export._fmt = lambda arr: ' '.join(
      f'{float(x):.{digits}g}' for x in np.atleast_1d(np.asarray(arr)))
  try:
    return export.export_mjcf(spec, keep_visual=True)
  finally:
    export._fmt = fmt


def phase_mjcf(torch, pkg):
  """Each hand and the reorient arena: the port's export_mjcf (visual
  primitives kept), load_mjcf_string on that text, compile() onto the
  card; the reparsed model's arrays held to the original compile's within
  one float32 rounding of the printed precision, and MJCF_BATCH rows
  stepped MJCF_STEPS steps on both models (K3 on both).  The dropped-pair
  set travels beside the text: MJCF cannot express it (export.py).  The
  same run with the export printed at 6 digits is the fault."""
  export, parser, types = pkg['export'], pkg['parser'], pkg['types']
  hands = pkg['hands']
  specs = {'shadow': hands.ShadowHandSeriesE().spec,
           'adroit': hands.AdroitHand().spec,
           'mpl_right': hands.MPLHand().spec,
           'reorient_arena': pkg['manipulation'].build_task(
               'reorient', 'state_dense').arena.spec}
  rows = {}
  for name, spec in specs.items():
    t0 = time.perf_counter()
    xml = export.export_mjcf(spec, keep_visual=True)
    reparsed = parser.load_mjcf_string(xml)
    host_s = time.perf_counter() - t0
    faulted = parser.load_mjcf_string(_export_at(export, spec, 6))
    for s in (reparsed, faulted):
      s.pruned_pairs = set(spec.pruned_pairs)
    m0, m1, m6 = spec.compile(), reparsed.compile(), faulted.compile()
    check(m1.device.type == 'cuda' and m1.dtype == torch.float32,
          f'{name}: reparsed model not on the card')
    bad, rel, field = _model_diff(torch, types, m0, m1)
    check(not bad, f'{name}: reparsed model structure differs: {bad}')
    check(rel <= MJCF_ARRAY_RTOL,
          f'{name}: reparsed {field} differs by {rel} relative')
    _, rel6, field6 = _model_diff(torch, types, m0, m6)
    gen = torch.Generator().manual_seed(SEED + 30)
    qpos = _hinge_starts(torch, types, m0, MJCF_BATCH, gen)
    ctrl = controls(torch, m0, MJCF_STEPS, MJCF_BATCH, gen)
    runs = {k: _mjcf_roll(torch, pkg, m, qpos, ctrl)
            for k, m in (('original', m0), ('reparsed', m1),
                         ('faulted', m6))}
    q0, v0, k3, wall = runs['original']
    for k, (q, v, k3_k, _) in runs.items():
      check(bool(torch.isfinite(q).all() and torch.isfinite(v).all()),
            f'{name}: non-finite state ({k})')
      check(k3_k == k3 > 0, f'{name}: K3 launches {k3_k} ({k}) vs {k3}')
    readings = {k: {'qpos': (runs[k][0] - q0).abs().max().item(),
                    'qvel': (runs[k][1] - v0).abs().max().item()}
                for k in ('reparsed', 'faulted')}
    held = {q: readings['reparsed'][q] <= MJCF_LIMITS[q]
            for q in MJCF_LIMITS}
    check(all(held.values()),
          f'{name}: reparsed state off the original: {readings}')
    rows[name] = {
        'export_chars': len(xml), 'export_parse_s': host_s,
        'ngeom': [m0.ngeom, m1.ngeom], 'npair': m1.npair, 'nv': m1.nv,
        'array_max_rel': rel, 'array_max_rel_field': field,
        'faulted_array_max_rel': rel6, 'faulted_array_field': field6,
        'k3_launches': k3, 'wall_s_per_roll': wall, 'readings': readings}
  emit({'phase': 'mjcf', 'batch': MJCF_BATCH, 'steps': MJCF_STEPS,
        'limits': MJCF_LIMITS, 'array_rtol': MJCF_ARRAY_RTOL,
        'fault': 'export printed at 6 significant digits', 'models': rows})


def phase_prune(torch, pkg):
  """pair_distance_stats of the reorient arena on the card in float32
  against the CPU float64 port on the same draws.  Held where the
  classification reads them, within PRUNE_RANGE of contact: the min,
  reference-pose and median distances of the pairs both give as
  distances (PRUNE_LIMITS['stats']); no sample on the other side of 0
  beyond PRUNE_LIMITS['sample'] (the overlap fractions); the dropped-pair
  set equal but for pairs within the limit of a threshold (listed).  The
  CPU float32 port and bfloat16 joint draws on the card (the fault) are
  read beside."""
  import numpy as np
  prune = pkg['prune']
  spec = pkg['manipulation'].build_task('reorient', 'state_dense').arena.spec
  card = spec.compile()
  cpu64 = spec.compile(device='cpu', dtype=torch.float64)
  cpu32 = spec.compile(device='cpu', dtype=torch.float32)
  torch.cuda.synchronize()
  reset_counts(pkg)
  t0 = time.perf_counter()
  d_card = prune.per_sample_distances(card, PRUNE_SAMPLES, SEED)
  torch.cuda.synchronize()
  card_s = time.perf_counter() - t0
  launches = read_counts(pkg)
  check(not any(launches.values()), f'pruning launched {launches}')
  t0 = time.perf_counter()
  d64 = prune.per_sample_distances(cpu64, PRUNE_SAMPLES, SEED)
  cpu64_s = time.perf_counter() - t0
  d32 = prune.per_sample_distances(cpu32, PRUNE_SAMPLES, SEED)
  draws = prune._sample_qpos
  prune._sample_qpos = lambda *a: torch.as_tensor(draws(*a)).to(
      torch.bfloat16).double().numpy()
  try:
    d_bf16 = prune.per_sample_distances(card, PRUNE_SAMPLES, SEED)
  finally:
    prune._sample_qpos = draws
  big = 1e9          # the narrow phase's no-contact distance is 1e10
  ref = prune.distance_stats(d64)

  def reading(d):
    """Against the float64 port: the largest min / reference-pose /
    median difference over pairs both give as distances within
    PRUNE_RANGE, the largest per-sample difference within it, the
    entries beyond it off by more than the sample limit, and the pairs
    one side gives as no contact within it (the narrow phase dropping
    every point of the pair as a duplicate or invalid)."""
    d = d.to('cpu', torch.float64)
    st = prune.distance_stats(d)
    stat_err = 0.0
    for k in (0, 1, 3):
      a, b = st[k], ref[k]
      held = (a < big) & (b < big) & (b < PRUNE_RANGE)
      if held.any():
        stat_err = max(stat_err, float(np.abs(a - b)[held].max()))
    both = (d < big) & (d64 < big)
    in_range = both & (d64 < PRUNE_RANGE)
    diff = (d - d64).abs()
    flips = ((d < big) != (d64 < big)) & (torch.minimum(d, d64) < PRUNE_RANGE)
    return dict(stats=stat_err, sample=diff[in_range].max().item(),
                far_outliers=int((diff > PRUNE_LIMITS['sample'])[
                    both & ~in_range].sum()),
                flip_pairs=sorted(set(torch.nonzero(flips)[:, 1].tolist()))
                ), st

  readings = {}
  readings['card_f32'], st_card = reading(d_card)
  readings['cpu_f32'], _ = reading(d32)
  readings['card_bf16_qpos'], _ = reading(d_bf16)
  sound = readings['card_f32']
  check(sound['stats'] <= PRUNE_LIMITS['stats'],
        f'prune statistics off the CPU float64 port by {sound["stats"]}')
  check(sound['sample'] <= PRUNE_LIMITS['sample'],
        f'a sampled distance off the CPU float64 port by {sound["sample"]}')
  dc = d_card.to('cpu', torch.float64)
  side = (dc < 0) != (d64 < 0)
  far_side = int((side & (d64.abs() > PRUNE_LIMITS['sample'])).sum())
  check(far_side == 0, f'{far_side} samples change sides of 0 beyond the '
                       f'limit')
  names = [tuple(sorted((card.geom_names[card.pair_geom1[p]],
                         card.geom_names[card.pair_geom2[p]])))
           for p in range(card.npair)]
  explicit = {tuple(sorted((p.geom1, p.geom2))) for p in spec.pairs}
  dropped_card, far_c, art_c = prune.dropped_pairs(card, st_card, explicit,
                                                   PRUNE_NEAR)
  dropped_ref, far_r, art_r = prune.dropped_pairs(cpu64, ref, explicit,
                                                  PRUNE_NEAR)
  lim = PRUNE_LIMITS['stats']
  near_threshold = []
  for key in sorted(dropped_card ^ dropped_ref):
    p = names.index(key)
    # Within the limit of a threshold: `near`, 0 for the reference pose,
    # -3 mm for the median, a sample on the other side of 0 (the overlap
    # fractions), or a pair one side gives as no contact.
    near = (abs(ref[0][p] - PRUNE_NEAR) <= lim or abs(ref[1][p]) <= lim
            or abs(ref[3][p] + 0.003) <= lim or bool(side[:, p].any())
            or p in sound['flip_pairs'])
    check(near, f'pair {key} dropped on one side only, far from every '
                f'threshold')
    near_threshold.append(list(key))
  for r in readings.values():
    r['flip_pairs'] = len(r['flip_pairs'])
  emit({'phase': 'prune', 'spec': 'reorient.state_dense arena',
        'samples': PRUNE_SAMPLES, 'npair': card.npair, 'range': PRUNE_RANGE,
        'limits': PRUNE_LIMITS, 'readings': readings,
        'samples_changing_side': int(side.sum()),
        'dropped': {'card': len(dropped_card), 'cpu_f64': len(dropped_ref),
                    'far': [far_c, far_r], 'artifact': [art_c, art_r]},
        'dropped_on_one_side_near_threshold': near_threshold,
        'card_s': card_s, 'cpu_f64_s': cpu64_s, 'launches': launches})


# ---------------------------------------------------------------------------
# Rendering: the render meshes, the state's trip to the host, the pixels
# ---------------------------------------------------------------------------


def _mujoco_probe():
  """(the mujoco module or None, the `renderer` entry): the import alone
  decides whether the phase renders (load_pkg imported rendering, which
  sets MUJOCO_GL's default, first)."""
  try:
    import mujoco
  except ImportError as exc:
    return None, f'absent: {exc}'
  return mujoco, (f'mujoco {mujoco.__version__}, '
                  f'MUJOCO_GL={os.environ.get("MUJOCO_GL")}')


def _mesh_exports(pkg):
  """export_mjcf(include_meshes=True) of the reorient and reach arenas
  and of each hand: the mesh assets, every file found under the port's
  assets/meshes and read by mjcf/stl.py with finite vertices, the visual
  mesh geoms (never colliding), the MPL's dual-use visuals and the
  primitives they hide in group 4."""
  import xml.etree.ElementTree as ET

  import numpy as np
  export, hands, stl = pkg['export'], pkg['hands'], pkg['stl']
  root = os.path.join(os.path.dirname(os.path.abspath(pkg['meshes'].__file__)),
                      'assets', 'meshes') + os.sep
  manip = pkg['manipulation']
  specs = {'reorient_arena': manip.build_task('reorient',
                                              'state_dense').arena.spec,
           'reach_arena': manip.build_task('reach', 'state_dense').arena.spec,
           'shadow': hands.ShadowHandSeriesE().spec,
           'adroit': hands.AdroitHand().spec,
           'mpl_left': hands.MPLHand(side=hands.HandSide.LEFT).spec,
           'mpl_right': hands.MPLHand().spec}
  rows = {}
  for name, spec in specs.items():
    t0 = time.perf_counter()
    tree = ET.fromstring(export.export_mjcf(spec, keep_visual=True,
                                            include_meshes=True))
    export_s = time.perf_counter() - t0
    files = [m.get('file') for m in tree.iter('mesh')]
    check(len(files) > 0, f'{name}: no mesh asset in the export')
    outside = [f for f in files if not (
        os.path.realpath(f).startswith(os.path.realpath(root))
        and os.path.isfile(f))]
    check(not outside, f'{name}: mesh files not under {root}: {outside}')
    vertices = 0
    for f in files:
      v = stl.load_stl_vertices(f)
      check(v.shape[0] > 0 and bool(np.isfinite(v).all()),
            f'{name}: {f} has no or non-finite vertices')
      vertices += v.shape[0]
    geoms = list(tree.iter('geom'))
    meshed = [g for g in geoms if g.get('type') == 'mesh']
    check(all(g.get('contype') == g.get('conaffinity') == '0'
              for g in meshed), f'{name}: a visual mesh geom collides')
    check(all(int(g.get('group')) <= 2 for g in meshed),
          f'{name}: a visual mesh geom outside groups 0-2')
    dual = sum(g.get('name').endswith('__visual') for g in meshed)
    hidden = sum(g.get('group') == '4' for g in geoms
                 if g.get('type') != 'mesh')
    if name.startswith('mpl'):
      check(dual > 0 and hidden >= dual, f'{name}: no dual-use visuals')
    rows[name] = {'mesh_assets': len(files), 'mesh_geoms': len(meshed),
                  'dual_use_visuals': dual, 'primitives_in_group_4': hidden,
                  'stl_vertices': vertices, 'export_s': export_s}
  return rows


def _transfer(torch, pkg):
  """The card's side of the vision path without the renderer: reach
  state_dense at RENDER_B on the card, reset and RENDER_STEPS steps, each
  step followed by rendering.host_state (the one device-to-host copy of
  qpos and mocap a vision step makes), checked equal to the tensors.
  Wall of each step and of each copy; K3's launches."""
  import numpy as np
  rendering = pkg['rendering']
  env = pkg['manipulation'].load('reach', 'state_dense')
  acts = _render_actions(torch, env, SEED, RENDER_STEPS)
  dev, dtype = env.model.device, env.model.dtype
  gen = torch.Generator()
  warm, _ = env.reset(torch.Generator().manual_seed(SEED + 99), (RENDER_B,))
  env.step(warm, acts[0].to(dev, dtype), gen)
  rendering.host_state(warm.data)
  torch.cuda.synchronize()
  reset_counts(pkg)
  state, _ = env.reset(torch.Generator().manual_seed(SEED), (RENDER_B,))
  steps, copies = [], []
  for a in acts:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = env.step(state, a.to(dev, dtype), gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qpos, mpos, mquat = rendering.host_state(state.data)
    t2 = time.perf_counter()
    steps.append((t1 - t0) * 1e3)
    copies.append((t2 - t1) * 1e3)
  launches = read_counts(pkg)
  check(launches['cholesky_solve'] > 0, 'render: K3 was not launched')
  d = state.data
  for got, x in ((qpos, d.qpos), (mpos, d.mocap_pos), (mquat, d.mocap_quat)):
    check(got.shape == tuple(x.shape) and got.dtype == np.float32 and
          np.array_equal(got, x.cpu().numpy()),
          'render: host_state differs from the state')
  return {'task': 'reach.state_dense', 'batch': RENDER_B, 'nq': env.model.nq,
          'nmocap': env.model.nmocap, 'step_ms': steps, 'copy_ms': copies,
          'launches': launches}


def _render_actions(torch, env, seed, steps):
  """(steps, RENDER_B, nu) seeded actions in float64 on the CPU, a band
  of 0.3 of the spec's range around its middle (`controls`' rule)."""
  lo, hi = _action_bounds(torch, env.action_spec())
  agen = torch.Generator().manual_seed(seed + 7)
  u = torch.rand(steps, RENDER_B, lo.shape[0], generator=agen,
                 dtype=torch.float64)
  return lo + (hi - lo) * (0.5 + 0.3 * (u - 0.5))


def _vision_env(pkg, domain, obs_set, **kw):
  observations = pkg['observations']
  preset = getattr(observations.ObservationSet, obs_set)
  if domain == 'reach':
    task = pkg['reach'].reach_task(observation_set=preset,
                                   use_dense_reward=True)
  else:
    task = pkg['reorient'].reorient_task(observation_set=preset)
  return pkg['environment'].GoalEnvironment(task, **kw)


def _vision_run(torch, pkg, env, seed, acts, hinge_nudge=0.0):
  """reset of RENDER_B episodes from `seed` and a step per row of `acts`:
  each call's front_close images as numpy (uint8), the states rendered
  with every hinge moved by `hinge_nudge` rad where it is not 0 (the
  fault; the episode itself is not moved); and the last time step."""
  import numpy as np
  rendering, types = pkg['rendering'], pkg['types']
  hinges = [env.model.jnt_qposadr[j] for j in range(env.model.njnt)
            if env.model.jnt_type[j] == int(types.JointType.HINGE)]
  dev, dtype = env.model.device, env.model.dtype
  gen = torch.Generator()
  state, ts = env.reset(torch.Generator().manual_seed(seed), (RENDER_B,))
  out = []

  def images(state, ts):
    if not hinge_nudge:
      return ts.observation['front_close'].cpu().numpy()
    qpos, mpos, mquat = rendering.host_state(state.data)
    qpos = qpos.copy()
    qpos[..., hinges] += hinge_nudge
    return env.task._camera_obs._renderer.render_batch(
        qpos, mpos, mquat)[..., 0, :, :, :]

  out.append(images(state, ts))
  for a in acts:
    state, ts = env.step(state, a.to(dev, dtype), gen)
    out.append(images(state, ts))
  return np.stack(out), ts


def _pixel_reading(got, ref):
  """The worst over calls of (the share of pixels, counted (y, x) per
  image, whose largest channel difference exceeds PIXEL_LEVEL levels; the
  mean absolute difference over every value, in levels)."""
  import numpy as np
  diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
  share = (diff.max(-1) > PIXEL_LEVEL).reshape(diff.shape[0], -1).mean(-1)
  mean = diff.reshape(diff.shape[0], -1).mean(-1)
  return {'share_over_level': float(share.max()),
          'mean_abs': float(mean.max())}


def _pixel_over(reading):
  return [k for k, lim in PIXEL_LIMITS.items() if not reading[k] <= lim]


def _pixel_readings(torch, pkg, seed, card, cpu64, cpu32=None):
  """One seed's pixel readings on reach VISION_ONLY against the CPU
  float64 port from the same draws: the card (sound), the card with every
  hinge moved by HINGE_NUDGE before rendering and the card with TF32
  products (faulted), and the CPU float32 port (sound) if given."""
  acts = _render_actions(torch, card, seed, RENDER_STEPS)
  ref, _ = _vision_run(torch, pkg, cpu64, seed, acts)
  runs = {'card': lambda: _vision_run(torch, pkg, card, seed, acts),
          'card_hinges_moved': lambda: _vision_run(
              torch, pkg, card, seed, acts, HINGE_NUDGE),
          'card_tf32': lambda: tf32(
              torch, lambda: _vision_run(torch, pkg, card, seed, acts))}
  if cpu32 is not None:
    runs['cpu_float32'] = lambda: _vision_run(torch, pkg, cpu32, seed, acts)
  out = {}
  for what, fn in runs.items():
    r = _pixel_reading(fn()[0], ref)
    out[what] = {**r, 'over_limits': _pixel_over(r)}
  return out


def _vision_throughput(torch, pkg):
  """Reorient state_dense against VISION_ONLY at RENDER_B over
  VISION_STEPS steps (tools/bench_vision.py's measure, zero actions after
  a warm-up step): env steps/s of each; the host ms of rendering per step
  (the camera observables' as_dict, timed) against the rest of the step;
  the device idle share of one vision step."""
  out = {}
  for obs_set in ('STATE_ONLY', 'VISION_ONLY'):
    env = _vision_env(pkg, 'reorient', obs_set)
    gen = torch.Generator()
    state, _ = env.reset(torch.Generator().manual_seed(SEED), (RENDER_B,))
    zeros = torch.zeros(RENDER_B, env.action_spec().shape[0],
                        device=env.model.device)
    state, _ = env.step(state, zeros, gen)
    cams = env.task._camera_obs
    render_ms = []
    if cams.enabled:
      real = cams.as_dict

      def timed(model, data):
        t0 = time.perf_counter()
        out = real(model, data)
        render_ms.append((time.perf_counter() - t0) * 1e3)
        return out

      cams.as_dict = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(VISION_STEPS):
      state, ts = env.step(state, zeros, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    window = _busy_window(torch, lambda: env.step(state, zeros, gen))
    step_ms = wall / VISION_STEPS * 1e3
    row = {'env_steps_per_s': RENDER_B * VISION_STEPS / wall,
           'step_ms': step_ms, 'step_window': window}
    if render_ms:
      render = sum(render_ms[:VISION_STEPS]) / VISION_STEPS
      row.update(render_ms_per_step=render,
                 rest_of_step_ms=step_ms - render,
                 render_share=render / step_ms)
      cams._renderer.close()
    out[obs_set] = row
  return out


def phase_render(torch, pkg):
  """The render slice on the card.  Always: the include_meshes export of
  each arena and hand (_mesh_exports), MuJoCo's presence (`renderer`),
  and the card's side of the vision path (_transfer: a reach step and
  the state's one copy to the host, K3 held above 0).  Where mujoco
  imports: reach VISION_ONLY on the card (front_close (RENDER_B, 84, 84,
  3) uint8 on cuda, not black, the renderer's model with meshes, K3
  launched), the pixel hold against the CPU float64 port at PIXEL_LIMITS
  (faults read beside), and the vision throughput."""
  t_phase = time.perf_counter()
  mujoco, renderer = _mujoco_probe()
  row = {'phase': 'render', 'renderer': renderer,
         'exports': _mesh_exports(pkg), 'transfer': _transfer(torch, pkg)}
  if mujoco is not None:
    card = _vision_env(pkg, 'reach', 'VISION_ONLY')
    acts = _render_actions(torch, card, SEED, RENDER_STEPS)
    reset_counts(pkg)
    imgs, ts = _vision_run(torch, pkg, card, SEED, acts)
    launches = read_counts(pkg)
    check(launches['cholesky_solve'] > 0, 'render: K3 not launched')
    img = ts.observation['front_close']
    check(tuple(img.shape) == (RENDER_B, 84, 84, 3) and
          img.dtype == torch.uint8 and img.is_cuda and int(img.max()) > 0,
          f'render: front_close {tuple(img.shape)} {img.dtype} {img.device}')
    nmesh = card.task._camera_obs._renderer._mm.nmesh
    check(nmesh > 0, 'render: the renderer model has no mesh')
    cpu64 = _vision_env(pkg, 'reach', 'VISION_ONLY', device='cpu',
                        dtype=torch.float64)
    readings = _pixel_readings(torch, pkg, SEED, card, cpu64)
    check(not readings['card']['over_limits'],
          f'render: pixels off the CPU float64 port: {readings["card"]}')
    for env in (card, cpu64):
      env.task._camera_obs._renderer.close()
    row.update(vision={'task': 'reach.VISION_ONLY', 'batch': RENDER_B,
                       'steps': RENDER_STEPS, 'images': list(imgs.shape),
                       'nmesh': nmesh, 'launches': launches},
               pixel_limits=PIXEL_LIMITS, pixel_level=PIXEL_LEVEL,
               pixel_readings=readings,
               throughput=_vision_throughput(torch, pkg))
  else:
    row['pixels'] = 'held on the CPU only (tests/test_torch_rendering.py)'
  row['phase_s'] = time.perf_counter() - t_phase
  emit(row)


def phase_render_readings(torch, pkg, seeds):
  """The pixel hold's readings on `seeds` (PIXEL_LIMITS' source): sound
  (the card; the CPU float32 port) and faulted (hinges moved by
  HINGE_NUDGE; TF32 products), each against the CPU float64 port."""
  mujoco, renderer = _mujoco_probe()
  if mujoco is None:
    emit({'phase': 'render_readings', 'renderer': renderer})
    return
  card = _vision_env(pkg, 'reach', 'VISION_ONLY')
  cpu64, cpu32 = (_vision_env(pkg, 'reach', 'VISION_ONLY', device='cpu',
                              dtype=dt)
                  for dt in (torch.float64, torch.float32))
  readings = {}
  for seed in seeds:
    r = _pixel_readings(torch, pkg, seed, card, cpu64, cpu32)
    for what, v in r.items():
      readings.setdefault(what, []).append({'seed': seed, **v})
  for env in (card, cpu64, cpu32):
    env.task._camera_obs._renderer.close()
  emit({'phase': 'render_readings', 'renderer': renderer,
        'task': 'reach.VISION_ONLY', 'batch': RENDER_B, 'steps': RENDER_STEPS,
        'limits': PIXEL_LIMITS, 'level': PIXEL_LEVEL, 'readings': readings})


# ---------------------------------------------------------------------------
# Timing and the kernel rows
# ---------------------------------------------------------------------------


def _rotating(torch, args, fn):
  """fn over copies of its operands that together hold at least eight
  times the card's L2 cache (L2_BYTES), one copy per call in turn, so
  that each call reads its operands from HBM and its time can be set
  beside the bound.  (With two copies of K2's (20,736, 30, 30) operands,
  of which the kernel reads one triangle, 87 MB in all, K2 read 7.6-31
  us against its 13.0 us bound in three runs: L2 still served part.)"""
  nbytes = sum(a.numel() * a.element_size() for a in args)
  copies = [tuple(a.clone() for a in args)
            for _ in range(max(2, -(-8 * L2_BYTES // nbytes)))]
  turn = itertools.count()
  return lambda: fn(*copies[next(turn) % len(copies)])


def _ilqr_rows(torch, lc, ilqr_out, k3_out):
  """The kernels line's rows of the `ilqr` path, on launches captured
  from it: K1 on its first launch in the linearization, K2 on its first
  tangent launch, K3 on the refactor-1 run's first tangent launch, each
  held against its plain version and float64 and timed over operand
  copies larger than L2 (_rotating).  Launches from the phases' counted
  solves."""
  h1, g1 = ilqr_out['k1']
  k1_err = _vs_plain(torch, lc, 'cholesky_solve_factor', h1, g1,
                     'ilqr linearization, first K1 launch')['']
  fac, dg = ilqr_out['seen'][('_rule_resolve', 'jvp')]
  h3, g3 = k3_out['seen'][('_rule_solve', 'jvp')]
  specs = (
      ('cholesky_solve_factor', (h1, g1), 'solve_factor', ilqr_out, k1_err,
       lc.cholesky_solve_factor, lc.solve_factor_plain),
      ('cholesky_resolve_const', (fac, dg), 'resolve', ilqr_out,
       ilqr_out['err'], lc.cholesky_resolve_const, lc.resolve_plain),
      ('cholesky_solve', (h3, g3), 'solve', k3_out, k3_out['err'],
       lc.cholesky_solve, lc.solve_plain))
  rows = []
  for name, args, kind, out, err, wrapper, plain in specs:
    fn = _rotating(torch, args, wrapper)
    ms, names = _device_profile(torch, fn, 100, (lc.launches,))
    if kind == 'resolve':
      # The library's resolve takes an L with the diagonal in place.
      f64 = args[0].double()
      ll = (torch.tril(f64, -1) + torch.diag_embed(
          1 / torch.diagonal(f64, dim1=-2, dim2=-1))).float()
      lib = _rotating(torch, (args[1], ll),
                      lambda g, l: torch.cholesky_solve(g[..., None], l))
    else:
      lib = _rotating(torch, args, lambda h, g: torch.cholesky_solve(
          g[..., None], torch.linalg.cholesky_ex(h)[0]))
    a = args[0]
    rows.append((name, {
        'max_abs_err': err, 'ms': ms, 'kernel_ms': ms,
        'design': _ran_design(names), 'operands': 'rotating, > 8 x L2',
        'device_ms_by_kernel': names,
        **_timing_row(torch, fn, _rotating(torch, args, plain), lib,
                      a.shape[0], a.shape[-1], kind),
        'path': 'ilqr', 'launches': out['launches'][name]}))
  return rows


def _state_errs(torch, card, ref, k):
  """Max-abs errors of the first k environments of a card Data against a
  float64 CPU Data: qpos, qvel, and the frames relative to their
  max-abs."""
  def err(a, b):
    return (a[:k].double().cpu() - b).abs().max().item()

  out = {'qpos': err(card.qpos, ref.qpos), 'qvel': err(card.qvel, ref.qvel)}
  for f in ('xpos', 'geom_xpos'):
    want = getattr(ref, f)
    out[f + '_rel'] = err(getattr(card, f), want) / max(
        want.abs().max().item(), 1e-12)
  return out


def _busy_window(torch, fn, counters=()):
  """Wall time of one call of fn (ended by a synchronize) under the
  profiler, the device time its kernels took, the idle share and the
  kernel launches; a window that stands (_profiled)."""
  kern, wall_ms = _profiled(torch, fn, 1, counters)
  busy_us = sum(e.self_device_time_total for e in kern)
  return {'wall_ms': wall_ms, 'device_busy_ms': busy_us / 1e3,
          'device_idle_share': max(0.0, 1 - busy_us / 1e3 / wall_ms),
          'kernel_launches': sum(e.count for e in kern)}


def _call_ms(torch, fn, reps):
  """Per-call time of back-to-back calls, host work included: what the
  path pays for one call."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / reps


def _device_profile(torch, fn, reps, counters=()):
  """Per-call device time of `fn` (the summed durations of the kernels it
  launches over `reps` calls, from torch.profiler; host work and waits
  between kernels are not counted) and each kernel's per-call time by
  name, from a window that stands (_profiled)."""
  fn()
  torch.cuda.synchronize()
  kern, _ = _profiled(torch, fn, reps, counters)
  return (sum(e.self_device_time_total for e in kern) / 1e3 / reps,
          {e.key: e.self_device_time_total / 1e3 / reps for e in kern})


# torch.profiler drops kernel records of a window on the H100, mostly its
# first ones: none early in a run, more as it goes on, up to all 64 spin
# kernels below late in it; once 28 of 100 counted launches after 64
# recorded spins.  So each window opens with SPIN_PREROLL spin kernels,
# left out of its sums, and stands where its kernels took device time
# and, given the wrappers' launch counters, it holds a record of every
# counted launch, or, with none, some spin kernels were recorded (the drop
# ended inside them).
SPIN_PREROLL = 64
_SPIN = 'spin_kernel'
# The kernels whose wrappers count their launches (linalg_cuda.launches,
# tree_cuda.launches), by a part of their names.
_COUNTED_KERNELS = ('cholesky_kernel', 'cholesky_regs_', 'cholesky_wide_',
                    'tree_fk_kernel', 'tree_dyn_kernel')
# For the `profiler_passes` line: the windows, how many had each number of
# records dropped, and the windows that did not stand.
PROFILER_PASSES = {'windows': 0, 'dropped_records': {}, 'not_standing': []}


def _counted(counters):
  return sum(sum(c.values()) for c in counters)


def _profiled(torch, fn, reps, counters=()):
  """The CUDA kernel records of `reps` calls of fn (the spin pre-roll's
  left out) from the first window that stands, and its wall ms from the
  first call to the synchronize after the last; the pre-roll doubles on
  each retry, up to five windows."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  for attempt in range(5):
    spins = SPIN_PREROLL << attempt
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(spins):
        torch.cuda._sleep(100)
      torch.cuda.synchronize()
      before = _counted(counters)
      t0 = time.perf_counter()
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3
    launched = _counted(counters) - before
    cuda = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    kern = [e for e in cuda if _SPIN not in e.key]
    seen = sum(e.count for e in cuda if _SPIN in e.key)
    records = sum(e.count for e in kern
                  if any(p in e.key for p in _COUNTED_KERNELS))
    PROFILER_PASSES['windows'] += 1
    dropped = PROFILER_PASSES['dropped_records']
    dropped[spins - seen] = dropped.get(spins - seen, 0) + 1
    if (sum(e.self_device_time_total for e in kern) > 0 and
        (records == launched if counters else seen > 0)):
      return kern, wall_ms
    PROFILER_PASSES['not_standing'].append({
        'spins': spins, 'spins_seen': seen, 'records': records,
        'launches': launched})
  check(False, f'no profiler window stood in five: '
        f'{PROFILER_PASSES["not_standing"][-5:]}')


def _device_ms(torch, fn, reps, counters=()):
  return _device_profile(torch, fn, reps, counters)[0]


def _ran_design(names):
  """The Cholesky design whose kernel appears in profiled kernel names."""
  if any('cholesky_regs' in k for k in names):
    return 'registers'
  if any('cholesky_wide' in k for k in names):
    return 'wide'
  return 'shared' if any('cholesky_kernel' in k for k in names) else None


def _wide_layout(names):
  """(rows, warps) of the wide design's kernel among profiled kernel
  names (from their template arguments, demangled or mangled), or
  None."""
  for k in names:
    if 'cholesky_wide_' in k:
      m = (re.search(r'<\w+, (\d+), (\d+)[,>]', k) or
           re.search(r'I[fd]Li(\d+)ELi(\d+)E', k))
      return (int(m.group(1)), int(m.group(2))) if m else None
  return None


def _bound(b, n, elem, kind, square=False):
  """Least time (ms) for the work: bytes (each input read once, each
  output written once) over HBM rate vs FMAs over the FP32/FP64 rate.
  A matrix moves one triangle with its diagonal: an SPD matrix is
  determined by it, and a packed factor holds nothing else (PR 8's
  yardstick counted n^2, which K2 beats: PERF.md §6; `square` counts
  that way, for a row to show beside the triangle's)."""
  mat = b * (n * n if square else n * (n + 1) // 2) * elem
  vec = b * n * elem
  if kind == 'solve_factor':
    nbytes = mat + vec + vec + mat
    fmas = b * (n ** 3 / 3 + n * n)
  elif kind == 'resolve':
    nbytes = mat + vec + vec
    fmas = b * n * n
  elif kind == 'factor':
    nbytes = mat + mat
    fmas = b * n ** 3 / 3
  else:
    nbytes = mat + vec + vec
    fmas = b * (n ** 3 / 3 + n * n)
  return _roofline(nbytes, 2 * fmas, elem)


def _roofline(nbytes, flops, elem):
  peak = PEAK_F32_FLOPS if elem == 4 else PEAK_F64_FLOPS
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  t_ops = flops / peak * 1e3
  return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations')


def _tree_bounds(smooth, model, b, elem):
  """(K5, K6) bounds: rows read and written once; flops counted from the
  kernels' arithmetic per item (rounded up)."""
  nb, nv, nq, ng = model.nbody, model.nv, model.nq, model.ngeom
  nt, nm = model.ntendon, model.nmocap
  fk_rows = (nq + nv + 7 * nm) + (10 * nb + 6 * nv + 12 * ng + 10 * nb
                                  + 2 * nt)
  fk_flops = b * (nb * (120 + 150) + nv * 60 + ng * 90 + nt * 2 * (nq + nv))
  # Entries of the CRB pattern (upper triangle and diagonal).
  pattern = int(smooth._dof_upper_mask_np(model).sum())
  dyn_rows = (6 * nv + 10 * nb + nv) + (nv * nv + nv)
  dyn_flops = b * (10 * nb + nv * 36 + pattern * 12 + nv * (12 + 40)
                   + nb * (12 + 72 + 30 + 6 + 6) + nv * 12)
  return (_roofline(fk_rows * b * elem, fk_flops, elem),
          _roofline(dyn_rows * b * elem, dyn_flops, elem))


def phase_kernels(torch, pkg, main):
  """K1-K4 against their plain versions and float64 on seeded and path
  Hessians; their timing rows."""
  lc = pkg['linalg_cuda']
  dev = main['model'].device
  gen = torch.Generator().manual_seed(SEED + 2)
  n = main['model'].nv
  a = torch.randn(B_PLAN, n, n, generator=gen, dtype=torch.float64)
  h64 = (a @ a.transpose(1, 2)) / n + torch.eye(n, dtype=torch.float64)
  g64 = torch.randn(B_PLAN, n, generator=gen, dtype=torch.float64)
  sets = {'seeded': (h64.to(dev).float(), g64.to(dev).float()),
          'path_hessians': (main['hessians']['h'], main['hessians']['g'])}
  check(sets['path_hessians'][0].shape == (B_PLAN, n, n),
        'captured Hessians')
  rows, checks = {}, {}
  for name in ('cholesky_solve_factor', 'cholesky_resolve_const',
               'cholesky_solve', 'cholesky_factor'):
    errs = {}
    for set_name, (h, g) in sets.items():
      for key, v in _vs_plain(torch, lc, name, h, g, set_name).items():
        errs[set_name + key] = v
    checks[name] = errs

    h, g = sets['seeded']
    fac = lc.factor_plain(h)
    g3 = g[..., None]
    if name == 'cholesky_solve_factor':
      fn = lambda: lc.cholesky_solve_factor(h, g)
      plain = lambda: lc.solve_factor_plain(h, g)
      lib = lambda: torch.cholesky_solve(g3, torch.linalg.cholesky_ex(h)[0])
      kind = 'solve_factor'
    elif name == 'cholesky_resolve_const':
      fn = lambda: lc.cholesky_resolve_const(fac, g)
      plain = lambda: lc.resolve_plain(fac, g)
      ll = torch.linalg.cholesky_ex(h)[0]
      lib = lambda: torch.cholesky_solve(g3, ll)
      kind = 'resolve'
    elif name == 'cholesky_factor':
      fn = lambda: lc.cholesky_factor(h)
      plain = lambda: lc.factor_plain(h)
      lib = lambda: torch.linalg.cholesky_ex(h)
      kind = 'factor'
    else:
      fn = lambda: lc.cholesky_solve(h, g)
      plain = lambda: lc.solve_plain(h, g)
      lib = lambda: torch.cholesky_solve(g3, torch.linalg.cholesky_ex(h)[0])
      kind = 'solve'
    # The library yardstick uses cholesky_ex, which does not synchronise to
    # check for failure (torch.linalg.cholesky does).
    mode = {'cholesky_solve_factor': lc._MODE_SOLVE_FACTOR,
            'cholesky_resolve_const': lc._MODE_RESOLVE,
            'cholesky_solve': lc._MODE_SOLVE,
            'cholesky_factor': lc._MODE_FACTOR}[name]
    src = fac if name == 'cholesky_resolve_const' else h
    rhs = None if name == 'cholesky_factor' else g
    prev = lambda: lc._launch(mode, name, src, rhs, design='shared',
                              want_factor=name in ('cholesky_solve_factor',
                                                   'cholesky_factor'))
    ms, extra = _design_turns(torch, lc, name, mode, n, fn, prev)
    if name == 'cholesky_solve':
      # K3 at the environment step's shape as well: its first B_ENV
      # matrices (a contiguous slice).
      he, ge = h[:B_ENV], g[:B_ENV]
      env_ms, env_extra = _design_turns(
          torch, lc, name, mode, n, lambda: lc.cholesky_solve(he, ge),
          lambda: lc._launch(lc._MODE_SOLVE, name, he, ge, design='shared'))
      env_bound, env_by = _bound(B_ENV, n, 4, 'solve')
      extra['env_shape'] = {
          'shape': [B_ENV, n, n], 'ms': env_ms,
          'previous_design_ms': env_extra['previous_design_ms'],
          'turns_ms': env_extra['turns_ms'], 'bound_ms': env_bound,
          'bound_by': env_by,
          'call_ms': _call_ms(torch, lambda: lc.cholesky_solve(he, ge), 100)}
    rows[name] = {
        'max_abs_err': max(checks[name][s] for s in sets), 'ms': ms,
        'kernel_ms': ms, **extra,
        **_timing_row(torch, fn, plain, lib, B_PLAN, n, kind)}
  checks['rank_deficient'] = _rank_deficient_checks(torch, lc, n, dev, gen)
  emit({'phase': 'kernel_checks', 'errors': checks})
  return rows


def _vs_plain(torch, lc, name, h, g, what, fac=None):
  """One kernel against its plain version and against a float64 solve on
  one (h, g), at whatever batch shape the caller passes; K1 and K4's
  factors against the plain factor.  K2 resolves against `fac` when given
  (then h is the matrix it factors), else against factor_plain(h).
  Returns the errors keyed by suffix ('' is the error against the plain
  version)."""
  n = h.shape[-1]
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device=h.device))
  h64d, g64d = h.double(), g.double()
  x_ref = torch.linalg.solve(h64d, g64d)
  # Condition-aware tolerance for float32: kernel and plain version are
  # both backward-stable Choleskys, so they may differ by ~cond * eps.
  ev = torch.linalg.eigvalsh(h64d)
  cond = (ev[..., -1] / ev[..., 0].clamp_min(1e-300)).max().item()
  scale = x_ref.abs().max().item()
  tol = max(1e-4, 100 * cond * 6e-8) * scale
  out = {}
  if name in ('cholesky_solve_factor', 'cholesky_factor'):
    if name == 'cholesky_solve_factor':
      x, fac = lc.cholesky_solve_factor(h, g)
      x_p, fac_p = lc.solve_factor_plain(h, g)
    else:
      # K4, and the K4 + K2 pair's solution.
      fac = lc.cholesky_factor(h)
      fac_p = lc.factor_plain(h)
      x = lc.cholesky_resolve(fac, g)
      x_p = lc.solve_plain(h, g)
    fac_err = (fac - fac_p)[..., low].abs().max().item()
    fac_tol = 1e-4 * fac_p[..., low].abs().max().item()
    check(fac_err <= fac_tol, f'{name} factor {what}: {fac_err}')
    out['_factor'] = fac_err
  elif name == 'cholesky_resolve_const':
    fac = lc.factor_plain(h) if fac is None else fac
    x = lc.cholesky_resolve_const(fac, g)
    x_p = lc.resolve_plain(fac, g)
  else:
    x = lc.cholesky_solve(h, g)
    x_p = lc.solve_plain(h, g)
  err = (x - x_p).abs().max().item()
  err64 = (x.double() - x_ref).abs().max().item()
  check(err <= tol, f'{name} vs plain on {what}: {err} > {tol}')
  check(err64 <= tol, f'{name} vs float64 on {what}: {err64} > {tol}')
  # Backward error |H x - g| / (n |H| |x| + |g|), independent of the
  # conditioning: a float32 Cholesky keeps it near n * eps (~2e-6).
  x64 = x.double()
  res = (h64d @ x64[..., None])[..., 0] - g64d
  bwd = (res.abs().amax(-1) / (n * h64d.abs().amax((-2, -1))
                               * x64.abs().amax(-1)
                               + g64d.abs().amax(-1))).max().item()
  check(bwd <= 1e-4, f'{name} backward error on {what}: {bwd}')
  out.update({'': err, '_vs_f64': err64, '_backward': bwd, '_tol': tol,
              '_cond': cond})
  return out


def _capture_first(lc, names, fn):
  """Runs fn with the wrappers `names` of linalg_cuda patched to keep a
  copy of the inputs of their first call from each calling function
  (keyed (wrapper, caller)); returns fn's result and the copies."""
  seen, real = {}, {nm: getattr(lc, nm) for nm in names}

  def patched(nm):
    def wrapper(*args):
      key = (nm, sys._getframe(1).f_code.co_name)
      if key not in seen:
        seen[key] = tuple(a.detach().clone() for a in args)
      return real[nm](*args)
    return wrapper

  for nm in names:
    setattr(lc, nm, patched(nm))
  try:
    return fn(), seen
  finally:
    for nm in names:
      setattr(lc, nm, real[nm])


def _design_turns(torch, lc, name, mode, n, fn, prev):
  """The design the wrapper ran (`fn`) and the shared-memory design at the
  same inputs (`prev`), timed in turns: new, previous, previous, new, each
  a pass of 100 calls whose 100 kernel records the profiler held (checked
  against the launch counter); also the shared design's back-to-back time
  per call by CUDA events (`previous_design_call_ms`), which its kernel
  time cannot pass.  Returns (ms, the row's design fields);
  fails unless the wrapper ran the design `_design` names for kernel
  `mode` at this n (float32), and that design is not the shared one."""
  turns = [_device_profile(torch, f, 100, (lc.launches,))
           for f in (fn, prev, prev, fn)]
  ran = {_ran_design(names) for _, names in turns[::3]}
  ran_prev = {_ran_design(names) for _, names in turns[1:3]}
  design = lc._design(n, torch.float32, mode)
  check(ran == {design} and design != 'shared' and ran_prev == {'shared'},
        f'{name} at n={n}: ran {ran}, previous {ran_prev}')
  layout = None
  if design == 'wide':
    layouts = {_wide_layout(names) for _, names in turns[::3]}
    layout = (64, 2) if n <= 64 else (80, 3)
    check(layouts == {layout}, f'{name} at n={n}: wide layouts {layouts}')
  return (turns[0][0] + turns[3][0]) / 2, {
      'design': design, 'layout': layout,
      'previous_design': 'shared',
      'previous_design_ms': (turns[1][0] + turns[2][0]) / 2,
      'previous_design_call_ms': _call_ms(torch, prev, 100),
      'turns_ms': {'design': [turns[0][0], turns[3][0]],
                   'previous_design': [turns[1][0], turns[2][0]]},
      'profiler_records_per_turn': 100}


def _rank_deficient_checks(torch, lc, n, dev, gen):
  """K1, K2 and K4 against their plain versions on a rank-deficient batch:
  seeded SPD matrices with every third dof's row and column zeroed (a dof
  the Hessian does not see).  Those pivots are exact zeros at every step,
  so the clamp rsqrt(max(a_kk, 1e-12)) gives 1e6 in both versions and the
  outputs stay finite (x_k = g_k 1e12 there).  x and K1's and K4's factors
  agree with the plain versions on the kept and on the zeroed dofs, each
  part to 1e-4 of its own max-abs.  (A V V^T batch of rank 2 is no test of the clamp in float32:
  its Schur complement is rounding noise, the noise's negative pivots
  grow the next ones, and kernel and plain version both overflow.)"""
  a = torch.randn(B_PLAN, n, n, generator=gen, dtype=torch.float64)
  h = a @ a.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64)
  keep = (torch.arange(n) % 3 != 1).double()
  h = (h * keep[:, None] * keep[None, :]).to(dev).float()
  g = torch.randn(B_PLAN, n, generator=gen, dtype=torch.float64).to(
      dev).float()
  x, fac = lc.cholesky_solve_factor(h, g)
  x_p, fac_p = lc.solve_factor_plain(h, g)
  x2 = lc.cholesky_resolve_const(fac_p, g)
  x2_p = lc.resolve_plain(fac_p, g)
  fac4 = lc.cholesky_factor(h)
  for what, t in (('K1 x', x), ('K1 factor', fac), ('K2 x', x2),
                  ('K4 factor', fac4)):
    check(bool(torch.isfinite(t).all()), f'{what} not finite, rank-deficient')
  # The kept dofs' values are O(1) and the zeroed dofs' ~1e12 (x) or 1e6
  # (the factor's diagonal): each part is held to 1e-4 of its own max-abs.
  kept = keep.bool().to(dev)
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device=dev))
  fac_kept = low & kept[:, None] & kept[None, :]
  parts = {'K1_x': (x, x_p, kept), 'K2_x': (x2, x2_p, kept),
           'K1_factor': (fac, fac_p, fac_kept),
           'K4_factor': (fac4, fac_p, fac_kept)}
  errs = {'zeroed_dofs': int(n - keep.sum().item())}
  for what, (got, want, mask) in parts.items():
    other = (low & ~fac_kept) if what.endswith('_factor') else ~mask
    for part, m in (('kept', mask), ('zeroed', other)):
      err = (got[:, m] - want[:, m]).abs().max().item()
      scale = want[:, m].abs().max().item()
      check(err <= 1e-4 * scale,
            f'{what} vs plain on the {part} dofs, rank-deficient: {err} > '
            f'1e-4 * {scale}')
      errs[f'{what}_{part}'] = err
      errs[f'{what}_{part}_scale'] = scale
  return errs


def phase_juggle_size(torch, pkg, dev, n=JUGGLE_NV):
  """K1-K4 at (B_PLAN, n, n) float32 on seeded SPD matrices, which no path
  of the port gives them (a refactoring Newton solve on the juggle model
  would run K1 and K2 at nv = 62): a counted run of the cholesky_factor /
  cholesky_resolve, cholesky_solve_factor and cholesky_solve entry points
  (one launch each), then for each kernel timed here its agreement with
  its plain version, the design that ran, its device time and
  _timing_row's fields (with the bound counting n^2 beside it).  Each
  kernel runs the wide design at n and is timed in turns with the shared
  design (_design_turns): K1, K2 and K4 at juggle's nv = 62 (K3 is timed
  on juggle's own Hessians there, `k3_task_sizes`), K1-K4 at N_TOP = 80,
  the top of the JAX package's Pallas range.  Returns the rows and the
  entry points' launches."""
  t_phase = time.perf_counter()
  lc = pkg['linalg_cuda']
  juggle = n == JUGGLE_NV
  gen = torch.Generator().manual_seed(SEED + (5 if juggle else 6))
  a = torch.randn(B_PLAN, n, n, generator=gen, dtype=torch.float64)
  h = ((a @ a.transpose(1, 2)) / n + torch.eye(n, dtype=torch.float64)).to(
      dev).float()
  g = torch.randn(B_PLAN, n, generator=gen, dtype=torch.float64).to(
      dev).float()
  fac = lc.factor_plain(h)

  def entries():
    lc.cholesky_resolve(lc.cholesky_factor(h), g)
    lc.cholesky_solve_factor(h, g)
    lc.cholesky_solve(h, g)

  entries()                                           # warm-up
  torch.cuda.synchronize()
  reset_counts(pkg)
  entries()
  torch.cuda.synchronize()
  launches = read_counts(pkg)
  check(all(launches[k] == 1 for k in lc.launches) and
        sum(launches.values()) == 4, f'n={n} entry points {launches}')
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device=dev))

  def held(name, fn, plain):
    # A packed factor is held on its lower triangle: its upper is
    # unspecified.
    got, want = fn(), plain()
    if name == 'cholesky_factor':
      got, want = got[..., low], want[..., low]
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= 1e-4 * scale, f'{name} at n={n}: {err} > 1e-4 * {scale}')
    return {'max_abs_err': err, 'scale': scale}

  g3 = g[..., None]
  # The library's resolve takes an L with the diagonal in place.
  ll = torch.tril(fac, -1) + torch.diag_embed(
      1 / torch.diagonal(fac, dim1=-2, dim2=-1))
  kernels = {
      'cholesky_solve_factor': (
          lc._MODE_SOLVE_FACTOR, lambda: lc.cholesky_solve_factor(h, g)[0],
          lambda: lc.solve_factor_plain(h, g)[0],
          lambda: lc._launch(lc._MODE_SOLVE_FACTOR, 'cholesky_solve_factor',
                             h, g, want_factor=True, design='shared'),
          lambda: torch.cholesky_solve(g3, torch.linalg.cholesky_ex(h)[0]),
          'solve_factor'),
      'cholesky_resolve_const': (
          lc._MODE_RESOLVE, lambda: lc.cholesky_resolve_const(fac, g),
          lambda: lc.resolve_plain(fac, g),
          lambda: lc._launch(lc._MODE_RESOLVE, 'cholesky_resolve_const',
                             fac, g, design='shared'),
          lambda: torch.cholesky_solve(g3, ll), 'resolve'),
      'cholesky_factor': (
          lc._MODE_FACTOR, lambda: lc.cholesky_factor(h),
          lambda: lc.factor_plain(h),
          lambda: lc._launch(lc._MODE_FACTOR, 'cholesky_factor', h,
                             want_factor=True, design='shared'),
          lambda: torch.linalg.cholesky_ex(h), 'factor')}
  if not juggle:
    kernels['cholesky_solve'] = (
        lc._MODE_SOLVE, lambda: lc.cholesky_solve(h, g),
        lambda: lc.solve_plain(h, g),
        lambda: lc._launch(lc._MODE_SOLVE, 'cholesky_solve', h, g,
                           design='shared'),
        lambda: torch.cholesky_solve(g3, torch.linalg.cholesky_ex(h)[0]),
        'solve')
  out = {}
  for name, (mode, fn, plain, prev, lib, kind) in kernels.items():
    ms, row = _design_turns(torch, lc, name, mode, n, fn, prev)
    out[name] = {**row, 'ms': ms, 'kernel_ms': ms, **held(name, fn, plain),
                 **_timing_row(torch, fn, plain, lib, B_PLAN, n, kind),
                 'bound_square_ms': _bound(B_PLAN, n, 4, kind, True)[0]}
    out[name]['ms_over_previous'] = ms / out[name]['previous_design_ms']
    out[name]['ms_over_library'] = ms / out[name]['library_ms']
  emit({'phase': 'juggle_size' if n == JUGGLE_NV else f'size_n{n}',
        'shape': [B_PLAN, n, n], 'dtype': 'float32',
        'entry_launches': launches, 'kernels': out,
        'phase_s': time.perf_counter() - t_phase})
  return out, launches


def phase_split(torch, pkg, cases):
  """Where K1-K4's time goes at (B_PLAN, n, n) float32 on seeded SPD
  matrices (K2 on their plain packed factors), for each case of
  SPLIT_CASES named in `cases`: the design's source built with
  DEX_PHASE_CLOCKS (cuda_build.variant), whose every warp stamps clock64()
  at entry, with its rows loaded, after its pivots (K2: after the forward
  substitution) and at its end.  Per matrix (the stamps of one SM): load =
  the last warp's 'loaded' less the first entry, pivots = the last 'pivots
  done' less the last 'loaded', rest (the factor's store; K1's and K3's
  substitutions; K2's back substitution) = the last end less the last
  'pivots done', span = the last end less the first entry.  Reported: each
  part's mean in cycles and its share of the mean span, the time per call
  of the kernel as built for the port and of the stamped one (_call_ms, 20
  back-to-back calls: host time included, so a kernel of a few tens of us
  reads the host's), and the part of the former each share gives.  The
  stamped kernel's output (K1 and K4: the factor; K2 and K3: x) is held to
  the plain version."""
  import ctypes
  t_phase = time.perf_counter()
  lc, cuda_build = pkg['linalg_cuda'], pkg['cuda_build']
  entries = {}
  for design, src, entry in (('shared', 'cholesky', 'dex_cholesky'),
                             ('wide', 'cholesky_wide', 'dex_cholesky_wide')):
    lib = cuda_build.variant(src, 'DEX_PHASE_CLOCKS')
    lib.dex_phase_clocks.restype = ctypes.c_int
    lib.dex_phase_clocks.argtypes = [ctypes.c_void_p]
    entries[design] = (lc._bind(getattr(lib, entry)), lib.dex_phase_clocks)
  dev = torch.device('cuda', torch.cuda.current_device())
  out = {}
  for case in cases:
    design, n = SPLIT_CASES[case]
    gen = torch.Generator().manual_seed(SEED + n)
    a = torch.randn(B_PLAN, n, n, generator=gen, dtype=torch.float64)
    h = ((a @ a.transpose(1, 2)) / n + torch.eye(n, dtype=torch.float64)).to(
        dev).float()
    g = torch.randn(B_PLAN, n, generator=gen, dtype=torch.float64).to(
        dev).float()
    fac_p = lc.factor_plain(h)
    low = torch.tril(torch.ones(n, n, dtype=torch.bool, device=dev))
    warps = 1 if design == 'shared' else (2 if n <= 64 else 3)
    fn, set_clocks = entries[design]
    for mode, name in ((lc._MODE_SOLVE_FACTOR, 'cholesky_solve_factor'),
                       (lc._MODE_FACTOR, 'cholesky_factor'),
                       (lc._MODE_SOLVE, 'cholesky_solve'),
                       (lc._MODE_RESOLVE, 'cholesky_resolve_const')):
      rhs = mode != lc._MODE_FACTOR
      emits = mode in (lc._MODE_SOLVE_FACTOR, lc._MODE_FACTOR)
      a_in = fac_p if mode == lc._MODE_RESOLVE else h
      x = torch.empty_like(g) if rhs else None
      fac = torch.empty_like(h) if emits else None
      per_block = min(lc._PER_BLOCK[design], lc._MAX_SMEM //
                      lc._matrix_smem_bytes(n, 4, design, mode))
      clocks = torch.zeros(B_PLAN, 4, 4, dtype=torch.int64, device=dev)
      check(set_clocks(clocks.data_ptr()) == 0, f'{case}: clock pointer')

      def stamped():
        err = cuda_build.launch(
            fn, dev, mode, 4, a_in.data_ptr(), g.data_ptr() if rhs else None,
            x.data_ptr() if rhs else None,
            fac.data_ptr() if emits else None, B_PLAN, n, per_block)
        check(err == 0, f'{case} {name}: stamped launch failed ({err})')

      def built():
        lc._launch(mode, name, a_in, g if rhs else None, want_factor=emits,
                   design=design)

      stamped()
      torch.cuda.synchronize()
      if emits:
        got, want = fac[:, low], fac_p[:, low]
      else:
        got, want = x, lc.resolve_plain(fac_p, g)
      err = (got - want).abs().max().item()
      check(err <= 1e-4 * want.abs().max().item(),
            f'{case} {name}: stamped output {err}')
      c = clocks[:, :warps].double()
      entry, loaded = c[..., 0].amin(1), c[..., 1].amax(1)
      pivoted, end = c[..., 2].amax(1), c[..., 3].amax(1)
      check(bool((c > 0).all()), f'{case} {name}: a stamp is missing')
      parts = {'load': (loaded - entry).mean().item(),
               'pivots': (pivoted - loaded).mean().item(),
               'rest': (end - pivoted).mean().item()}
      span = (end - entry).mean().item()
      ms = {'built': _call_ms(torch, built, 20),
            'stamped': _call_ms(torch, stamped, 20)}
      out[f'{name}_{case}'] = {
          'design': design, 'n': n, 'warps_per_matrix': warps,
          'cycles': parts, 'span_cycles': span,
          'share': {k: v / span for k, v in parts.items()},
          'ms': ms, 'ms_split': {k: v / span * ms['built']
                                 for k, v in parts.items()}}
  emit({'phase': 'phase_split', 'shape_b': B_PLAN, 'dtype': 'float32',
        'cases': out, 'phase_s': time.perf_counter() - t_phase})
  return out


def _k24_holds(torch, lc, h, g, label):
  """The K4 + K2 pair, and K2 on K1's packed factor, against their plain
  versions and float64 on a path's own Newton Hessians (h, g): _vs_plain's
  holds (cond-aware tolerance, backward error under 1e-4).  Returns the
  errors."""
  _, fac1 = lc.cholesky_solve_factor(h, g)
  out = {}
  for name, kw, what in (('cholesky_factor', {}, 'k4_k2'),
                         ('cholesky_resolve_const', {'fac': fac1},
                          'k2_on_k1_factor')):
    for key, v in _vs_plain(torch, lc, name, h, g, f'{label} {what}',
                            **kw).items():
      out[f'{what}{key}'] = v
  return out


def _tree_inputs(torch, data, dtype):
  """Batch-minor tree-sweep inputs from a batch-leading Data; mocap rows
  component-major (row c * nmocap + m)."""
  qpos = data.qpos.T.to(dtype).contiguous()
  qvel = data.qvel.T.to(dtype).contiguous()
  mp = data.mocap_pos.permute(2, 1, 0).reshape(-1, qpos.shape[1])
  mq = data.mocap_quat.permute(2, 1, 0).reshape(-1, qpos.shape[1])
  return [qpos, qvel, mp.to(dtype).contiguous(), mq.to(dtype).contiguous()]


def phase_tree_sweep(torch, pkg, main):
  """build_tree_sweep (K5 + K6) on the rollouts' states after their first
  control step: counted entry-point run, checks, timings."""
  tc, step, common = pkg['tree_cuda'], pkg['step'], pkg['common']
  model = main['model']
  nv, b = model.nv, B_PLAN
  ins = _tree_inputs(torch, main['first'], model.dtype)
  fn = tc.build_tree_sweep(model, B=b)
  fn(*ins)                                            # warm-up
  torch.cuda.synchronize()
  reset_counts(pkg)
  out = fn(*ins)
  torch.cuda.synchronize()
  launches = read_counts(pkg)
  check(launches['tree_sweep_fk'] == 1 and launches['tree_sweep_dyn'] == 1
        and sum(launches.values()) == 2, f'tree sweep launches {launches}')

  # Float32 against the plain version on the card, per output, relative
  # to the output's max-abs: float32 rounding (6e-8) along a 6-deep body
  # chain and sums over 33 bodies stays under 1e-5; limit 1e-4.
  ref = tc.tree_sweep_plain(model, *ins)
  errs = {}
  for key, want in ref.items():
    err = (out[key] - want).abs().max().item()
    scale = max(want.abs().max().item(), 1.0)
    check(bool(torch.isfinite(out[key]).all()), f'{key} not finite')
    check(err <= 1e-4 * scale, f'tree sweep {key}: {err} > 1e-4 * {scale}')
    errs[key] = err / scale
  # Float64 copies of 64 rollouts and of 37 (K5's rows then end in a
  # partial 16-byte chunk: element stores, and in a partial tile): both
  # sides compute the same arithmetic in float64, limit 1e-10 relative.
  model64, _ = common.reduced_planning_model(
      main['task'], device='cuda', dtype=torch.float64, **PLAN)
  errs64 = {}
  for b64 in (64, 37):
    ins64 = [x[:, :b64].double().contiguous() for x in ins]
    out64 = tc.build_tree_sweep(model64)(*ins64)
    ref64 = tc.tree_sweep_plain(model64, *ins64)
    for key, want in ref64.items():
      err = (out64[key] - want).abs().max().item()
      scale = max(want.abs().max().item(), 1.0)
      check(err <= 1e-10 * scale, f'tree sweep f64 B={b64} {key}: {err}')
      errs64[f'{key}_B{b64}'] = err / scale
  # The kernel's joint-space inertia factors (float64 copy).
  qm = out['qm'].double().reshape(nv, nv, b).permute(2, 0, 1)
  info = torch.linalg.cholesky_ex(qm)[1]
  check(int((info != 0).sum()) == 0, 'kernel qm does not factor')

  fk = tc.tree_fk(model, *ins)
  body10 = fk['body10']
  pre_args = (ins[0], ins[1],
              ins[2].reshape(3, model.nmocap, b).transpose(0, 1),
              ins[3].reshape(4, model.nmocap, b).transpose(0, 1))
  timing = {
      'tree_sweep_fk': dict(
          kernel_ms=_device_ms(torch, lambda: tc.tree_fk(model, *ins), 50,
                              (tc.launches,)),
          plain_ms=_device_ms(torch, lambda: tc.fk_plain(model, *ins), 5),
          call_ms=_call_ms(torch, lambda: tc.tree_fk(model, *ins), 50)),
      'tree_sweep_dyn': dict(
          kernel_ms=_device_ms(torch, lambda: tc.tree_dyn(
              model, fk['cdof'], body10, ins[1]), 50, (tc.launches,)),
          plain_ms=_device_ms(torch, lambda: tc.dyn_plain(
              model, fk['cdof'], body10, ins[1]), 5),
          call_ms=_call_ms(torch, lambda: tc.tree_dyn(
              model, fk['cdof'], body10, ins[1]), 50))}
  sweep_call_ms = _call_ms(torch, lambda: fn(*ins), 50)
  planes = dict(
      device_ms=_device_ms(torch, lambda: step._precompute_planes(
          model, *pre_args), 5),
      call_ms=_call_ms(torch, lambda: step._precompute_planes(
          model, *pre_args), 5))
  grid, block = _launch_shape(torch, lambda: tc.tree_fk(model, *ins),
                              'tree_fk_kernel')
  timing['tree_sweep_fk']['cta'] = {
      'rollouts': -(-b // grid[0]), 'ctas_per_tile': grid[1],
      'threads': block[0] * block[1] * block[2], 'grid': grid,
      'block': block}
  bounds = _tree_bounds(pkg['smooth'], model, b, 4)
  rows = {}
  for (name, t), (bound_ms, bound_by) in zip(timing.items(), bounds):
    rows[name] = {
        'max_abs_err': max(errs[k] for k in (
            ('qm', 'qfrc_bias') if name == 'tree_sweep_dyn' else
            ('xpos', 'xquat', 'cdof', 'gpos', 'gmat', 'xipos', 'ten_length',
             'ten_velocity'))),
        'ms': t['kernel_ms'], **t, 'bound_ms': bound_ms,
        'bound_by': bound_by, 'library_ms': None,
        'shape': {'nbody': model.nbody, 'nv': nv, 'ngeom': model.ngeom,
                  'B': b}, 'dtype': 'float32'}
  emit({'phase': 'tree_sweep', 'batch': b, 'launches': launches,
        'max_rel_err_f32': errs, 'max_rel_err_f64': errs64,
        'qm_factors': True, 'kernels': timing,
        'sweep_call_ms': sweep_call_ms,
        'fk_host_us_by_op': _host_us_by_op(
            torch, lambda: tc.tree_fk(model, *ins), 50),
        'precompute_planes': planes})
  return launches, rows


def _launch_shape(torch, fn, kernel, reps=20):
  """(grid, block) of the launches of the kernel whose name holds
  `kernel` over `reps` calls of fn, from the kernel records of the
  profiler's trace (written under build/ and removed)."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  path = os.path.join(ROOT, 'build', f'launch_shape_{os.getpid()}.json')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  seen = []
  for _ in range(3):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f).get('traceEvents', [])
    os.remove(path)
    kern = [e for e in events if e.get('cat') == 'kernel']
    shapes = {(tuple(e['args']['grid']), tuple(e['args']['block']))
              for e in kern if kernel in e.get('name', '')}
    if shapes:
      check(len(shapes) == 1, f'{kernel} launched at shapes {shapes}')
      grid, block = shapes.pop()
      return list(grid), list(block)
    seen.append((len(events), [e.get('name', '')[:60] for e in kern][:3]))
  check(False, f'the profiler saw no {kernel} launch in three passes '
        f'(events, kernels: {seen})')


def _host_us_by_op(torch, fn, reps):
  """Host time per call (us) of fn under the profiler's CPU activity: the
  whole call, and each operator's self time (what is left of the whole is
  Python, the ctypes call and the profiler's own cost)."""
  from torch.profiler import ProfilerActivity, profile, record_function
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    for _ in range(reps):
      with record_function('call'):
        fn()
    torch.cuda.synchronize()
  out = {}
  for e in prof.key_averages():
    if e.key == 'call':
      out['call'] = e.cpu_time_total / reps
    elif e.self_cpu_time_total > 0:
      out[e.key] = e.self_cpu_time_total / reps
  return out


def phase_factor_entry(torch, pkg, main):
  """The cholesky_factor / cholesky_resolve entry points (K4 + K2) on the
  rollouts' first Hessians: counted run and its backward error."""
  lc = pkg['linalg_cuda']
  h, g = main['hessians']['h'], main['hessians']['g']
  lc.cholesky_resolve(lc.cholesky_factor(h), g)       # warm-up
  torch.cuda.synchronize()
  reset_counts(pkg)
  x = lc.cholesky_resolve(lc.cholesky_factor(h), g)
  torch.cuda.synchronize()
  launches = read_counts(pkg)
  check(launches['cholesky_factor'] == 1 and
        launches['cholesky_resolve_const'] == 1 and
        sum(launches.values()) == 2, f'factor entry launches {launches}')
  h64, x64, g64 = h.double(), x.double(), g.double()
  n = h.shape[-1]
  res = (h64 @ x64[..., None])[..., 0] - g64
  bwd = (res.abs().amax(-1) / (n * h64.abs().amax((-2, -1))
                               * x64.abs().amax(-1)
                               + g64.abs().amax(-1))).max().item()
  check(bwd <= 1e-4, f'K4 + K2 backward error {bwd}')
  emit({'phase': 'cholesky_factor', 'launches': launches,
        'backward_error': bwd, 'shape': list(h.shape)})
  return launches


def phase_planner(torch, pkg):
  """PredictiveSampling.solve_batch at bench.py's configuration, from
  GoalEnvironment.reset's states and goals."""
  ps, types, manip = pkg['ps'], pkg['types'], pkg['manipulation']
  task = manip.build_task('reorient', 'state_dense')
  cfg = ps.PredictiveSamplingConfig(
      horizon=H, num_samples=SAMPLES, iterations=ITERATIONS,
      solver_iterations=PLAN['solver_iterations'],
      ls_iterations=PLAN['ls_iterations'],
      solver_refactor_every=PLAN['solver_refactor_every'],
      plan_substeps=PLAN['plan_substeps'],
      plan_midphase_cap=PLAN['plan_midphase_cap'],
      plan_contact_top_k=PLAN['plan_contact_top_k'],
      plan_implicit_damping=PLAN['plan_implicit_damping'],
      plan_self_collision=PLAN['plan_self_collision'])
  planner = ps.PredictiveSampling(task, cfg)
  model = planner.model
  dev, dtype = model.device, model.dtype
  check(dev.type == 'cuda' and dtype == torch.float32, 'planner device')
  # Start states and goals from GoalEnvironment.reset, as bench.py:84-91
  # takes them: solve_batch receives the environment model's Data.
  env = manip.load('reorient', 'state_dense')
  gen = torch.Generator().manual_seed(SEED + 4)
  state, _ = env.reset(gen, (STREAMS,))
  data_b, goals = state.data, state.task.goal
  check(data_b.contact.dist.shape[-1] == types.num_contact_points(
      env.model) != types.num_contact_points(model),
        'solve_batch takes the environment model\'s Data')
  pgen = torch.Generator(device=dev).manual_seed(SEED)
  pst = planner.init_state(streams=STREAMS)
  t0 = time.perf_counter()
  actions, pst = planner.solve_batch(data_b, goals, pst, pgen)  # warm-up
  torch.cuda.synchronize()
  warm_s = time.perf_counter() - t0

  reset_counts(pkg)
  walls = []
  for _ in range(SOLVES):
    t0 = time.perf_counter()
    actions, pst = planner.solve_batch(data_b, goals, pst, pgen)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
  launches = read_counts(pkg)
  per_call = {k: v / SOLVES for k, v in launches.items()}
  per_solve = ITERATIONS * H * planner.n_plan_substeps * 2
  check(per_call['cholesky_solve_factor'] == per_solve and
        per_call['cholesky_resolve_const'] == per_solve,
        f'K1/K2 launches per solve {per_call}')
  check(launches['cholesky_solve'] == 0 and launches['cholesky_factor'] == 0
        and launches['tree_sweep_fk'] == 0 and
        launches['tree_sweep_dyn'] == 0, f'planner launches {launches}')
  lo, hi = planner._lo, planner._hi
  check(actions.shape == (STREAMS, planner.nu), 'action shape')
  check(bool(torch.isfinite(actions).all()), 'non-finite actions')
  check(bool(((actions >= lo) & (actions <= hi)).all()), 'actions off range')
  check(bool(torch.isfinite(pst.best_return).all()), 'non-finite returns')
  check(bool((pst.nominal[:, -1] == pst.nominal[:, -2]).all()),
        'nominal not shifted')

  # rollout_returns_flat of 8 candidates over 2 control steps against the
  # port on the CPU in float64.  Limit 1e-3 relative to the largest
  # return: float32 rounding times the Newton Hessian's condition (~1e5)
  # gives ~6e-3 relative in qacc per substep, ~1e-4 in qpos after 6
  # substeps of 8.33 ms, and the returns are smooth in the cube's pose.
  # Both start from the card's reset states (carried to float64).
  cpu = ps.PredictiveSampling(task, cfg, device='cpu', dtype=torch.float64)
  k, steps = 8, 2
  stream = (torch.arange(k) % STREAMS).to(dev)
  u = torch.rand(k, steps, planner.nu, generator=gen, dtype=torch.float64)
  acts = cpu._lo + (cpu._hi - cpu._lo) * u
  d_card = types.map_data(data_b, lambda x: x[stream])
  d_cpu = types.map_data(d_card, lambda x: _to_cpu64(torch, x))
  r_card = planner.rollout_returns_flat(d_card, goals[stream],
                                        acts.to(dev, dtype))
  r_cpu = cpu.rollout_returns_flat(d_cpu, _to_cpu64(torch, goals[stream]),
                                   acts)
  rel = ((r_card.double().cpu() - r_cpu).abs().max()
         / r_cpu.abs().max().clamp_min(1.0)).item()
  check(rel <= 1e-3, f'planner returns vs CPU float64: {rel}')

  wall = sum(walls)
  emit({'phase': 'planner', 'main_path': True, 'start': 'GoalEnvironment.reset',
        'config': {'streams': STREAMS, 'samples': SAMPLES,
                   'iterations': ITERATIONS, 'horizon': H, **PLAN},
        'solves_per_s': STREAMS * SOLVES / wall,
        'wall_s_per_call': walls, 'warmup_s': warm_s,
        'launches_per_call': per_call, 'best_return':
        pst.best_return.tolist(), 'returns_vs_cpu_f64_rel': rel,
        'rollouts_per_call': STREAMS * SAMPLES * ITERATIONS})
  return dict(launches=launches, planner=planner, data=data_b, goals=goals,
              pgen=pgen, pstate=pst, walls=walls)


def phase_planner_per_candidate(torch, pkg, bench_walls):
  """PredictiveSampling.solve with batched_rollouts=False: one stream,
  SAMPLES candidates x ITERATIONS, each candidate through the
  per-environment step_n (rollout_return)."""
  ps, types, manip = pkg['ps'], pkg['types'], pkg['manipulation']
  po = pkg['prop_orientation']
  task = manip.build_task('reorient', 'state_dense')
  cfg = ps.PredictiveSamplingConfig(
      horizon=H, num_samples=SAMPLES, iterations=ITERATIONS,
      batched_rollouts=False, **PLAN)
  planner = ps.PredictiveSampling(task, cfg)
  model = planner.model
  dev, dtype = model.device, model.dtype
  check(dev.type == 'cuda' and dtype == torch.float32, 'planner device')
  gen = torch.Generator().manual_seed(SEED + 6)
  qpos = start_states(torch, types, model, 1, gen)[0]
  goal64 = po.uniform_quaternion(gen, (), torch.float64)
  data = types.make_data(model).replace(qpos=qpos.to(dev, dtype))
  goal = goal64.to(dev, dtype)
  pgen = torch.Generator(device=dev).manual_seed(SEED)
  pst = planner.init_state()
  t0 = time.perf_counter()
  action, pst = planner.solve(data, goal, pst, pgen)             # warm-up
  torch.cuda.synchronize()
  warm_s = time.perf_counter() - t0

  # K1 and K2 on this path's own inputs, at (SAMPLES, nv, nv).
  kernel_checks = _k12_holds(torch, pkg['linalg_cuda'],
                             lambda: planner.solve(data, goal, pst, pgen),
                             SAMPLES, model.nv, 'per-candidate')

  reset_counts(pkg)
  walls = []
  for _ in range(PC_SOLVES):
    t0 = time.perf_counter()
    action, pst = planner.solve(data, goal, pst, pgen)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
  launches = read_counts(pkg)
  per_call = {k: v / PC_SOLVES for k, v in launches.items()}
  per_solve = ITERATIONS * H * planner.n_plan_substeps * 2
  check(per_call['cholesky_solve_factor'] == per_solve and
        per_call['cholesky_resolve_const'] == per_solve and
        launches['cholesky_solve'] == 0 and
        launches['cholesky_factor'] == 0 and
        launches['tree_sweep_fk'] == 0 and launches['tree_sweep_dyn'] == 0,
        f'per-candidate launches per solve {per_call}')
  check(action.shape == (planner.nu,) and
        bool(torch.isfinite(action).all()), 'per-candidate action')
  check(bool(((action >= planner._lo) & (action <= planner._hi)).all()),
        'per-candidate action off range')
  check(bool(torch.isfinite(pst.best_return)), 'non-finite best return')

  # rollout_return of 8 candidates over 2 control steps against the port
  # on the CPU in float64: the planner phase's limit, 1e-3 of the largest
  # return.
  cpu = ps.PredictiveSampling(task, cfg, device='cpu', dtype=torch.float64)
  k, steps = 8, 2
  u = torch.rand(k, steps, planner.nu, generator=gen, dtype=torch.float64)
  acts = cpu._lo + (cpu._hi - cpu._lo) * u
  d_card, g_card = planner._broadcast(data, goal, k)
  d_cpu, g_cpu = cpu._broadcast(
      types.make_data(cpu.model).replace(qpos=qpos.clone()), goal64, k)
  r_card = planner.rollout_return(d_card, g_card, acts.to(dev, dtype))
  r_cpu = cpu.rollout_return(d_cpu, g_cpu, acts)
  rel = ((r_card.double().cpu() - r_cpu).abs().max()
         / r_cpu.abs().max().clamp_min(1.0)).item()
  check(rel <= 1e-3, f'per-candidate returns vs CPU float64: {rel}')

  bench_per_stream = sum(bench_walls) / len(bench_walls)
  emit({'phase': 'planner_per_candidate',
        'config': {'streams': 1, 'samples': SAMPLES,
                   'iterations': ITERATIONS, 'horizon': H,
                   'batched_rollouts': False, **PLAN},
        'wall_s_per_solve': walls, 'warmup_s': warm_s,
        'solves_per_s': PC_SOLVES / sum(walls),
        'wall_vs_bench_call': (sum(walls) / len(walls)) / bench_per_stream,
        'launches_per_solve': per_call, 'kernels_vs_plain': kernel_checks,
        'best_return': pst.best_return.item(),
        'returns_vs_cpu_f64_rel': rel,
        'reduced': [f'timed solves {PC_SOLVES_BEFORE} -> {PC_SOLVES}']})


# Stages of one substep, as step_n_b reaches them through module attributes.
_STAGES = (('step', '_precompute_planes'), ('primitives', 'midphase_selinfo'),
           ('primitives', 'collide_group_planes'), ('smooth', 'actuation'),
           ('smooth', 'passive'), ('smooth', 'xfrc_planes'),
           ('constraint', 'solve'), ('smooth', 'euler_from_smooth'))


def phase_profile(torch, pkg, main):
  """Host and device time by stage and device time by kernel over one
  planning control step (B = 1024, 3 substeps)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile, record_function
  types, step = pkg['types'], pkg['step']
  model = main['model']
  gen = torch.Generator().manual_seed(SEED + 3)
  qpos = start_states(torch, types, model, B_PLAN, gen)
  ctrl = controls(torch, model, 1, B_PLAN, gen)[0]
  data = types.make_data(model, (B_PLAN,)).replace(
      qpos=qpos.to(model.device, model.dtype),
      ctrl=ctrl.to(model.device, model.dtype))
  kw = dict(refresh='none', midphase='per_call', carry='minimal')
  step.step_n_b(model, data, 3, **kw)
  torch.cuda.synchronize()

  def ranged(label, fn):
    def wrapped(*args, **kwargs):
      with record_function(label):
        return fn(*args, **kwargs)
    return wrapped

  saved = [(pkg[mod], fn, getattr(pkg[mod], fn)) for mod, fn in _STAGES]
  for mod, fn, orig in saved:
    setattr(mod, fn, ranged('stage:' + fn, orig))
  try:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      step.step_n_b(model, data, 3, **kw)
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3
  finally:
    for mod, fn, orig in saved:
      setattr(mod, fn, orig)
  events = prof.key_averages()
  # The stage ranges appear twice: as host ranges (device_type CPU, with
  # the device time of the kernels they launched) and as annotations on
  # the device timeline, which are spans and not kernels.
  kern = sorted(((e.self_device_time_total, e.count, e.key) for e in events
                 if e.device_type == DeviceType.CUDA
                 and not e.key.startswith('stage:')), reverse=True)
  busy_us = sum(k[0] for k in kern)
  check(busy_us > 0, 'the profiler saw no device time')
  stages = {e.key[len('stage:'):]: {'calls': e.count,
                                    'host_ms': e.cpu_time_total / 1e3,
                                    'device_ms': e.device_time_total / 1e3}
            for e in events
            if e.key.startswith('stage:') and e.device_type == DeviceType.CPU}
  chol = [k for k in kern if 'cholesky' in k[2]]
  emit({'phase': 'profile',
        'window': f'one planning control step, B={B_PLAN}',
        'wall_ms': wall_ms, 'device_busy_ms': busy_us / 1e3,
        'device_idle_share': max(0.0, 1 - busy_us / 1e3 / wall_ms),
        'kernel_launches': sum(k[1] for k in kern),
        'cholesky_kernels': {'launches': sum(k[1] for k in chol),
                             'device_ms': sum(k[0] for k in chol) / 1e3},
        'stages': stages,
        'top_kernels': [{'us': k[0], 'count': k[1], 'name': k[2][:80]}
                        for k in kern[:12]]})


def phase_profile_solve(torch, planner_out):
  """Device busy time and idle share over one solve_batch."""
  p = planner_out
  emit({'phase': 'profile_solve',
        'window': f'one solve_batch, {STREAMS} x {SAMPLES} x {ITERATIONS}',
        **_busy_window(torch, lambda: p['planner'].solve_batch(
            p['data'], p['goals'], p['pstate'], p['pgen']))})


def load_pkg():
  """The port's modules the phases use, by short name (imported here, once
  the card is known to be present; a script that runs single
  phases takes them from here)."""
  sys.path.insert(0, ROOT)
  import dexterity_tpu_torch  # noqa: F401  (TF32 off)
  from dexterity_tpu_torch import environment, manipulation, rendering
  from dexterity_tpu_torch.core import types
  from dexterity_tpu_torch.effectors.wrappers import (previous_action,
                                                      smooth_action)
  from dexterity_tpu_torch.envs import batched
  from dexterity_tpu_torch.inverse_kinematics import ik_solver
  from dexterity_tpu_torch.manipulation.goals import prop_orientation
  from dexterity_tpu_torch.manipulation.shared import observations
  from dexterity_tpu_torch.manipulation.tasks import reach, reorient
  from dexterity_tpu_torch.mjcf import export, parser, prune, stl
  from dexterity_tpu_torch.models import hands, meshes
  from dexterity_tpu_torch.parallel import sharding
  from dexterity_tpu_torch.physics import (constraint, cuda_build, linalg_cuda,
                                           smooth, step, tree_cuda)
  from dexterity_tpu_torch.physics.collision import primitives
  from dexterity_tpu_torch.planners import common, distributed, ilqr, sqp
  from dexterity_tpu_torch.planners import predictive_sampling as ps
  from dexterity_tpu_torch.utils import checkpoint, structs
  pkg = dict(types=types, step=step, linalg_cuda=linalg_cuda,
             tree_cuda=tree_cuda, cuda_build=cuda_build,
             primitives=primitives, common=common, manipulation=manipulation,
             smooth=smooth, constraint=constraint, ps=ps, ilqr=ilqr, sqp=sqp,
             prop_orientation=prop_orientation, structs=structs,
             hands=hands, environment=environment, batched=batched,
             ik_solver=ik_solver, smooth_action=smooth_action,
             previous_action=previous_action, checkpoint=checkpoint,
             sharding=sharding, distributed=distributed, export=export,
             parser=parser, prune=prune, rendering=rendering, stl=stl,
             meshes=meshes, observations=observations, reach=reach,
             reorient=reorient)
  return pkg


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--profile', action='store_true',
                      help='also profile one planning control step and one '
                           'solve_batch')
  parser.add_argument('--closed-loop', type=int, metavar='SEED',
                      help=f'run only the closed-loop bar: {BAR_GOALS} goals '
                           f'from seed SEED, up to {BAR_STEPS} control steps')
  parser.add_argument('--max-wall', type=float, metavar='SECONDS',
                      help='with --closed-loop: stop after this many seconds '
                           'and report how far the run got')
  parser.add_argument('--hold-readings', type=int, metavar='N',
                      help='run only the reach and juggle holds, the IK '
                           'q-dot hold and the pixel hold against the CPU '
                           'float64 port on N seeds, sound and faulted (the '
                           'readings TASK_LIMITS, IK_QDOT_LIMIT and '
                           'PIXEL_LIMITS are set from)')
  parser.add_argument('--phase-split', nargs='?', const=','.join(SPLIT_CASES),
                      metavar='CASES',
                      help='run only the split of K1-K4 into load, '
                           'pivots and rest for the comma-separated cases '
                           f'({", ".join(SPLIT_CASES)}; default all)')
  args = parser.parse_args()

  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this script runs on the GPU only',
          file=sys.stderr)
    return 2
  pkg = load_pkg()

  smi = nvidia_smi_line()
  phase_probe(torch, pkg, smi)
  if (args.closed_loop is not None or args.hold_readings is not None or
      args.phase_split is not None):
    if args.phase_split is not None:
      cases = args.phase_split.split(',')
      check(set(cases) <= set(SPLIT_CASES), f'unknown cases {cases}')
      phase_split(torch, pkg, cases)
    elif args.closed_loop is not None:
      phase_closed_loop(torch, pkg, BAR_GOALS, BAR_STEPS, args.closed_loop,
                        bar=True, max_wall=args.max_wall, smi=smi)
    else:
      phase_hold_readings(torch, pkg,
                          [SEED + i for i in range(args.hold_readings)])
      phase_ik_readings(torch, pkg, range(args.hold_readings))
      phase_render_readings(torch, pkg, range(args.hold_readings))
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0
  main_out = phase_rollouts(torch, pkg)
  phase_env(torch, pkg, main_out['task'])
  env_launches, env_k3 = phase_environment(torch, pkg)
  planner_out = phase_planner(torch, pkg)
  phase_planner_per_candidate(torch, pkg, planner_out['walls'])
  phase_sharded(torch, pkg, planner_out)
  tree_launches, tree_rows = phase_tree_sweep(torch, pkg, main_out)
  factor_launches = phase_factor_entry(torch, pkg, main_out)
  rows = phase_kernels(torch, pkg, main_out)
  rows.update(tree_rows)
  # K3's row also carries its error on its own path's inputs.
  rows['cholesky_solve']['max_abs_err'] = max(
      rows['cholesky_solve']['max_abs_err'],
      *(v for k, v in env_k3.items() if k.endswith(('_hessian', '_matrix'))))
  juggle_rows, juggle_launches = phase_juggle_size(
      torch, pkg, main_out['model'].device)
  top_rows, top_launches = phase_juggle_size(
      torch, pkg, main_out['model'].device, N_TOP)
  phase_closed_loop(torch, pkg, CL_GOALS, CL_STEPS, SEED, smi=smi)
  task_out = {domain: phase_task(torch, pkg, domain, variant)
              for domain, variant in TASK_PHASES}
  phase_reach_oracle(torch, pkg)
  suite_k3 = phase_suite(torch, pkg)
  ilqr_out = phase_ilqr(torch, pkg, smi)
  k3_out = phase_ilqr_k3(torch, pkg)
  phase_sqp(torch, pkg, ilqr_out)
  phase_hybrid(torch, pkg)
  phase_ik(torch, pkg, smi)
  phase_wrappers(torch, pkg)
  phase_mjcf(torch, pkg)
  phase_prune(torch, pkg)
  phase_render(torch, pkg)
  path_launches = {'main_path': planner_out['launches'],
                   'environment': env_launches,
                   'entry:cholesky_factor': factor_launches,
                   'entry:build_tree_sweep': tree_launches}
  lc = pkg['linalg_cuda']
  juggle = task_out['juggle']
  k3_rows = [('cholesky_solve_n62_b32', _WIDE, _k3_row(
      torch, lc, *juggle['k3_inputs'], 'juggle',
      juggle['launches']['cholesky_solve'], juggle['k3_err']))]
  for name, source, task in (('cholesky_solve_n62_b4096', _WIDE,
                              'juggle.state_sparse'),
                             ('cholesky_solve_n24_b4096', _REGS,
                              'reach.state_dense')):
    h, g, launches, err = suite_k3[task]
    k3_rows.append((name, source, _k3_row(torch, lc, h, g, f'suite:{task}',
                                          launches, err)))
  # K4 + K2 and K2 on K1's factor (the wide design) on juggle's own
  # Newton Hessians, as K3 above; K2 on the environment's 32 also timed in
  # turns with the shared design (its chain, not its bytes, bounds it).
  k24_holds = {
      'juggle_b32': _k24_holds(torch, lc, *juggle['k3_inputs'], 'juggle'),
      'suite_juggle_b4096': _k24_holds(
          torch, lc, *suite_k3['juggle.state_sparse'][:2], 'suite juggle')}
  jh, jg = juggle['k3_inputs']
  _, jfac = lc.cholesky_solve_factor(jh, jg)
  k2_ms, k2_row = _design_turns(
      torch, lc, 'cholesky_resolve_const', lc._MODE_RESOLVE, JUGGLE_NV,
      lambda: lc.cholesky_resolve_const(jfac, jg),
      lambda: lc._launch(lc._MODE_RESOLVE, 'cholesky_resolve_const', jfac,
                         jg, design='shared'))
  k2_bound, k2_by = _bound(jh.shape[0], JUGGLE_NV, 4, 'resolve')
  emit({'phase': 'k3_task_sizes',
        'rows': {name: row for name, _, row in k3_rows},
        'k2_k4_on_juggle_hessians': k24_holds,
        'k2_on_juggle_b32': {'shape': list(jh.shape), 'ms': k2_ms, **k2_row,
                             'bound_ms': k2_bound, 'bound_by': k2_by}})
  ilqr_rows = _ilqr_rows(torch, lc, ilqr_out, k3_out)
  if args.profile:
    phase_profile(torch, pkg, main_out)
    phase_profile_solve(torch, planner_out)
  line = []
  for name, replaces, source, path in KERNELS:
    launches = path_launches[path][name]
    check(launches > 0, f'{name} was not launched on {path}')
    line.append({'name': name, 'route': 'cuda', 'source': source,
                 'replaces': replaces, 'path': path, 'launches': launches,
                 **rows[name], 'card': smi})
  for name, source, row in k3_rows:
    check(row['launches'] > 0, f'{name} was not launched on {row["path"]}')
    line.append({'name': name, 'kernel': 'cholesky_solve', 'route': 'cuda',
                 'source': source, 'replaces': f'{_LP}:74', **row,
                 'card': smi})
  replaces = {name: rep for name, rep, _, _ in KERNELS}
  sources = {'wide': _WIDE, 'shared': _CHOL}
  for n, rows_n, launches_n in ((JUGGLE_NV, juggle_rows, juggle_launches),
                                (N_TOP, top_rows, top_launches)):
    for name, row in rows_n.items():
      launches = launches_n[name]
      check(launches > 0, f'{name} was not launched at n = {n}')
      line.append({'name': f'{name}_n{n}_b{B_PLAN}', 'kernel': name,
                   'route': 'cuda', 'source': sources[row['design']],
                   'replaces': replaces[name], 'path': 'entry:linalg_cuda',
                   'launches': launches, **row, 'card': smi})
  for name, row in ilqr_rows:
    check(row['launches'] > 0, f'{name} was not launched on ilqr')
    line.append({'name': f'{name}_ilqr', 'kernel': name, 'route': 'cuda',
                 'source': _REGS, 'replaces': replaces[name], **row,
                 'card': smi})
  emit({'phase': 'profiler_passes', **PROFILER_PASSES})
  print(smi, flush=True)
  emit({'kernels': line})
  emit({'ok': True, 'device': {'platform': 'gpu',
                               'kind': torch.cuda.get_device_name(0),
                               'count': torch.cuda.device_count()}})
  return 0


if __name__ == '__main__':
  sys.exit(main())
