#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dexterity_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Needs a CUDA device and the repository checkout beside this file; exits
non-zero otherwise, and on any failed check.  Phases, one JSON line each:

  0. probe: torch/CUDA versions, the card, the kernel build (nvcc, sm_90a).
  1. main path: the ShadowHand reorient planning model (4 Newton iterations,
     6 line-search steps, refactor every 2, 3 substeps, contact budget
     16/16, implicit damping, no self-collision) steps B = 1024 rollouts
     through 10 control steps of step_n_b; the launch counts of the Cholesky
     kernels are read for exactly that run, the contact path is checked,
     and the first control step of 8 rollouts is held against the port run
     on the CPU in float64.
  2. environment model: one control step (5 substeps, exact Newton, Euler
     damping solve, contact 64/64) at B = 256.
  3. kernels: each Cholesky kernel against its plain PyTorch version and a
     float64 reference, on seeded SPD matrices and on the Hessians the main
     path built; timed (device time, torch.profiler) beside its plain
     version, a library call and its bound.
  --profile adds host and device time by stage and device time by kernel
  over one planning control step.
Then the `kernels` line, the card's name and power limit, and as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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

# H100 SXM peaks (NVIDIA data sheet): HBM rate and FP32 non-tensor rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12

KERNELS = [
    # name, TPU kernel it replaces
    ('cholesky_solve_factor', 'dexterity_tpu/physics/linalg_pallas.py:135'),
    ('cholesky_resolve_const', 'dexterity_tpu/physics/linalg_pallas.py:291'),
    ('cholesky_solve', 'dexterity_tpu/physics/linalg_pallas.py:74'),
]
SOURCE = 'dexterity_tpu_torch/csrc/cholesky.cu'


def emit(obj):
  print(json.dumps(obj), flush=True)


def check(cond, what):
  if not cond:
    raise AssertionError(what)


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
  ranges around 0, the cube at the spawn-workspace centre
  (reorient.py PROP_BBOX) with a uniformly random orientation."""
  qpos = model.qpos0.double().cpu().expand(batch, model.nq).clone()
  for j in range(model.njnt):
    if model.jnt_type[j] == int(types.JointType.HINGE) and \
        model.jnt_limited[j]:
      lo, hi = model.jnt_range[j].double().cpu().tolist()
      mid = min(max(0.0, lo), hi)
      u = torch.rand(batch, generator=gen, dtype=torch.float64) - 0.5
      qpos[:, model.jnt_qposadr[j]] = (mid + band * (hi - lo) * u).clamp(lo,
                                                                         hi)
  free = [j for j in range(model.njnt)
          if model.jnt_type[j] == int(types.JointType.FREE)][0]
  qa = model.jnt_qposadr[free]
  qpos[:, qa:qa + 3] = torch.tensor([0.0, -0.13, 0.16], dtype=torch.float64)
  q = torch.randn(batch, 4, generator=gen, dtype=torch.float64)
  qpos[:, qa + 3:qa + 7] = q / q.norm(dim=1, keepdim=True)
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


def phase_probe(torch, linalg_cuda, smi):
  t0 = time.perf_counter()
  linalg_cuda.build()
  build_s = time.perf_counter() - t0
  log = linalg_cuda.build_info.get('log', '')
  ptxas = [ln.strip() for ln in log.splitlines()
           if 'registers' in ln or 'spill' in ln][:12]
  emit({'phase': 'probe', 'torch': torch.__version__,
        'cuda': torch.version.cuda, 'python': sys.version.split()[0],
        'device': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(), 'nvidia_smi': smi,
        'kernel_build_s': build_s,
        'nvcc_s': linalg_cuda.build_info.get('seconds'),
        'ptxas': ptxas})


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


def phase_main_path(torch, pkg):
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
    linalg_cuda.reset_launches()
    t0 = time.perf_counter()
    final, first = run_rollouts(torch, step, model, n, data0, ctrl_dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(linalg_cuda.launches)
  finally:
    linalg_cuda.cholesky_solve_factor = real_k1

  check(launches['cholesky_solve_factor'] == H * n * 2,
        f'K1 launches {launches}')
  check(launches['cholesky_resolve_const'] == H * n * 2,
        f'K2 launches {launches}')
  check(launches['cholesky_solve'] == 0, f'K3 launches {launches}')
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
  # (~1e5 on this path), ~6e-3 relative in qacc; over h = 6.7 ms that is
  # qvel to 1e-2 and qpos to 1e-4.
  cpu_model, _ = common.reduced_planning_model(
      task, device='cpu', dtype=torch.float64, **PLAN)
  k = 8
  d_cpu = types.make_data(cpu_model, (k,)).replace(qpos=qpos0[:k].clone())
  ref, _ = run_rollouts(torch, step, cpu_model, n, d_cpu, ctrls[:1, :k])
  err_q = (first.qpos[:k].double().cpu() - ref.qpos).abs().max().item()
  err_v = (first.qvel[:k].double().cpu() - ref.qvel).abs().max().item()
  check(err_q < 1e-4 and err_v < 1e-2,
        f'card vs CPU float64: qpos {err_q}, qvel {err_v}')

  emit({'phase': 'main_path', 'model': 'reorient.state_dense planning',
        'batch': B_PLAN, 'control_steps': H, 'substeps': n,
        'launches': launches, 'finite': finite,
        'rollouts_in_contact': in_contact,
        'cpu_f64_max_err': {'qpos': err_q, 'qvel': err_v},
        'wall_s_per_rollout_batch': wall,
        'rollout_substeps_per_s': B_PLAN * H * n / wall,
        'npair': model.npair, 'nv': model.nv})
  return dict(launches=launches, hessians=captured, model=model, task=task)


def phase_env(torch, pkg, task):
  types, step, linalg_cuda = pkg['types'], pkg['step'], pkg['linalg_cuda']
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
  linalg_cuda.reset_launches()
  t0 = time.perf_counter()
  out = step.step_n_b(model, data, n, refresh='none')
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = dict(linalg_cuda.launches)
  expect = n * (model.opt.solver_iterations + 1)
  check(launches['cholesky_solve'] == expect, f'K3 launches {launches}')
  check(launches['cholesky_solve_factor'] == 0 and
        launches['cholesky_resolve_const'] == 0, f'launches {launches}')
  finite = bool(torch.isfinite(out.qpos).all() and
                torch.isfinite(out.qvel).all())
  check(finite, 'non-finite state after the environment step')
  emit({'phase': 'environment_model', 'batch': B_ENV, 'substeps': n,
        'launches': launches, 'finite': finite, 'wall_s_per_control_step':
        wall, 'npair': model.npair})
  return launches


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


def _device_ms(torch, fn, reps):
  """Per-call device time of `fn`: the summed durations of the kernels it
  launches over `reps` calls, from torch.profiler.  Host work and waits
  between kernels are not counted."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  us = sum(e.self_device_time_total for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA)
  check(us > 0, 'the profiler saw no device time')
  return us / 1e3 / reps


def _bound(b, n, elem, kind):
  """Least time (ms) for the work: bytes (each input read once, each
  output written once) over HBM rate vs FMAs over the FP32/FP64 rate."""
  mat, vec = b * n * n * elem, b * n * elem
  if kind == 'solve_factor':
    nbytes = mat + vec + vec + mat
    fmas = b * (n ** 3 / 3 + n * n)
  elif kind == 'resolve':
    nbytes = mat + vec + vec
    fmas = b * n * n
  else:
    nbytes = mat + vec + vec
    fmas = b * (n ** 3 / 3 + n * n)
  peak = PEAK_F32_FLOPS if elem == 4 else PEAK_F64_FLOPS
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  t_ops = 2 * fmas / peak * 1e3
  return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations')


def phase_kernels(torch, pkg, main, env_launches, smi):
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
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device=dev))
  rows, checks = [], {}
  for name, replaces in KERNELS:
    errs = {}
    for set_name, (h, g) in sets.items():
      h64d, g64d = h.double(), g.double()
      x_ref = torch.linalg.solve(h64d, g64d)
      # Condition-aware tolerance for float32: kernel and plain version are
      # both backward-stable Choleskys, so they may differ by ~cond * eps.
      ev = torch.linalg.eigvalsh(h64d)
      cond = (ev[:, -1] / ev[:, 0].clamp_min(1e-300)).max().item()
      scale = x_ref.abs().max().item()
      tol = max(1e-4, 100 * cond * 6e-8) * scale
      if name == 'cholesky_solve_factor':
        x, fac = lc.cholesky_solve_factor(h, g)
        x_p, fac_p = lc.solve_factor_plain(h, g)
        fac_err = (fac - fac_p)[:, low].abs().max().item()
        fac_tol = 1e-4 * fac_p[:, low].abs().max().item()
        check(fac_err <= fac_tol, f'{name} factor {set_name}: {fac_err}')
        errs[set_name + '_factor'] = fac_err
      elif name == 'cholesky_resolve_const':
        fac = lc.factor_plain(h)
        x = lc.cholesky_resolve_const(fac, g)
        x_p = lc.resolve_plain(fac, g)
      else:
        x = lc.cholesky_solve(h, g)
        x_p = lc.solve_plain(h, g)
      err = (x - x_p).abs().max().item()
      err64 = (x.double() - x_ref).abs().max().item()
      check(err <= tol, f'{name} vs plain on {set_name}: {err} > {tol}')
      check(err64 <= tol, f'{name} vs float64 on {set_name}: {err64} > {tol}')
      # Backward error |H x - g| / (n |H| |x| + |g|), independent of the
      # conditioning: a float32 Cholesky keeps it near n * eps (~2e-6).
      x64 = x.double()
      res = (h64d @ x64[..., None])[..., 0] - g64d
      bwd = (res.abs().amax(-1) / (n * h64d.abs().amax((-2, -1))
                                   * x64.abs().amax(-1)
                                   + g64d.abs().amax(-1))).max().item()
      check(bwd <= 1e-4, f'{name} backward error on {set_name}: {bwd}')
      errs[set_name + '_backward'] = bwd
      errs[set_name] = err
      errs[set_name + '_vs_f64'] = err64
      errs[set_name + '_tol'] = tol
      errs[set_name + '_cond'] = cond
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
    else:
      fn = lambda: lc.cholesky_solve(h, g)
      plain = lambda: lc.solve_plain(h, g)
      lib = lambda: torch.cholesky_solve(g3, torch.linalg.cholesky_ex(h)[0])
      kind = 'solve'
    # The library yardstick uses cholesky_ex, which does not synchronise to
    # check for failure (torch.linalg.cholesky does).
    ms = _device_ms(torch, fn, 100)
    plain_ms = _device_ms(torch, plain, 5)
    lib_ms = _device_ms(torch, lib, 50)
    call_ms = _call_ms(torch, fn, 100)
    bound_ms, bound_by = _bound(B_PLAN, n, 4, kind)
    path_launches = (env_launches[name] if name == 'cholesky_solve'
                     else main['launches'][name])
    rows.append({
        'name': name, 'route': 'cuda', 'source': SOURCE,
        'replaces': replaces, 'launches': path_launches,
        'path': ('environment_model' if name == 'cholesky_solve'
                 else 'main_path'),
        'max_abs_err': max(checks[name][s] for s in sets), 'ms': ms,
        'kernel_ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': bound_by, 'library_ms': lib_ms, 'call_ms': call_ms,
        'shape': [B_PLAN, n, n], 'dtype': 'float32', 'card': smi})
  emit({'phase': 'kernel_checks', 'errors': checks})
  return rows


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
  chol = [k for k in kern if 'cholesky_kernel' in k[2]]
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


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--profile', action='store_true',
                      help='also profile one planning control step')
  args = parser.parse_args()

  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this script runs on the GPU only',
          file=sys.stderr)
    return 2
  sys.path.insert(0, ROOT)
  import dexterity_tpu_torch  # noqa: F401  (TF32 off)
  from dexterity_tpu_torch import manipulation
  from dexterity_tpu_torch.core import types
  from dexterity_tpu_torch.physics import constraint, linalg_cuda, smooth, step
  from dexterity_tpu_torch.physics.collision import primitives
  from dexterity_tpu_torch.planners import common
  pkg = dict(types=types, step=step, linalg_cuda=linalg_cuda,
             primitives=primitives, common=common, manipulation=manipulation,
             smooth=smooth, constraint=constraint)

  smi = nvidia_smi_line()
  phase_probe(torch, linalg_cuda, smi)
  main_out = phase_main_path(torch, pkg)
  env_launches = phase_env(torch, pkg, main_out['task'])
  rows = phase_kernels(torch, pkg, main_out, env_launches, smi)
  if args.profile:
    phase_profile(torch, pkg, main_out)
  emit({'kernels': rows, 'card': smi})
  print(smi, flush=True)
  emit({'ok': True, 'device': {'platform': 'gpu',
                               'kind': torch.cuda.get_device_name(0),
                               'count': torch.cuda.device_count()}})
  return 0


if __name__ == '__main__':
  sys.exit(main())
