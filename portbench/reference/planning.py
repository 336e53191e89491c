"""The reference's side of a sampling-planner call (`solve_batch`).

`solve_call` works one call out again from the program's inputs: the
start states and goals, the nominal plan the call received, and the
state of the generator it drew from.  It draws the exploration noise
again from that generator state in the program's draw dtype (the same
numbers), builds the candidates, rolls them out through its own copy of
the physics and scores them.  Where `picks` is given (the candidate the
program kept in each stream and iteration), the next iteration starts
from that candidate, so the reference follows the program through near
ties of the argmax; without it the reference keeps its own argmax, as
it does where it stands in the program's place (the control).

`compare` gives the numbers that decide `correct`:
  cand_gap    candidates against those the reference draws, max-abs;
  return_*    each candidate's return against the reference's, over the
              larger of 1 and the stream's largest |return|: the 50th and
              99th percentiles over the candidates and the largest;
  regret      how far the return of the program's pick lies below the
              reference's best, on the same scale;
  action_gap  the actions emitted against the first step of the kept
              plan, max-abs;
  nominal_gap the next nominal against the kept plan shifted on, max-abs.
"""

import numpy as np
import torch

from reference.dex import manipulation
from reference.dex.planners import predictive_sampling as ps


def planner_config(plan, traffic):
  return ps.PredictiveSamplingConfig(
      horizon=traffic['horizon'], num_samples=traffic['samples'],
      noise_scale=traffic['noise_scale'], num_knots=traffic['num_knots'],
      temperature=traffic['temperature'], iterations=traffic['iterations'],
      noise_decay=traffic['noise_decay'],
      failure_penalty=traffic['failure_penalty'],
      solver_iterations=plan['solver_iterations'],
      ls_iterations=plan['ls_iterations'],
      solver_refactor_every=plan['solver_refactor_every'],
      plan_substeps=plan['plan_substeps'],
      plan_midphase_cap=plan['plan_midphase_cap'],
      plan_contact_top_k=plan['plan_contact_top_k'],
      plan_implicit_damping=plan['plan_implicit_damping'],
      plan_self_collision=plan['plan_self_collision'])


def build(config, traffic, device, dtype):
  """(environment, planner) of the reference."""
  task = manipulation.build_task(config['task'], config['variant'])
  planner = ps.PredictiveSampling(
      task, planner_config(config['plan'], traffic), device=device,
      dtype=dtype)
  env = manipulation.load(config['task'], config['variant'], device=device,
                          dtype=dtype)
  return env, planner


def _noise(planner, gen, draw_dtype, n):
  """The program's _sample_noise, drawn in draw_dtype and worked out in
  the reference's dtype."""
  cfg = planner.config
  steps = cfg.horizon if planner._interp is None else cfg.num_knots
  z = torch.randn((n, steps, planner.nu), generator=gen, dtype=draw_dtype,
                  device=planner.device).to(planner.dtype)
  z = z * cfg.noise_scale * (planner._hi - planner._lo)
  if planner._interp is None:
    return z
  return torch.einsum('hk,nku->nhu', planner._interp, z)


def solve_call(planner, data_b, goals, nominal, gen_state, draw_dtype,
               picks=None):
  """One solve_batch call worked out again; returns {'cands': [(G, N, H,
  nu)], 'returns': [(G, N)], 'picks': [(G,)], 'actions', 'nominal',
  'best_return'} in the reference's dtype."""
  cfg = planner.config
  g, n = goals.shape[0], cfg.num_samples
  gen = torch.Generator(device=planner.device)
  gen.set_state(gen_state)
  bdata, goals_f = planner._flatten_streams(data_b, goals)
  best = nominal.to(planner.dtype)
  out = {'cands': [], 'returns': [], 'picks': []}
  mult = 1.0
  streams = torch.arange(g, device=planner.device)
  for it in range(max(cfg.iterations, 1)):
    noise = _noise(planner, gen, draw_dtype, g * (n - 1)).reshape(
        g, n - 1, cfg.horizon, planner.nu) * mult
    cands = torch.clamp(torch.cat([best[:, None], best[:, None] + noise], 1),
                        planner._lo, planner._hi)
    returns = planner.rollout_returns_flat(
        bdata, goals_f, cands.reshape((-1,) + cands.shape[2:])).reshape(g, n)
    pick = (torch.argmax(returns, dim=1) if picks is None
            else picks[it].to(planner.device))
    best = cands[streams, pick]
    out['cands'].append(cands)
    out['returns'].append(returns)
    out['picks'].append(pick)
    mult = mult * cfg.noise_decay
  out['actions'] = best[:, 0]
  out['nominal'] = torch.cat([best[:, 1:], best[:, -1:]], dim=1)
  out['best_return'] = returns[streams, pick]
  return out


def picks_of(returns):
  """The program's kept candidates: each stream's argmax (first on
  ties), as solve_batch takes it."""
  return [torch.argmax(r, dim=1) for r in returns]


def compare(prog, ref):
  """The numbers that decide `correct` for one call (see the module
  docstring); prog and ref as solve_call returns them (prog's may be in
  another dtype)."""
  f64 = torch.float64

  def gap(a, b):
    return (a.to(f64) - b.to(f64)).abs().max().item()

  cand_gap = max(gap(a, b) for a, b in zip(prog['cands'], ref['cands']))
  regret = 0.0
  gaps = []
  for rp, rr, pick in zip(prog['returns'], ref['returns'], ref['picks']):
    rp, rr = rp.to(f64), rr.to(f64)
    scale = rr.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
    gaps.append(((rp - rr).abs() / scale).flatten())
    kept = rr.gather(1, pick.to(rr.device)[:, None])
    regret = max(regret, ((rr.amax(dim=1, keepdim=True) - kept)
                          / scale).max().item())
  gaps = torch.nan_to_num(torch.cat(gaps), nan=float('inf')).cpu()
  p50, p99 = torch.quantile(gaps, torch.tensor([0.5, 0.99],
                                               dtype=f64)).tolist()
  nums = {'cand_gap': cand_gap, 'return_p50': p50, 'return_p99': p99,
          'return_max': gaps.max().item(), 'regret': regret,
          'action_gap': gap(prog['actions'], ref['actions']),
          'nominal_gap': gap(prog['nominal'], ref['nominal'])}
  return {k: (float('inf') if not np.isfinite(v) else v)
          for k, v in nums.items()}


def start_gaps(prog_data, prog_goals, ref_data, ref_goals):
  """The start states and goals of the streams against the reference's
  reset from the same generator seed."""
  f64 = torch.float64
  return {
      'start_qpos_gap': (prog_data.qpos.to(f64) - ref_data.qpos.to(f64))
      .abs().max().item(),
      'start_goal_gap': (prog_goals.to(f64) - ref_goals.to(f64))
      .abs().max().item()}
