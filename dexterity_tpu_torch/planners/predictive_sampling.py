"""Predictive-sampling MPC (port of
dexterity_tpu/planners/predictive_sampling.py).

One `solve` samples N candidate action sequences around the nominal plan
(spline-smoothed Gaussian noise, first candidate = nominal), rolls each
out H control steps through the batched physics (`step.step_n_b`, or
with batched_rollouts=False the per-environment `step.step_n`), scores
them by task reward, keeps the best (or an MPPI-weighted average) as the
new nominal, and emits its first action; CEM-style iterations repeat this
with shrinking noise.  `solve_batch` flattens G streams' populations into
one (G·N) rollout batch, what `bench.py` times.

Randomness comes from an explicit torch.Generator on the model's device,
passed where the JAX package passes keys; JAX's threefry streams are not
reproduced (tests inject the same noise into both).  Ties in the argmax
take the first index.  The planning model lives on `cuda` unless the
caller passes `device='cpu'`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dexterity_tpu_torch.core import types as T
from dexterity_tpu_torch.physics import step as physics_step
from dexterity_tpu_torch.planners import common
from dexterity_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class PredictiveSamplingConfig:
  """The JAX package's configuration, field for field, without
  `rollout_unroll` (an XLA scan-unroll factor with no eager counterpart).
  See dexterity_tpu/planners/predictive_sampling.py for the measured
  reasons behind each default."""
  horizon: int = 10            # control steps to look ahead
  num_samples: int = 512       # candidate action sequences per solve
  noise_scale: float = 0.2     # exploration std, in units of ctrl range
  # Noise at `num_knots` control points, linearly interpolated to the H
  # steps (0 or >= horizon: white noise).
  num_knots: int = 4
  # > 0: nominal <- softmax-weighted average of the candidates at this
  # temperature (in units of the return spread); 0 keeps the argmax.
  temperature: float = 0.0
  iterations: int = 2          # CEM refinement iterations per solve
  noise_decay: float = 0.5     # noise multiplier per iteration
  # One-time penalty at the step the task's rollout failure first fires.
  failure_penalty: float = 30.0
  # Planning-model physics (planners/common.reduced_planning_model).
  solver_iterations: int = 4
  ls_iterations: int = 6
  solver_refactor_every: int = 2
  plan_substeps: Optional[int] = None
  plan_midphase_cap: Optional[int] = 16
  plan_contact_top_k: Optional[int] = 16
  plan_implicit_damping: bool = True
  plan_self_collision: bool = False
  # One midphase selection per control step (from its first substep),
  # reused by every substep of the step.
  plan_midphase_per_control_step: bool = True
  # Roll the population through the batch-minor substep (step_n_b) with
  # the minimal carry and the hoisted midphase; False rolls each candidate
  # out with rollout_return (step_n: full carry, midphase every substep).
  batched_rollouts: bool = True


@dataclasses.dataclass(frozen=True)
class PlannerState:
  nominal: torch.Tensor        # (H, nu), or (G, H, nu) for solve_batch
  best_return: torch.Tensor    # (), or (G,): score of nominal on last solve


def _shift(plan: torch.Tensor) -> torch.Tensor:
  """Receding horizon: the plan (..., H, nu) one step on, its last action
  repeated."""
  return torch.cat([plan[..., 1:, :], plan[..., -1:, :]], dim=-2)


class _RewardState:
  """Minimal task-state view for reward evaluation during planning."""

  __slots__ = ('goal', 'goal_distance')

  def __init__(self, goal, goal_distance):
    self.goal = goal
    self.goal_distance = goal_distance


class PredictiveSampling:
  """Zero-order sampling MPC over a GoalTask."""

  def __init__(self, task, config: PredictiveSamplingConfig =
               PredictiveSamplingConfig(), device=None,
               dtype=torch.float32, extra_reward_fn=None):
    """Args:
      device: where the planning model and every rollout live (cuda unless
        given).
      dtype: the planning model's dtype.
      extra_reward_fn: optional (model, data, goals) -> (M,) planning
        shaping added to the task reward inside rollouts only.
    """
    self.task = task
    self.config = config
    self.extra_reward_fn = extra_reward_fn
    self.model, self.n_plan_substeps = common.reduced_planning_model(
        task,
        solver_iterations=config.solver_iterations,
        ls_iterations=config.ls_iterations,
        solver_refactor_every=config.solver_refactor_every,
        plan_substeps=config.plan_substeps,
        plan_midphase_cap=config.plan_midphase_cap,
        plan_contact_top_k=config.plan_contact_top_k,
        plan_implicit_damping=config.plan_implicit_damping,
        plan_self_collision=config.plan_self_collision,
        device=device, dtype=dtype)
    model = self.model
    self.dtype = model.dtype
    self.device = model.device
    spec = task.action_spec(model)
    lo = np.where(np.isfinite(spec.minimum), spec.minimum, -1.0)
    hi = np.where(np.isfinite(spec.maximum), spec.maximum, 1.0)
    self._lo = torch.as_tensor(lo, dtype=self.dtype, device=self.device)
    self._hi = torch.as_tensor(hi, dtype=self.dtype, device=self.device)
    self.nu = spec.shape[0]
    self._act_ids = self._action_actuator_ids(model)
    self._act_idx = torch.as_tensor(self._act_ids, dtype=torch.int64,
                                    device=self.device)
    self._interp = self._knot_interpolation()

  def _action_actuator_ids(self, model):
    ids = []
    for eff in self.task.hand_effectors:
      ids.extend(eff.indices(model).tolist())
    return np.asarray(ids, np.int32)

  def _knot_interpolation(self) -> Optional[torch.Tensor]:
    """(H, k) linear interpolation of k noise knots onto the H steps, or
    None for white noise."""
    cfg = self.config
    k = cfg.num_knots
    if not k or k >= cfg.horizon:
      return None
    t = np.linspace(0.0, k - 1.0, cfg.horizon)
    i0 = np.clip(np.floor(t).astype(int), 0, k - 2)
    w = t - i0
    interp = np.zeros((cfg.horizon, k))
    interp[np.arange(cfg.horizon), i0] = 1.0 - w
    interp[np.arange(cfg.horizon), i0 + 1] = w
    return torch.as_tensor(interp, dtype=self.dtype, device=self.device)

  # -- core ---------------------------------------------------------------

  def init_state(self, data: Optional[T.Data] = None,
                 streams: Optional[int] = None) -> PlannerState:
    """The mid-range plan; with `streams`, G stacked states for
    solve_batch."""
    del data
    mid = (self._lo + self._hi) / 2.0
    nominal = mid.expand(self.config.horizon, self.nu).clone()
    best = torch.tensor(-float('inf'), dtype=self.dtype, device=self.device)
    if streams is not None:
      nominal = nominal.expand(streams, *nominal.shape).clone()
      best = best.expand(streams).clone()
    return PlannerState(nominal=nominal, best_return=best)

  def _reward(self, d, goals, alive):
    """One control step's rewards and the alive mask after it: rewards
    stop accruing once the task's rollout failure fires, and the step
    where it first fires costs `failure_penalty`."""
    model, task = self.model, self.task
    gen = task.goal_generator
    dist = gen.goal_distance(goals, gen.current_state(model, d))
    r = task.get_reward(model, d, _RewardState(goals, dist))
    if self.extra_reward_fn is not None:
      r = r + self.extra_reward_fn(model, d, goals)
    alive_after = alive & ~task.rollout_failure(model, d)
    r = torch.where(alive_after, r,
                    torch.where(alive,
                                r.new_full((), -self.config.failure_penalty),
                                r.new_zeros(())))
    return r, alive_after

  def _set_ctrl(self, d, action):
    ctrl = d.ctrl.clone()
    ctrl[..., self._act_idx] = torch.clamp(action, self._lo, self._hi)
    return d.replace(ctrl=ctrl)

  def rollout_return(self, data: T.Data, goal: torch.Tensor,
                     actions: torch.Tensor) -> torch.Tensor:
    """Return of action sequences (..., H, nu) from data and goals with
    the same leading shape (none for one sequence), -> (...).  Each
    control step runs the per-environment `step.step_n` with the task's
    plan_refresh: the full carry and a midphase selection every substep.

    `alive` starts True, as in the reference's per-environment
    rollout_return, so a start state whose qpos is NaN accrues its
    (NaN) rewards here, where rollout_returns_flat scores it 0: the two
    paths differ on such a row, in the reference as here."""
    alive = torch.ones(actions.shape[:-2], dtype=torch.bool,
                       device=actions.device)
    d = data
    total = 0.0
    for action in actions.unbind(-2):
      d = physics_step.step_n(self.model, self._set_ctrl(d, action),
                              self.n_plan_substeps,
                              refresh=self.task.plan_refresh)
      r, alive = self._reward(d, goal, alive)
      total = total + r
    return total

  def _broadcast(self, data: T.Data, goal: torch.Tensor, n: int):
    """One environment's data and goal repeated for n candidates."""
    bdata = T.map_data(
        data, lambda x: x.unsqueeze(0).expand((n,) + x.shape).contiguous())
    return bdata, goal.unsqueeze(0).expand((n,) + goal.shape)

  def rollout_returns_batched(self, data: T.Data, goal: torch.Tensor,
                              actions: torch.Tensor) -> torch.Tensor:
    """Returns of N candidate sequences (N, H, nu) -> (N,) from one
    environment's data and goal."""
    bdata, goals = self._broadcast(data, goal, actions.shape[0])
    return self.rollout_returns_flat(bdata, goals, actions)

  def rollout_returns_flat(self, bdata: T.Data, goals: torch.Tensor,
                           actions: torch.Tensor) -> torch.Tensor:
    """Returns with per-candidate data and goals (leading axis M on
    everything): bdata (M, ...), goals (M, 4), actions (M, H, nu) ->
    (M,).  Rewards stop accruing once the task's rollout failure fires,
    and the step where it first fires costs `failure_penalty`.  A row
    whose start qpos is NaN is dead from the start and returns 0, as in
    the reference."""
    with profiling.trace_annotation('planner.rollout'):
      model = self.model
      cfg = self.config
      task = self.task
      acts_t = actions.transpose(0, 1)                     # (H, M, nu)
      # Position-level planning rewards never read the dynamics outputs:
      # carry only the integrator state, rebuilding each control step's Data
      # from the pre-rollout bdata.
      minimal = task.plan_refresh in ('none', 'position')
      fields = physics_step._STEP_CARRY_MIN
      midphase = ('per_call' if cfg.plan_midphase_per_control_step
                  else 'per_substep')
      carry = ({f: getattr(bdata, f) for f in fields} if minimal else bdata)
      # A NaN start row is dead from step 0 (NaN != NaN).
      alive = bdata.qpos[:, 0] == bdata.qpos[:, 0]
      rewards = []
      for action in acts_t:
        d = bdata.replace(**carry) if minimal else carry
        d = physics_step.step_n_b(
            model, self._set_ctrl(d, action), self.n_plan_substeps,
            refresh=task.plan_refresh, midphase=midphase,
            carry='minimal' if minimal else 'full')
        r, alive = self._reward(d, goals, alive)
        rewards.append(r)
        carry = {f: getattr(d, f) for f in fields} if minimal else d
      return torch.stack(rewards).sum(0)

  def _sample_noise(self, gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, H, nu) exploration noise from `gen`; spline-smoothed when
    num_knots > 0."""
    cfg = self.config
    rng = self._hi - self._lo
    steps = cfg.horizon if self._interp is None else cfg.num_knots
    z = torch.randn((n, steps, self.nu), generator=gen, dtype=self.dtype,
                    device=self.device) * cfg.noise_scale * rng
    if self._interp is None:
      return z
    return torch.einsum('hk,nku->nhu', self._interp, z)

  def _candidates(self, nominal, gen, noise_mult):
    """(N, H, nu) candidates around `nominal`: the nominal itself, then
    N - 1 noisy copies, clipped to the action range."""
    noise = self._sample_noise(gen, self.config.num_samples - 1) * noise_mult
    candidates = torch.cat([nominal[None], nominal[None] + noise])
    return torch.clamp(candidates, self._lo, self._hi)

  def _select(self, candidates, returns):
    """The plan kept from scored candidates and its return: the argmax
    (first index on ties) or, at temperature > 0, the MPPI-weighted
    average normalised by the return spread."""
    cfg = self.config
    best = torch.argmax(returns)
    if cfg.temperature > 0:
      spread = torch.clamp_min(returns.max() - returns.min(), 1e-6)
      w = torch.softmax((returns - returns.max())
                        / (cfg.temperature * spread), dim=0)
      seq = torch.einsum('n,nhu->hu', w, candidates)
      seq = torch.clamp(seq, self._lo, self._hi)
    else:
      seq = candidates[best]
    return seq, returns[best]

  def _one_iteration(self, data, goal, nominal, gen, noise_mult):
    """Samples around `nominal`, evaluates, returns (plan, best
    return)."""
    candidates = self._candidates(nominal, gen, noise_mult)
    if self.config.batched_rollouts:
      returns = self.rollout_returns_batched(data, goal, candidates)
    else:
      returns = self.rollout_return(
          *self._broadcast(data, goal, candidates.shape[0]), candidates)
    return self._select(candidates, returns)

  def solve(self, data: T.Data, goal: torch.Tensor, pstate: PlannerState,
            gen: torch.Generator):
    """One MPC solve for one environment (unbatched Data). Returns
    (action (nu,), new PlannerState)."""
    cfg = self.config
    best_seq = pstate.nominal
    best_ret = torch.tensor(-float('inf'), dtype=self.dtype,
                            device=self.device)
    mult = 1.0
    for _ in range(max(cfg.iterations, 1)):
      best_seq, best_ret = self._one_iteration(data, goal, best_seq, gen,
                                               mult)
      mult = mult * cfg.noise_decay
    return best_seq[0], PlannerState(nominal=_shift(best_seq),
                                     best_return=best_ret)

  def _flatten_streams(self, data_b: T.Data, goals: torch.Tensor):
    """G streams' data and goals repeated for their N candidates, as one
    (G·N) leading axis."""
    g, n = goals.shape[0], self.config.num_samples
    bdata = T.map_data(data_b, lambda x: x.unsqueeze(1).expand(
        (g, n) + x.shape[1:]).reshape((g * n,) + x.shape[1:]))
    goals_f = goals.unsqueeze(1).expand((g, n) + goals.shape[1:]).reshape(
        (g * n,) + goals.shape[1:])
    return bdata, goals_f

  def _candidates_batch(self, best_seq, gen, noise_mult):
    """(G, N, H, nu) candidates around G nominals, the G streams' noise
    drawn in one call, (G·(N-1), H, nu)."""
    cfg = self.config
    g, n = best_seq.shape[0], cfg.num_samples
    noise = self._sample_noise(gen, g * (n - 1)).reshape(
        g, n - 1, cfg.horizon, self.nu) * noise_mult
    cands = torch.cat([best_seq[:, None], best_seq[:, None] + noise], 1)
    return torch.clamp(cands, self._lo, self._hi)

  def _select_batch(self, cands, returns):
    """Each stream's argmax (first index on ties): plans (G, H, nu) and
    returns (G,) from cands (G, N, H, nu) and returns (G, N)."""
    best = torch.argmax(returns, dim=1)
    rows = torch.arange(cands.shape[0], device=cands.device)
    return cands[rows, best], returns[rows, best]

  def solve_batch(self, data_b: T.Data, goals: torch.Tensor, pstates:
                  PlannerState, gen: torch.Generator):
    """G concurrent MPC solves as one (G·N) rollout batch: data_b and
    goals carry a leading G, pstates (G, H, nu) / (G,).  Each iteration
    draws the G streams' noise in one call, (G·(N-1), H, nu).  Returns
    (actions (G, nu), new PlannerState)."""
    with profiling.trace_annotation('planner.solve_batch'):
      cfg = self.config
      g = goals.shape[0]
      best_seq = pstates.nominal                           # (G, H, nu)
      best_ret = torch.full((g,), -float('inf'), dtype=self.dtype,
                            device=self.device)
      mult = 1.0
      # The flattened rollout initial state and goals are the same in every
      # iteration: built once.
      bdata, goals_f = self._flatten_streams(data_b, goals)
      for _ in range(max(cfg.iterations, 1)):
        with profiling.trace_annotation('planner.iteration'):
          cands = self._candidates_batch(best_seq, gen, mult)
          returns = self.rollout_returns_flat(
              bdata, goals_f, cands.reshape((-1,) + cands.shape[2:]))
          best_seq, best_ret = self._select_batch(cands,
                                                  returns.reshape(g, -1))
        mult = mult * cfg.noise_decay
      return best_seq[:, 0], PlannerState(nominal=_shift(best_seq),
                                          best_return=best_ret)

  def action(self, env_state, pstate: PlannerState, gen: torch.Generator):
    """Convenience: plans from an environment state with `.data` and
    `.task.goal`."""
    return self.solve(env_state.data, env_state.task.goal, pstate, gen)
