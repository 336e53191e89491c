"""iLQR trajectory optimizer over the batched contact physics (port of
dexterity_tpu/planners/ilqr.py).

One `solve` runs iLQR iterations from the shifted nominal plan for G
goals at once (the JAX package vmaps its per-goal solve; here every goal
is a row of one batch).  Each iteration rolls the nominal out, linearizes
the dynamics and the stage cost at every (x_t, u_t), runs the backward
Riccati recursion with Tassa-style regularization and a parallel forward
line search (alpha = 0 is always a candidate, so an iteration never
regresses), and adapts the Levenberg regularization.

The linearizer takes forward-mode tangents through the physics
(`torch.autograd.forward_ad`).  The JAX package takes `jacfwd` over the
combined input z = (x, u) inside a vmap over the H pre-step states; here
every (goal, t, tangent) is a row: (x_t, u_t) made dual with one unit
tangent along z, all G·H·(nx+nu) rows through one `step_n` and one cost
evaluation (20,736 rows at G = 8, H = 32 on reorient; 5.5 GB peak on the
card, PERF.md §6).  The derivative rules of the Cholesky kernels
(physics/linalg_cuda.py) carry the tangents through the constraint
solve: K2 for the refactor and stale-factor iterations, K3 with
solver_refactor_every = 1.

The Riccati solves of quu (nu x nu) are `torch.linalg.cholesky_ex` and
`torch.cholesky_solve`, batched over G: the JAX package computes them
with jax.scipy.linalg outside any Pallas kernel.  A factorization that
fails gives NaN gains, as JAX's does, and the alpha = 0 candidate (a
selection, not a product) then replays the nominal.

State chart: x = [qpos, qvel]; derivatives live in the ambient chart.
The planning model lives on `cuda` unless the caller passes
`device='cpu'`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.autograd import forward_ad

from dexterity_tpu_torch.core import types as T
from dexterity_tpu_torch.physics import step as physics_step
from dexterity_tpu_torch.planners import common
from dexterity_tpu_torch.planners.predictive_sampling import _RewardState


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
  """The JAX package's configuration, field for field."""
  horizon: int = 16
  iterations: int = 4          # iLQR outer iterations per solve
  reg_init: float = 1e-4       # Levenberg regularization (adapted in-solve)
  reg_min: float = 1e-8
  reg_max: float = 1e4
  line_search_steps: int = 6   # parallel alphas 0, 1, 1/2, ... 1/2^(k-2)
  ctrl_cost: float = 1e-3      # quadratic control penalty
  # Reduced-fidelity planning physics (planners/common.py).
  solver_iterations: int = 4
  ls_iterations: int = 6
  solver_refactor_every: int = 4
  plan_substeps: Optional[int] = None
  plan_midphase_cap: Optional[int] = 16
  plan_contact_top_k: Optional[int] = 16
  plan_implicit_damping: bool = True
  plan_self_collision: bool = False


@dataclasses.dataclass(frozen=True)
class ILQRState:
  us: torch.Tensor             # (G, H, nu) nominal controls (one goal: H, nu)
  cost: torch.Tensor           # (G,) last trajectory cost (one goal: ())


def _clip(u, lo, hi):
  # min(max(.)), as jnp.clip: a tangent at a bound is halved, as in JAX.
  return torch.minimum(torch.maximum(u, lo), hi)


def _mT(x):
  return x.transpose(-1, -2)


def _cho_solve(quu, rhs):
  """quu^-1 rhs for batched SPD quu; NaN where the factorization fails
  (jax.scipy.linalg.cho_factor gives NaN there)."""
  chol, info = torch.linalg.cholesky_ex(quu)
  chol = torch.where((info == 0)[..., None, None], chol,
                     torch.full_like(chol, float('nan')))
  return torch.cholesky_solve(rhs, chol)


class ILQR:
  """iLQR MPC over a GoalTask.

  Args:
    device: where the planning model and every rollout live (cuda unless
      given).
    dtype: the planning model's dtype.
    extra_cost_fn: optional (model, data (M, ...), goals (M, ...)) -> (M,)
      planning cost added to the stage cost (positive = penalized).
  """

  def __init__(self, task, config: ILQRConfig = ILQRConfig(), device=None,
               dtype=torch.float32, extra_cost_fn: Optional[Callable] = None):
    self.task = task
    self.config = config
    self.extra_cost_fn = extra_cost_fn
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
    ids = []
    for eff in task.hand_effectors:
      ids.extend(eff.indices(model).tolist())
    self._act_ids = np.asarray(ids, np.int32)
    self._act_idx = torch.as_tensor(self._act_ids, dtype=torch.int64,
                                    device=self.device)
    self.nx = model.nq + model.nv

  # -- dynamics in the flat chart -------------------------------------------

  def _pack(self, data: T.Data) -> torch.Tensor:
    return torch.cat([data.qpos, data.qvel], -1)

  def _unpack(self, template: T.Data, x: torch.Tensor) -> T.Data:
    nq = self.model.nq
    return template.replace(qpos=x[..., :nq], qvel=x[..., nq:])

  def _f(self, template: T.Data, x: torch.Tensor,
         u: torch.Tensor) -> torch.Tensor:
    """One control step from x under u (M rows) -> (M, nx).  Every other
    field, the Newton warm start (qacc) included, is the template's."""
    d = self._unpack(template, x)
    ctrl = d.ctrl.clone()
    ctrl[..., self._act_idx] = _clip(u, self._lo, self._hi)
    d = physics_step.step_n(self.model, d.replace(ctrl=ctrl),
                            self.n_plan_substeps,
                            refresh=self.task.plan_refresh)
    return self._pack(d)

  def _cost(self, template: T.Data, goals, x: torch.Tensor,
            u: torch.Tensor) -> torch.Tensor:
    """Stage cost of (x, u) (M rows) -> (M,)."""
    d = physics_step.fwd_position(self.model, self._unpack(template, x))
    gen = self.task.goal_generator
    dist = gen.goal_distance(goals, gen.current_state(self.model, d))
    r = self.task.get_reward(self.model, d, _RewardState(goals, dist))
    c = -r + self.config.ctrl_cost * torch.sum(u * u, -1)
    if self.extra_cost_fn is not None:
      c = c + self.extra_cost_fn(self.model, d, goals)
    return c

  # -- solver -----------------------------------------------------------------

  def init_state(self, streams: Optional[int] = None) -> ILQRState:
    """The mid-range plan; with `streams`, G stacked states."""
    mid = (self._lo + self._hi) / 2.0
    us = mid.expand(self.config.horizon, self.nu).clone()
    cost = torch.tensor(float('inf'), dtype=self.dtype, device=self.device)
    if streams is not None:
      us = us.expand(streams, *us.shape).clone()
      cost = cost.expand(streams).clone()
    return ILQRState(us=us, cost=cost)

  def warm_start(self, plan: torch.Tensor) -> ILQRState:
    """ILQRState seeded from another planner's action sequences
    ((G,) H', nu): predictive sampling explores, iLQR refines.  Plans
    shorter than the horizon repeat their last action."""
    h = self.config.horizon
    us = plan[..., :h, :]
    if us.shape[-2] < h:
      last = us[..., -1:, :]
      us = torch.cat([us, last.expand(*last.shape[:-2], h - us.shape[-2],
                                      last.shape[-1])], -2)
    us = us.to(self.dtype)
    cost = torch.full(us.shape[:-2], float('inf'), dtype=self.dtype,
                      device=us.device)
    return ILQRState(us=us, cost=cost)

  def trajectory_cost(self, template: T.Data, goals, x0: torch.Tensor,
                      us: torch.Tensor) -> torch.Tensor:
    """Summed stage cost of plans us (M, H, nu) from x0 (M, nx) -> (M,)."""
    x, total = x0, 0.0
    for u in us.unbind(-2):
      total = total + self._cost(template, goals, x, u)
      x = self._f(template, x, u)
    return total

  def _rollout(self, template, x0, us):
    """Pre-step states (G, H, nx) of the plans us (G, H, nu)."""
    xs, x = [], x0
    for u in us.unbind(1):
      xs.append(x)
      x = self._f(template, x, u)
    return torch.stack(xs, 1)

  def _rows(self, template, goals, idx):
    return (T.map_data(template, lambda a: a[idx]), goals[idx])

  def _linearize(self, template, goals, xs, us):
    """fx (G, H, nx, nx), fu (G, H, nx, nu), cx (G, H, nx), cu (G, H, nu)
    at the pre-step states xs and controls us: one forward-mode pass over
    G·H·(nx+nu) rows, row ((g·H + t)·nz + i) carrying the unit tangent
    e_i of z = (x, u) at goal g, step t."""
    g, h = us.shape[:2]
    nx, nz = self.nx, self.nx + self.nu
    rows = torch.arange(g * h * nz, device=self.device)
    tmpl, goal_rows = self._rows(template, goals, rows // (h * nz))
    z = torch.cat([xs, us], -1).reshape(g * h, nz)[rows // nz]
    tz = torch.eye(nz, dtype=self.dtype, device=self.device)[rows % nz]
    with forward_ad.dual_level():
      zd = forward_ad.make_dual(z, tz)
      xd, ud = zd[:, :nx], zd[:, nx:]
      df = forward_ad.unpack_dual(self._f(tmpl, xd, ud)).tangent
      dc = forward_ad.unpack_dual(self._cost(tmpl, goal_rows, xd, ud)).tangent
    fz = _mT(df.reshape(g, h, nz, nx))                  # (G, H, nx, nz)
    cz = dc.reshape(g, h, nz)
    return fz[..., :nx], fz[..., nx:], cz[..., :nx], cz[..., nx:]

  def _backward_pass(self, fx, fu, cx, cu, reg):
    """Gains k (G, H, nu) and K (G, H, nu, nx) of the Gauss-Newton
    Riccati recursion (cost Hessians approximated by identity-regularized
    terms; gradients exact).  The regularization enters Tassa-style
    through the value function (vxx + reg·I inside the Q terms): with
    stiff contact Jacobians a plain quu shift is dominated by fu'vxx fu
    and the gains explode."""
    cfg = self.config
    g, h = fu.shape[:2]
    nx, nu = self.nx, self.nu
    r = reg[:, None, None]
    eye_x = torch.eye(nx, dtype=self.dtype, device=self.device)
    eye_u = torch.eye(nu, dtype=self.dtype, device=self.device)
    vx = torch.zeros(g, nx, dtype=self.dtype, device=self.device)
    vxx = r * eye_x
    ks, kks = [None] * h, [None] * h
    for t in reversed(range(h)):
      fx_t, fu_t = fx[:, t], fu[:, t]
      vxx_reg = vxx + r * eye_x
      qx = cx[:, t] + (_mT(fx_t) @ vx[..., None])[..., 0]
      qu = cu[:, t] + (_mT(fu_t) @ vx[..., None])[..., 0]
      qxx = _mT(fx_t) @ vxx @ fx_t + r * eye_x
      quu = _mT(fu_t) @ vxx_reg @ fu_t + (2 * cfg.ctrl_cost + r) * eye_u
      qux = _mT(fu_t) @ vxx_reg @ fx_t
      k = -_cho_solve(quu, qu[..., None])                # (G, nu, 1)
      kk = -_cho_solve(quu, qux)                         # (G, nu, nx)
      vx = (qx[..., None] + _mT(kk) @ quu @ k + _mT(kk) @ qu[..., None]
            + _mT(qux) @ k)[..., 0]
      vxx = qxx + _mT(kk) @ quu @ kk + _mT(kk) @ qux + _mT(qux) @ kk
      vxx = 0.5 * (vxx + _mT(vxx))
      ks[t], kks[t] = k[..., 0], kk
    return torch.stack(ks, 1), torch.stack(kks, 1)

  def _alphas(self):
    steps = self.config.line_search_steps
    return torch.cat([
        torch.zeros(1, dtype=self.dtype, device=self.device),
        2.0 ** -torch.arange(steps - 1, dtype=self.dtype,
                             device=self.device)])

  def _line_search(self, template, goals, x0, us, xs, ks, kks):
    """The L step sizes' closed-loop rollouts, L x G rows per control
    step: plans (L, G, H, nu) and costs (L, G).  alpha = 0 disables the
    feedback as well and replays the nominal controls exactly: the update
    is selected away, not multiplied by 0, so NaN gains cannot reach
    it."""
    alphas = self._alphas()
    n_l, g = alphas.shape[0], us.shape[0]
    tmpl, goal_rows = self._rows(
        template, goals,
        torch.arange(g, device=self.device).repeat(n_l))
    a = alphas.repeat_interleave(g)[:, None]               # (L·G, 1)
    on = a > 0
    x = x0.repeat(n_l, 1)
    us_r, xs_r = us.repeat(n_l, 1, 1), xs.repeat(n_l, 1, 1)
    ks_r, kks_r = ks.repeat(n_l, 1, 1), kks.repeat(n_l, 1, 1, 1)
    u_out, total = [], 0.0
    for t in range(us.shape[1]):
      fb = (kks_r[:, t] @ (x - xs_r[:, t])[..., None])[..., 0]
      upd = torch.where(on, a * ks_r[:, t] + fb, torch.zeros_like(fb))
      u = _clip(us_r[:, t] + upd, self._lo, self._hi)
      total = total + self._cost(tmpl, goal_rows, x, u)
      x = self._f(tmpl, x, u)
      u_out.append(u)
    return (torch.stack(u_out, 1).reshape(n_l, g, *us.shape[1:]),
            total.reshape(n_l, g))

  def _select(self, us, cands, costs, cost_prev, reg):
    """NaN-safe argmin over the L candidates per goal (first index among
    ties); keeps the incoming plan when every candidate diverged, and
    adapts the Levenberg regularization."""
    cfg = self.config
    costs_safe = torch.where(torch.isnan(costs),
                             torch.full_like(costs, float('inf')), costs)
    best = torch.argmin(costs_safe, 0)                     # (G,)
    rows = torch.arange(us.shape[0], device=self.device)
    c_best = costs_safe[best, rows]
    ok = torch.isfinite(c_best)
    us_out = torch.where(ok[:, None, None], cands[best, rows], us)
    cost_out = torch.where(ok, c_best,
                           torch.where(torch.isfinite(cost_prev), cost_prev,
                                       costs_safe[0]))
    cost0 = costs_safe[0]
    improved = ok & (c_best < cost0 - 1e-9 * torch.abs(cost0))
    reg_new = torch.where(improved, torch.clamp_min(reg * 0.5, cfg.reg_min),
                          torch.clamp_max(reg * 4.0, cfg.reg_max))
    return us_out, cost_out, reg_new

  def _start(self, data, state):
    full = lambda v: torch.full(data.qpos.shape[:1], v, dtype=self.dtype,
                                device=self.device)
    return state.us, full(float('inf')), full(self.config.reg_init)

  @staticmethod
  def _finish(us, cost):
    """The first action and the receding-horizon shift."""
    return us[:, 0], ILQRState(us=torch.cat([us[:, 1:], us[:, -1:]], 1),
                               cost=cost)

  def solve(self, data: T.Data, goals: torch.Tensor, state: ILQRState):
    """One MPC solve for G goals: data with a leading G (the environment
    model's Data), goals (G, ...), state.us (G, H, nu).  Returns
    (actions (G, nu), ILQRState)."""
    x0 = self._pack(data)
    us, cost, reg = self._start(data, state)
    for _ in range(self.config.iterations):
      xs = self._rollout(data, x0, us)
      fx, fu, cx, cu = self._linearize(data, goals, xs, us)
      ks, kks = self._backward_pass(fx, fu, cx, cu, reg)
      cands, costs = self._line_search(data, goals, x0, us, xs, ks, kks)
      us, cost, reg = self._select(us, cands, costs, cost, reg)
    return self._finish(us, cost)
