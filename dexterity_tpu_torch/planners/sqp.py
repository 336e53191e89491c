"""Gauss-Newton SQP MPC over the batched contact physics (port of
dexterity_tpu/planners/sqp.py).

SQP condenses the linearized model of planners/ilqr.py (fx, fu, cx, cu
from the same forward-mode linearizer) onto the control sequence and
solves one box-constrained QP per outer iteration:

    min_dU  g'dU + 1/2 dU' Hqp dU     s.t.  lo <= u + dU <= hi

with g the exact condensed gradient (adjoint recursion) and
Hqp = reg·B'B + (2·ctrl_cost + reg)·I the Gauss-Newton Hessian of the
identity-regularized stage model, B the sensitivity dX = B dU.  The QP is
solved by projected Newton with a gradient active set (masked rows plus
identity, one batched Cholesky per iteration), then a merit line search
on the true rollout (alpha = 0 included) and the Levenberg update.  G
goals are rows of one batch, as in ILQR.

The (H·nu)^2 QP Cholesky is `torch.linalg.cholesky_ex` and
`torch.cholesky_solve`, batched over G, as the JAX package uses
jax.scipy.linalg there.
"""

from __future__ import annotations

import dataclasses

import torch

from dexterity_tpu_torch.planners import ilqr as ilqr_lib


@dataclasses.dataclass(frozen=True)
class SQPConfig(ilqr_lib.ILQRConfig):
  # Projected-Newton iterations on the condensed QP per outer iteration.
  qp_iterations: int = 4


class SQP(ilqr_lib.ILQR):
  """SQP MPC over a GoalTask (same task/model contract as ILQR)."""

  def __init__(self, task, config: SQPConfig = SQPConfig(), device=None,
               dtype=torch.float32, extra_cost_fn=None):
    super().__init__(task, config, device=device, dtype=dtype,
                     extra_cost_fn=extra_cost_fn)

  def _condense(self, fx, fu, cx, cu, reg):
    """Condensed gradient g (G, H·nu) by the adjoint recursion, and the
    QP Hessian (G, H·nu, H·nu) from the sensitivity B."""
    cfg = self.config
    g_n, h = fu.shape[:2]
    nx, nu = self.nx, self.nu
    kw = dict(dtype=self.dtype, device=self.device)
    # lam_t = cx_t + fx_t' lam_{t+1};  g_t = cu_t + fu_t' lam_{t+1}.
    lam = torch.zeros(g_n, nx, **kw)
    g_steps = [None] * h
    for t in reversed(range(h)):
      lam_c = lam[..., None]
      g_steps[t] = cu[:, t] + (ilqr_lib._mT(fu[:, t]) @ lam_c)[..., 0]
      lam = cx[:, t] + (ilqr_lib._mT(fx[:, t]) @ lam_c)[..., 0]
    grad = torch.stack(g_steps, 1).reshape(g_n, h * nu)
    # B[t+1] = fx_t B[t] + e_t fu_t; B[t] is one (nx, H·nu) row block.
    bt = torch.zeros(g_n, nx, h * nu, **kw)
    b_rows = []
    for t in range(h):
      b_rows.append(bt)
      bt = fx[:, t] @ bt
      bt = torch.cat([bt[..., :t * nu], bt[..., t * nu:(t + 1) * nu]
                      + fu[:, t], bt[..., (t + 1) * nu:]], -1)
    big_b = torch.cat(b_rows, 1)                          # (G, H·nx, H·nu)
    r = reg[:, None, None]
    hqp = (r * (ilqr_lib._mT(big_b) @ big_b)
           + (2.0 * cfg.ctrl_cost + r) * torch.eye(h * nu, **kw))
    return grad, hqp

  def _qp(self, grad, hqp, us):
    """Projected Newton on the box QP from dU = 0 -> dU (G, H·nu)."""
    g_n = us.shape[0]
    lo = self._lo.repeat(self.config.horizon) - us.reshape(g_n, -1)
    hi = self._hi.repeat(self.config.horizon) - us.reshape(g_n, -1)
    du = torch.zeros_like(grad)
    for _ in range(self.config.qp_iterations):
      gq = grad + (hqp @ du[..., None])[..., 0]
      at_lo = (du <= lo + 1e-12) & (gq > 0)
      at_hi = (du >= hi - 1e-12) & (gq < 0)
      fm = (~(at_lo | at_hi)).to(self.dtype)
      hf = hqp * fm[:, :, None] * fm[:, None, :] + torch.diag_embed(1.0 - fm)
      step = -ilqr_lib._cho_solve(hf, (gq * fm)[..., None])[..., 0]
      du = ilqr_lib._clip(du + step * fm, lo, hi)
    return du

  def _merit(self, template, goals, x0, us, du):
    """Plans us + alpha dU (clipped) for the L step sizes and their true
    rollout costs, L x G rows per control step: (L, G, H, nu), (L, G)."""
    alphas = self._alphas()
    n_l, g_n = alphas.shape[0], us.shape[0]
    cands = ilqr_lib._clip(
        us[None] + alphas[:, None, None, None] * du.reshape(us.shape)[None],
        self._lo, self._hi)
    tmpl, goal_rows = self._rows(
        template, goals, torch.arange(g_n, device=self.device).repeat(n_l))
    costs = self.trajectory_cost(tmpl, goal_rows, x0.repeat(n_l, 1),
                                 cands.reshape(n_l * g_n, *us.shape[1:]))
    return cands, costs.reshape(n_l, g_n)

  def solve(self, data, goals, state):
    """One MPC solve for G goals: SQP outer iterations from the shifted
    nominal.  Returns (actions (G, nu), ILQRState)."""
    x0 = self._pack(data)
    us, cost, reg = self._start(data, state)
    for _ in range(self.config.iterations):
      xs = self._rollout(data, x0, us)
      fx, fu, cx, cu = self._linearize(data, goals, xs, us)
      grad, hqp = self._condense(fx, fu, cx, cu, reg)
      du = self._qp(grad, hqp, us)
      cands, costs = self._merit(data, goals, x0, us, du)
      us, cost, reg = self._select(us, cands, costs, cost, reg)
    return self._finish(us, cost)
