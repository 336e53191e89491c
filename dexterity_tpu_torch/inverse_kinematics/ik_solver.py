"""Batched multi-fingertip inverse kinematics (port of
dexterity_tpu/inverse_kinematics/ik_solver.py; reference:
dexterity/inverse_kinematics/ik_solver.py).

The reference's damped-least-squares IK: each step's fingertip twist is
gain · position error, the DLS mapper turns it into joint velocities, the
joints integrate and clip to their limits, and an attempt stops when it
converges, stalls (an error over 20× its last change) or reaches
`max_steps`.  Every attempt of every target set is a row of one batch:
`_attempt` runs the rows as JAX's `while_loop` under `vmap` does, body
for all rows while any row passes the loop test, a row that fails it
keeping its carry, each with its own step count; the loop leaves as soon
as no row is active (one host read per iteration).

Initial configurations come from a CPU `torch.Generator` in float64
(`_initial_configurations`), so the card and the CPU start alike; JAX's
threefry draws are not reproduced.

Tunables match the JAX package: gain 0.95, dt 1.0, regularization 1e-5,
progress threshold 20.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dexterity_tpu_torch.controllers import dls
from dexterity_tpu_torch.core import types as T
from dexterity_tpu_torch.core.types import ObjType
from dexterity_tpu_torch.physics import kinematics
from dexterity_tpu_torch.utils import structs

_LINEAR_VELOCITY_GAIN = 0.95
_INTEGRATION_TIMESTEP_SEC = 1.0
_REGULARIZATION_WEIGHT = 1e-5
_PROGRESS_THRESHOLD = 20.0


class IKSolver:
  """Inverse kinematics solver for a dexterous hand."""

  def __init__(self, hand, device=None, dtype=torch.float32):
    """Compiles `hand.spec` on `device` (cuda unless given) in `dtype`."""
    self.hand = hand
    self.model = hand.spec.compile(device=device, dtype=dtype)
    self._site_ids = np.asarray(
        [self.model.site_names.index(n) for n in hand.fingertip_site_names],
        np.int64)
    jids = [self.model.jnt_names.index(n) for n in hand.joint_names]
    self._qpos_adr = np.asarray(
        [self.model.jnt_qposadr[j] for j in jids], np.int64)
    rng = self.model.jnt_range.detach().cpu().double().numpy()[jids]
    self._lo, self._hi = rng[:, 0], rng[:, 1]
    self._nullspace_reference = rng.mean(axis=1)
    self._mapper = dls.DampedLeastSquaresMapper(
        dls.DampedLeastSquaresParameters(
            model=self.model,
            object_types=[ObjType.SITE] * len(self._site_ids),
            object_names=[self.model.site_names[s] for s in self._site_ids],
            regularization_weight=_REGULARIZATION_WEIGHT))

  def _tensor(self, x):
    return torch.as_tensor(x, dtype=self.model.dtype,
                           device=self.model.device)

  # -- attempts over rows ---------------------------------------------------

  def _fk(self, qpos, base=None):
    """fwd_position at the hand's joint positions qpos (..., nj); `base`
    is a Data of qpos's batch shape to start from (a new one if None)."""
    model = self.model
    if base is None:
      base = T.make_data(model, qpos.shape[:-1])
    full = base.qpos.clone()
    full[..., model.index('ik_qpos_adr', self._qpos_adr)] = qpos.to(
        full.dtype)
    return kinematics.fwd_position(model, base.replace(qpos=full))

  def _tips(self, data):
    return data.site_xpos[..., self.model.index('ik_sites', self._site_ids),
                          :]

  def _qdot(self, data, targets):
    """Joint velocities (..., nv) of one step from the FK `data` toward
    `targets` (..., k, 3)."""
    twists = _LINEAR_VELOCITY_GAIN * (
        targets - self._tips(data)) / _INTEGRATION_TIMESTEP_SEC
    return self._mapper.compute_joint_velocities(data, twists)

  def _attempt(self, qpos0, targets, linear_tol, max_steps):
    """Runs one IK descent per row.

    Args:
      qpos0: (R, nj) initial joint positions.
      targets: (R, 3k) or (R, k, 3) fingertip targets.

    Returns (qpos (R, nj), linear error (R, k), steps taken (R,)).
    """
    lo, hi = self._tensor(self._lo), self._tensor(self._hi)
    adr = self.model.index('ik_qpos_adr', self._qpos_adr)
    qpos = qpos0.to(self.model.dtype)
    rows = qpos.shape[0]
    targets = targets.to(qpos.dtype).reshape(rows, -1, 3)
    base = T.make_data(self.model, (rows,))
    data = self._fk(qpos, base)
    tips = self._tips(data)
    err = torch.linalg.vector_norm(targets - tips, dim=-1)
    stalled = torch.zeros(rows, dtype=torch.bool, device=qpos.device)
    step = torch.zeros(rows, dtype=torch.int64, device=qpos.device)
    # JAX's loop test is ~stalled & step < max_steps & any(err > tol); a
    # row's step never exceeds the iterations run, so the range bounds it.
    for _ in range(max_steps):
      active = ~stalled & (err > linear_tol).any(dim=-1)
      if not bool(active.any()):
        break
      qdot = self._qdot(data, targets)
      qpos_new = torch.clamp(
          qpos + qdot[:, adr] * _INTEGRATION_TIMESTEP_SEC, lo, hi)
      # The body's FK at qpos_new is carried into the next iteration
      # (JAX recomputes it there: the same function of the same input).
      data_new = self._fk(qpos_new, base)
      tips_new = self._tips(data_new)
      err_new = torch.linalg.vector_norm(targets - tips_new, dim=-1)
      change = torch.linalg.vector_norm(tips_new - tips, dim=-1)
      stalled_new = (err_new / (change + 1e-10)
                     > _PROGRESS_THRESHOLD).any(dim=-1)
      qpos = torch.where(active[:, None], qpos_new, qpos)
      tips = torch.where(active[:, None, None], tips_new, tips)
      err = torch.where(active[:, None], err_new, err)
      stalled = torch.where(active, stalled_new, stalled)
      step = step + active.to(step.dtype)
      data = structs.where_rows(active, data_new, data)
    return qpos, err, step

  # -- public API -----------------------------------------------------------

  def _initial_configurations(self, num_sets: int, num_attempts: int,
                              gen: torch.Generator) -> torch.Tensor:
    """(num_sets, num_attempts, nj) starts on the CPU in float64: uniform
    in the joint ranges, attempt 0 of each set at the range midpoint."""
    lo = torch.as_tensor(self._lo)
    hi = torch.as_tensor(self._hi)
    u = torch.rand((num_sets, num_attempts, lo.shape[0]), generator=gen,
                   dtype=torch.float64)
    inits = lo + (hi - lo) * u
    inits[:, 0] = torch.as_tensor(self._nullspace_reference)
    return inits

  def _best(self, inits, targets, linear_tol, max_steps):
    """Runs every (set, attempt) row from `inits` (N, A, nj) toward
    `targets` (N, 3k) and picks each set's solution: among the attempts
    within `linear_tol` the one nearest the range midpoint, else the one
    of least max error (first index on ties).  Returns (qpos (N, nj),
    success (N,))."""
    n, a, nj = inits.shape
    targets = self._tensor(targets).reshape(n, 1, -1).expand(n, a, -1)
    qpos, err, _ = self._attempt(self._tensor(inits).reshape(n * a, nj),
                                 targets.reshape(n * a, -1), linear_tol,
                                 max_steps)
    qpos, err = qpos.reshape(n, a, nj), err.reshape(n, a, -1)
    ok = (err <= linear_tol).all(dim=-1)
    null_dist = torch.linalg.vector_norm(
        qpos - self._tensor(self._nullspace_reference), dim=-1)
    score = torch.where(ok, null_dist, torch.inf)
    any_ok = ok.any(dim=-1)
    best = torch.where(any_ok, torch.argmin(score, dim=-1),
                       torch.argmin(err.amax(dim=-1), dim=-1))
    return qpos[torch.arange(n, device=qpos.device), best], any_ok

  def solve_batch(self, target_batch, gen: Optional[torch.Generator] = None,
                  linear_tol: float = 1e-3, max_steps: int = 100,
                  early_stop: bool = False, num_attempts: int = 30,
                  stop_on_first_successful_attempt: bool = False):
    """Solves N sets of fingertip targets (N, k, 3) or (N, 3k), all N ×
    num_attempts attempts in one batch.  Returns (qpos (N, nj), success
    (N,)).  `early_stop` and `stop_on_first_successful_attempt` are
    accepted and ignored: every attempt runs."""
    del early_stop, stop_on_first_successful_attempt
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    n = len(target_batch)
    inits = self._initial_configurations(n, num_attempts, gen)
    return self._best(inits, torch.as_tensor(target_batch).reshape(n, -1),
                      linear_tol, max_steps)

  def solve(self, target_positions, linear_tol: float = 1e-3,
            max_steps: int = 100, early_stop: bool = False,
            num_attempts: int = 30,
            stop_on_first_successful_attempt: bool = False,
            gen: Optional[torch.Generator] = None):
    """Solves one set of fingertip targets (k, 3) or (3k,).  Returns
    (qpos (nj,), success ()): the successful attempt nearest the range
    midpoint, or the attempt of least max error with success False."""
    qpos, ok = self.solve_batch(
        torch.as_tensor(target_positions).reshape(1, -1), gen=gen,
        linear_tol=linear_tol, max_steps=max_steps, early_stop=early_stop,
        num_attempts=num_attempts,
        stop_on_first_successful_attempt=stop_on_first_successful_attempt)
    return qpos[0], ok[0]
