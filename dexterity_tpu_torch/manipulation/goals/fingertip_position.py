"""Fingertip-position goals (port of
dexterity_tpu/manipulation/goals/fingertip_position.py).

`FingertipCartesianPosition` samples reachable fingertip positions: the
hand's joints ~ N(midrange, scale * range), clipped to their limits,
settled for `settle_steps` physics steps under position control, and
rejected when the hand collides with itself; an environment keeps its
first free try of `max_rejection_samples`, or its last.  The settled
joint configuration follows the 15 fingertip coordinates in the goal
vector (slots [15:15 + num_joints]) so that oracle policies can read it;
the public goal (goal_spec, the goal_state observable, the distance) is
the 15 fingertip coordinates.

The JAX package runs the tries in a `lax.while_loop` per environment.
The port draws every try's normals up front from the caller's generator
(`draws`) and settles the tries in rounds over the environments that have
no free try yet, as many at once as a fixed row budget allows
(`hands.first_free_chunked`).
"""

from __future__ import annotations

import numpy as np
import torch

from dexterity_tpu_torch import goal as goal_lib
from dexterity_tpu_torch.models import hands as hands_lib
from dexterity_tpu_torch.models.binding import HandBinding
from dexterity_tpu_torch.utils import collisions, specs


class FingertipCartesianPosition(goal_lib.GoalGenerator):

  def __init__(self, hand, prefix: str,
               max_rejection_samples: int = 100, scale: float = 0.1,
               settle_steps: int = 2,
               name: str = 'fingertip_position_goal_generator'):
    self._hand = hand
    self._binding = HandBinding(hand, prefix)
    self._prefix = prefix
    self._max_rejection_samples = max_rejection_samples
    self._scale = scale
    self._settle_steps = settle_steps
    self._name = name

  @property
  def public_dim(self) -> int:
    return 15

  @property
  def aux_dim(self) -> int:
    return self._hand.num_joints

  def goal_spec(self) -> specs.Array:
    return specs.Array(shape=(15,), dtype=np.float64, name=self._name)

  def full_goal_shape(self):
    return (self.public_dim + self.aux_dim,)

  def after_compile(self, model) -> None:
    self._binding.resolve(model)

  def _self_mask(self, model) -> torch.Tensor:
    return model.cached(('self_mask', self._prefix), lambda: torch.as_tensor(
        collisions.self_mask(model, self._prefix), device=model.device))

  def initialize_episode(self, model, data, gen):
    """Gravity compensation for the hand's bodies."""
    del gen
    self.after_compile(model)
    return compensate_gravity(model, data, self._binding.body_ids)

  def current_state(self, model, data):
    """The fingertip sites' world positions, (..., 15)."""
    self.after_compile(model)
    ids = model.index(('site_ids', self._prefix), self._binding.site_ids)
    return data.site_xpos[..., ids, :].flatten(-2)

  def draws(self, gen: torch.Generator, batch):
    """Every try's standard normals, (*batch, max_rejection_samples,
    num_joints), in float64 on `gen`'s device."""
    return torch.randn(tuple(batch) + (self._max_rejection_samples,
                                       self._hand.num_joints),
                       generator=gen, dtype=torch.float64, device=gen.device)

  def next_goal(self, model, data, gen):
    """One goal per environment from `gen` (see goal_from_draws)."""
    return self.goal_from_draws(model, data,
                                self.draws(gen, data.qpos.shape[:-1]))

  def goal_from_draws(self, model, data, normals: torch.Tensor):
    """The goal of each environment given its tries' normals (*batch, T,
    num_joints).  Returns (goal (*batch, 15 + num_joints), data unchanged,
    ok (*batch,): False when every try collided)."""
    self.after_compile(model)
    b = self._binding
    batch = tuple(data.qpos.shape[:-1])
    dtype, device = data.qpos.dtype, data.qpos.device
    rng_np = b.jnt_range
    lo = torch.as_tensor(rng_np[:, 0], dtype=dtype, device=device)
    hi = torch.as_tensor(rng_np[:, 1], dtype=dtype, device=device)
    mid = (lo + hi) / 2.0
    rng = hi - lo
    p2c = torch.as_tensor(self._hand.position_to_control, dtype=dtype,
                          device=device)
    qadr = model.index(('hand_qadr', self._prefix), b.qpos_adr)
    act = model.index(('hand_act', self._prefix), b.act_ids)
    sites = model.index(('site_ids', self._prefix), b.site_ids)
    self_mask = self._self_mask(model)
    nj = self._hand.num_joints
    tries = normals.shape[-2]
    normals = normals.to(device=device, dtype=dtype).reshape(-1, tries, nj)
    flat = hands_lib.flat_rows(data)
    from dexterity_tpu_torch.physics import step as physics_step

    def evaluate(rows, t0, t1):
      k = t1 - t0
      cand = hands_lib.repeat_rows(flat, rows, k)
      q = mid + self._scale * rng * normals[rows, t0:t1]
      q = torch.minimum(torch.maximum(q, lo), hi).reshape(-1, nj)
      qpos = cand.qpos.clone()
      qpos[:, qadr] = q
      ctrl = cand.ctrl.clone()
      ctrl[:, act] = q @ p2c.T
      d = physics_step.step_n(model, cand.replace(
          qpos=qpos, qvel=torch.zeros_like(cand.qvel), ctrl=ctrl),
          self._settle_steps)
      free = ~collisions.has_collision(d, self_mask)
      goal = torch.cat([d.site_xpos[:, sites].flatten(-2),
                        d.qpos[:, qadr]], -1)
      return free.reshape(len(rows), k), goal.reshape(len(rows), k, -1)

    goal, ok, _ = hands_lib.first_free_chunked(evaluate, tries, batch, device)
    return goal, data, ok

  def relative_goal(self, goal_state, current_state):
    return goal_state[..., :15] - current_state

  def goal_distance(self, goal_state, current_state):
    """Per-fingertip distance, (..., 5)."""
    rel = self.relative_goal(goal_state, current_state)
    return torch.linalg.norm(rel.unflatten(-1, (-1, 3)), dim=-1)

  @property
  def name(self) -> str:
    return self._name


def compensate_gravity(model, data, body_ids: np.ndarray):
  """Sets xfrc_applied to cancel gravity on the given bodies, for data
  with any leading batch shape (reference:
  dexterity/utils/mujoco_utils.py:91-99)."""
  ids = model.index(('compensate_gravity', tuple(int(b) for b in body_ids)),
                    body_ids)
  forces = -model.body_mass[ids][:, None] * model.opt.gravity[None, :]
  xfrc = data.xfrc_applied.clone()
  xfrc[..., ids, :3] = forces.to(xfrc.dtype)
  return data.replace(xfrc_applied=xfrc)
