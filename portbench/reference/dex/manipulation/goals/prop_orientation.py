"""Prop-orientation goal generator (port of
dexterity_tpu/manipulation/goals/prop_orientation.py).

Goal = uniformly random unit quaternion; distance = norm of the axis-angle
of the quaternion difference.  Randomness comes from an explicit
torch.Generator (JAX's threefry streams are not reproduced).
"""

from __future__ import annotations

import numpy as np
import torch

from reference.dex import goal as goal_lib
from reference.dex.physics import math as tmath
from reference.dex.utils import specs


def uniform_quaternion(gen: torch.Generator, shape=(), dtype=torch.float32,
                       device=None):
  """Uniform rotations (normalised Gaussian 4-vectors), (*shape, 4), drawn
  from `gen` on its device unless `device` is given."""
  device = gen.device if device is None else device
  q = torch.randn(tuple(shape) + (4,), generator=gen, dtype=dtype,
                  device=device)
  return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)


class PropOrientation(goal_lib.GoalGenerator):

  def __init__(self, prop, prefix: str,
               name: str = 'prop_orientation_goal_generator'):
    self._prop = prop
    self._prefix = prefix
    self._name = name
    self._body_id = None

  @property
  def public_dim(self) -> int:
    return 4

  @property
  def aux_dim(self) -> int:
    return 0

  def goal_spec(self) -> specs.Array:
    return specs.Array(shape=(4,), dtype=np.float64, name=self._name)

  def full_goal_shape(self):
    return (4,)

  def after_compile(self, model) -> None:
    if self._body_id is None:
      root = self._prefix + self._prop.spec.worldbody.children[0].name
      self._body_id = model.body_names.index(root)
      jid = model.body_jntadr[self._body_id]
      self._qadr = model.jnt_qposadr[jid]

  def current_state(self, model, data):
    """The prop's world orientation, read from its free-joint qpos (no
    kinematics refresh needed), normalised: (..., 4)."""
    self.after_compile(model)
    q = data.qpos[..., self._qadr + 3:self._qadr + 7]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)

  def next_goal(self, model, data, gen):
    """One goal per environment, drawn in float64 on `gen`'s device and
    moved to data's device and dtype: a CPU generator gives the card and
    the CPU the same goals."""
    del model
    goal = uniform_quaternion(gen, data.qpos.shape[:-1], torch.float64)
    return goal.to(data.qpos), data, torch.ones(
        data.qpos.shape[:-1], dtype=torch.bool, device=data.qpos.device)

  def relative_goal(self, goal_state, current_state):
    """Quaternion taking current to goal."""
    return tmath.quat_mul(tmath.quat_inv(current_state), goal_state)

  def goal_distance(self, goal_state, current_state):
    """Rotation angle between the two, (..., 1)."""
    err = self.relative_goal(goal_state, current_state)
    aa = tmath.quat_to_axis_angle(err)
    return torch.linalg.norm(aa, dim=-1, keepdim=True)

  @property
  def name(self) -> str:
    return self._name
