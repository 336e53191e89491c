"""Finger-reaching tasks (port of dexterity_tpu/manipulation/tasks/reach.py).

Adroit hand; goal = 5 fingertip target positions; dense reward = mean of
per-finger -tanh²(d, margin=0.1), zeroed within 1 cm; sparse = mean of
{0, -1}.  An episode starts from a self-collision-free configuration
drawn within half of each joint's range.  Registered variants:
state_dense, state_sparse.  Every hook takes Data with any leading batch
shape.

The JAX package draws the start configuration by rejection in a
`lax.while_loop`; the port draws all tries of all environments up front
from the caller's generator (`init_draws`) and evaluates them in rounds
(`DexterousHand.sample_collision_free_joint_angles`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dexterity_tpu_torch import task as task_lib
from dexterity_tpu_torch.effectors import HandEffector
from dexterity_tpu_torch.manipulation.goals import fingertip_position
from dexterity_tpu_torch.manipulation.shared import (cameras, observations,
                                                     rewards, tags)
from dexterity_tpu_torch.models import arenas, hands
from dexterity_tpu_torch.models.binding import HandBinding
from dexterity_tpu_torch.models.observables import HandObservables
from dexterity_tpu_torch.utils.registry import TaggedTasks

_SITE_COLORS = (
    (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
    (0.0, 1.0, 1.0), (1.0, 0.0, 1.0), (1.0, 1.0, 0.0),
)
_INIT_JOINT_RANGE_FRACTION = 0.5
_STEPS_BEFORE_MOVING_TARGET = 5
_DISTANCE_TO_TARGET_THRESHOLD = 0.01  # 1 cm
_PHYSICS_TIMESTEP = 0.02
_CONTROL_TIMESTEP = 0.02              # 50 Hz
_SUCCESSES_NEEDED = 50
_MAX_STEPS_SINGLE_SOLVE = 150
_MAX_TIME_SINGLE_SOLVE = _MAX_STEPS_SINGLE_SOLVE * _CONTROL_TIMESTEP
_MAX_INIT_SAMPLES = 100

SUITE = TaggedTasks()


class Reach(task_lib.GoalTask):
  """Move the fingers to desired goal positions."""

  def __init__(self, arena, hand, hand_effector, goal_generator,
               use_dense_reward: bool,
               hand_prefix: str,
               observable_options=None,
               camera_observables=None,
               success_threshold: float = _DISTANCE_TO_TARGET_THRESHOLD,
               successes_needed: int = _SUCCESSES_NEEDED,
               steps_before_changing_goal: int = _STEPS_BEFORE_MOVING_TARGET,
               max_time_per_goal: Optional[float] = _MAX_TIME_SINGLE_SOLVE,
               control_timestep: float = _CONTROL_TIMESTEP,
               physics_timestep: float = _PHYSICS_TIMESTEP) -> None:
    super().__init__(
        arena=arena, hands=[hand], hand_effectors=[hand_effector],
        goal_generator=goal_generator,
        success_threshold=success_threshold,
        successes_needed=successes_needed,
        steps_before_changing_goal=steps_before_changing_goal,
        max_time_per_goal=max_time_per_goal)
    self._use_dense_reward = use_dense_reward
    self._binding = HandBinding(hand, hand_prefix)
    self._hand_obs = HandObservables(hand, hand_prefix,
                                     options=observable_options)
    self._hand_prefix = hand_prefix
    self._camera_obs = camera_observables

    # Fingertip target sites, for export and rendering; the goal positions
    # reach the policy through the goal_state observable.
    for i, _ in enumerate(hand.fingertip_site_names):
      arena.spec.worldbody.add_site(
          f'target_{i}', size=np.full(3, 5e-3),
          rgba=_SITE_COLORS[i] + (1.0,))

    # The ground is visual-only in reach.
    arena.ground.contype = 0
    arena.ground.conaffinity = 0

    self.set_timesteps(control_timestep, physics_timestep)

  @property
  def hand(self):
    return self.hands[0]

  @property
  def hand_effector(self):
    return self.hand_effectors[0]

  def after_compile(self, model):
    self._binding.resolve(model)
    self._hand_obs.after_compile(model)

  def init_draws(self, gen: torch.Generator, batch):
    """Every start-configuration try's unit uniforms, (*batch,
    _MAX_INIT_SAMPLES, num_joints), in float64 on `gen`'s device."""
    return torch.rand(tuple(batch) + (_MAX_INIT_SAMPLES,
                                      self.hand.num_joints),
                      generator=gen, dtype=torch.float64, device=gen.device)

  def initialize_episode(self, model, data, gen):
    """A self-collision-free start at half of each joint's range."""
    qpos, _ = self.hand.sample_collision_free_joint_angles(
        model, data, self._binding,
        self.init_draws(gen, data.qpos.shape[:-1]),
        range_fraction=_INIT_JOINT_RANGE_FRACTION)
    full = data.qpos.clone()
    full[..., model.index(('hand_qadr', self._hand_prefix),
                          self._binding.qpos_adr)] = qpos
    return data.replace(qpos=full)

  def observables(self, model, data, task_state, eff_state):
    del eff_state
    obs = self._hand_obs.as_dict(model, data)
    obs['goal_state'] = task_state.goal[..., :15]
    if self._camera_obs is not None and self._camera_obs.enabled:
      obs.update(self._camera_obs.as_dict(model, data))
    return obs

  def get_reward(self, model, data, task_state):
    """(...,) from the per-fingertip distances (..., 5)."""
    del model
    dist = task_state.goal_distance
    zero = torch.zeros_like(dist)
    if self._use_dense_reward:
      per_finger = -rewards.tanh_squared(dist[..., None], margin=0.1)
      return torch.where(dist <= _DISTANCE_TO_TARGET_THRESHOLD, zero,
                         per_finger).mean(-1)
    return torch.where(dist <= _DISTANCE_TO_TARGET_THRESHOLD, zero,
                       -torch.ones_like(dist)).mean(-1)


def reach_task(observation_set: observations.ObservationSet,
               use_dense_reward: bool,
               visualize_reward: bool = True) -> Reach:
  """Configures and instantiates a Reach task (reference:
  reach.py:223-249)."""
  del visualize_reward  # rendering-only in the reference
  arena = arenas.Standard()
  hand = hands.AdroitHand()
  prefix = arena.attach(
      hand, pos=hand.palm_upright_pose.xpos,
      quat=hand.palm_upright_pose.xquat)
  hand_effector = HandEffector(hand=hand, hand_name=hand.name,
                               attach_prefix=prefix)
  goal_generator = fingertip_position.FingertipCartesianPosition(
      hand=hand, prefix=prefix)
  # Closeup camera for vision observables (disabled in the state presets).
  camera_observables = cameras.add_camera_observables(
      arena, observation_set.value, cameras.FRONT_CLOSE)
  return Reach(
      arena=arena, hand=hand, hand_effector=hand_effector,
      goal_generator=goal_generator, use_dense_reward=use_dense_reward,
      hand_prefix=prefix,
      observable_options=observations.make_options(
          observation_set.value, observations.HAND_OBSERVABLES),
      camera_observables=camera_observables)


@SUITE.add(tags.STATE, tags.DENSE)
def state_dense() -> Reach:
  """Reach task with full state observations and dense reward."""
  return reach_task(observation_set=observations.ObservationSet.STATE_ONLY,
                    use_dense_reward=True)


@SUITE.add(tags.STATE, tags.SPARSE)
def state_sparse() -> Reach:
  """Reach task with full state observations and sparse reward."""
  return reach_task(observation_set=observations.ObservationSet.STATE_ONLY,
                    use_dense_reward=False)
