"""In-hand cube re-orientation (port of
dexterity_tpu/manipulation/tasks/reorient.py).

Shadow hand + OpenAI cube free prop + a contactless mocap goal-hint body,
at the task's physics / control timesteps (5 ms / 25 ms).  Goal = uniform
random quaternion; shaped reward = orientation 1/(err + 0.1) * 1.0 +
success bonus * 800 + ||ctrl||^2 * (-0.1).  The planner hooks are ported
(`get_reward`, `rollout_failure`, `plan_refresh = 'none'`);
`initialize_episode`, `failure_termination` and the observables come with
the environment step, which has the contact data they read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dexterity_tpu_torch import task as task_lib
from dexterity_tpu_torch.effectors import HandEffector
from dexterity_tpu_torch.manipulation.goals import prop_orientation
from dexterity_tpu_torch.manipulation.shared import rewards
from dexterity_tpu_torch.models import arenas, hands, props


@dataclasses.dataclass(frozen=True)
class BoundingBox:
  lower: Tuple[float, float, float]
  upper: Tuple[float, float, float]


_HINT_POS = (0.12, 0.0, 0.15)
_PROP_SIZE = 0.02
_ORIENTATION_EPS = 0.1
_ORIENTATION_THRESHOLD = 0.1
_ORIENTATION_WEIGHT = 1.0
_SUCCESS_BONUS_WEIGHT = 800.0
_ACTION_SMOOTHING_WEIGHT = -0.1
_PHYSICS_TIMESTEP = 0.005
_CONTROL_TIMESTEP = 0.025
_SUCCESSES_NEEDED = 1
_MAX_STEPS_SINGLE_SOLVE = 300
_MAX_TIME_SINGLE_SOLVE = _MAX_STEPS_SINGLE_SOLVE * _CONTROL_TIMESTEP
_STEPS_BEFORE_MOVING_TARGET = 5

_BBOX_SIZE = 0.05
# Prop spawn workspace.
PROP_BBOX = BoundingBox(
    lower=(-_BBOX_SIZE / 2, -0.13 - _BBOX_SIZE / 2, 0.16),
    upper=(+_BBOX_SIZE / 2, -0.13 + _BBOX_SIZE / 2, 0.16))


class ReOrient(task_lib.GoalTask):
  """Manipulate an object to a goal orientation."""

  def __init__(self, arena, hand, hand_effector, goal_generator, prop,
               hand_prefix: str, prop_prefix: str,
               fall_termination: bool = True,
               success_threshold: float = _ORIENTATION_THRESHOLD,
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
    self._fall_termination = fall_termination
    self.prop = prop
    self.hand_prefix = hand_prefix
    self.prop_prefix = prop_prefix
    self.prop_bbox = PROP_BBOX
    self.set_timesteps(control_timestep, physics_timestep)

  @property
  def hand(self):
    return self.hands[0]

  def after_compile(self, model):
    root = self.prop_prefix + self.prop.spec.worldbody.children[0].name
    self._prop_body = model.body_names.index(root)
    jid = model.body_jntadr[self._prop_body]
    self._prop_qadr = model.jnt_qposadr[jid]

  # Planner rollouts need no kinematics refresh: the reward and the
  # failure proxy below read the free prop's qpos directly.
  plan_refresh = 'none'

  def rollout_failure(self, model, data):
    """Position-level fall proxy for planner rollouts: the prop's centre
    below 2x its size means it left the hand.  Reads the free joint's
    qpos (== xpos for a free body)."""
    if not self._fall_termination:
      return torch.zeros(data.qpos.shape[:-1], dtype=torch.bool,
                         device=data.qpos.device)
    return data.qpos[..., self._prop_qadr + 2] < 2.0 * _PROP_SIZE

  def get_reward(self, model, data, task_state):
    """Shaped reorientation reward, (...,) for data with leading batch
    axes and task_state.goal_distance (..., 1)."""
    distance = task_state.goal_distance[..., 0]
    shaped = {
        'orientation': rewards.Reward(
            value=1.0 / (distance + _ORIENTATION_EPS),
            weight=_ORIENTATION_WEIGHT),
        'success_bonus': rewards.Reward(
            value=rewards.tolerance(distance, 0.0, _ORIENTATION_THRESHOLD),
            weight=_SUCCESS_BONUS_WEIGHT),
        'action_smoothing': rewards.Reward(
            value=torch.sum(data.ctrl ** 2, dim=-1),
            weight=_ACTION_SMOOTHING_WEIGHT),
    }
    return rewards.weighted_average(shaped)


def reorient_task() -> ReOrient:
  """Configures and instantiates a ReOrient task."""
  arena = arenas.Standard()
  hand = hands.ShadowHandSeriesE()
  hand_prefix = arena.attach(hand, pos=hand.palm_upright_pose.xpos,
                             quat=hand.palm_upright_pose.xquat)
  hand_effector = HandEffector(hand=hand, hand_name=hand.name,
                               attach_prefix=hand_prefix)
  prop = props.OpenAICube(size=_PROP_SIZE, name='prop')
  prop_prefix = arena.add_free_entity(prop)
  # Goal-hint cube: mocap body for viewers/export (contactless).
  arena.spec.add_mocap('target_prop', pos=_HINT_POS)
  goal_generator = prop_orientation.PropOrientation(prop=prop,
                                                    prefix=prop_prefix)
  return ReOrient(arena=arena, hand=hand, hand_effector=hand_effector,
                  goal_generator=goal_generator, prop=prop,
                  hand_prefix=hand_prefix, prop_prefix=prop_prefix)


def state_dense() -> ReOrient:
  return reorient_task()
