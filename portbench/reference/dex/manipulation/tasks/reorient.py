"""In-hand cube re-orientation (port of
dexterity_tpu/manipulation/tasks/reorient.py).

Shadow hand + OpenAI cube free prop + a contactless mocap goal-hint body,
at the task's physics / control timesteps (5 ms / 25 ms).  Goal = uniform
random quaternion; shaped reward = orientation 1/(err + 0.1) * 1.0 +
success bonus * 800 + ||ctrl||^2 * (-0.1).  Every hook takes Data with
any leading batch shape.

`initialize_episode` places the cube by rejection: the JAX package draws
a pose, runs `fwd_position` and keeps the first collision-free pose
within _MAX_PLACE_SAMPLES tries (the 20th if none is free) in a
`lax.while_loop`.  The port draws all tries of all environments up front
from the caller's generator; `place_prop` runs them in rounds over the
environments with no free try yet and picks each environment's first
free try.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from reference.dex import task as task_lib
from reference.dex.effectors import HandEffector
from reference.dex.manipulation.goals import prop_orientation
from reference.dex.manipulation.shared import (observations, rewards, tags,
                                                     workspaces)
from reference.dex.models import arenas, hands, props
from reference.dex.models.binding import HandBinding
from reference.dex.models.observables import (FreePropObservables,
                                                    HandObservables)
from reference.dex.physics import step as physics_step
from reference.dex.utils import collisions
from reference.dex.utils.registry import TaggedTasks


@dataclasses.dataclass(frozen=True)
class Workspace:
  prop_bbox: workspaces.BoundingBox


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
_MAX_PLACE_SAMPLES = 20

_BBOX_SIZE = 0.05
_WORKSPACE = Workspace(
    prop_bbox=workspaces.BoundingBox(
        lower=(-_BBOX_SIZE / 2, -0.13 - _BBOX_SIZE / 2, 0.16),
        upper=(+_BBOX_SIZE / 2, -0.13 + _BBOX_SIZE / 2, 0.16)))

_FREEPROP_OBSERVABLES = observations.ObservableNames(
    prop_pose=('position', 'orientation', 'linear_velocity',
               'angular_velocity'))

SUITE = TaggedTasks()


class ReOrient(task_lib.GoalTask):
  """Manipulate an object to a goal orientation."""

  def __init__(self, arena, hand, hand_effector, goal_generator, prop,
               hand_prefix: str, prop_prefix: str,
               workspace: Workspace = _WORKSPACE,
               fall_termination: bool = True,
               observable_options=None,
               prop_observable_options=None,
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
    self._workspace = workspace
    self._prop = prop
    self._prop_prefix = prop_prefix
    self._binding = HandBinding(hand, hand_prefix)
    self._hand_obs = HandObservables(hand, hand_prefix,
                                     options=observable_options)
    self._prop_obs = FreePropObservables(prop, prop_prefix,
                                         options=prop_observable_options)
    self._hand_prefix = hand_prefix
    self.set_timesteps(control_timestep, physics_timestep)

  @property
  def hand(self):
    return self.hands[0]

  def after_compile(self, model):
    self._binding.resolve(model)
    self._hand_obs.after_compile(model)
    self._prop_obs.after_compile(model)
    self._prop_body = self._prop_obs.body_id
    jid = model.body_jntadr[self._prop_body]
    self._prop_qadr = model.jnt_qposadr[jid]
    # Contact masks: prop-vs-ground (fall detection) and prop-vs-anything
    # (spawn rejection).
    self._fall_mask = collisions.group_mask(
        model, [self._prop_prefix], ['ground'])
    self._prop_mask = collisions.group_mask(
        model, [self._prop_prefix],
        [n for n in model.geom_names if not n.startswith(self._prop_prefix)])

  def _pair_mask(self, model, name: str) -> torch.Tensor:
    """The mask `self.<name>` as a bool tensor on the model's device,
    built once per model: reset and every step read it."""
    return model.cached(('reorient', name), lambda: torch.as_tensor(
        getattr(self, name), device=model.device))

  def placement_candidates(self, gen: torch.Generator, batch):
    """Every try of every environment: positions uniform in the spawn
    box, (*batch, _MAX_PLACE_SAMPLES, 3), and uniform orientations,
    (*batch, _MAX_PLACE_SAMPLES, 4), in float64 on `gen`'s device."""
    shape = tuple(batch) + (_MAX_PLACE_SAMPLES,)
    box = self._workspace.prop_bbox
    lo = torch.tensor(box.lower, dtype=torch.float64, device=gen.device)
    hi = torch.tensor(box.upper, dtype=torch.float64, device=gen.device)
    u = torch.rand(shape + (3,), generator=gen, dtype=torch.float64,
                   device=gen.device)
    quat = prop_orientation.uniform_quaternion(gen, shape, torch.float64)
    return lo + (hi - lo) * u, quat

  def place_prop(self, model, data, pos: torch.Tensor, quat: torch.Tensor):
    """The prop at each environment's first collision-free candidate pose,
    or its last when every one collides (PropPlacer semantics, reference:
    reorient.py:143-151,182-188).

    pos (*batch, T, 3) and quat (*batch, T, 4) hold T tries for data's
    batch shape; the tries run through `fwd_position` in rounds over the
    environments with no free try yet (hands.first_free_chunked).
    Returns (data after `fwd_position` at the chosen pose, the tries used,
    (*batch,) int64)."""
    batch = tuple(data.qpos.shape[:-1])
    tries = pos.shape[-2]
    flat = hands.flat_rows(data)
    pos = pos.to(data.qpos.device).reshape(-1, tries, 3)
    quat = quat.to(data.qpos.device).reshape(-1, tries, 4)
    qadr = self._prop_qadr
    mask = self._pair_mask(model, '_prop_mask')

    def evaluate(rows, t0, t1):
      k = t1 - t0
      cand = hands.repeat_rows(flat, rows, k)
      qpos = cand.qpos.clone()
      qpos[:, qadr:qadr + 3] = pos[rows, t0:t1].reshape(-1, 3).to(qpos)
      qpos[:, qadr + 3:qadr + 7] = quat[rows, t0:t1].reshape(-1, 4).to(qpos)
      cand = physics_step.fwd_position(model, cand.replace(qpos=qpos))
      free = ~collisions.has_collision(cand, mask)
      return free.reshape(len(rows), k), qpos.reshape(len(rows), k, -1)

    qpos, _, pick = hands.first_free_chunked(evaluate, tries, batch,
                                             data.qpos.device)
    return physics_step.fwd_position(model, data.replace(qpos=qpos)), pick + 1

  def initialize_episode(self, model, data, gen):
    """Gravity compensation for the hand; the prop placed uniformly in the
    spawn box, rejecting poses that penetrate anything (place_prop).  The
    candidates come from `gen` (see placement_candidates)."""
    data = _compensate_gravity(model, data, self._binding.body_ids)
    pos, quat = self.placement_candidates(gen, data.qpos.shape[:-1])
    return self.place_prop(model, data, pos, quat)[0]

  def on_goal_update(self, model, data, task_state):
    """Points the translucent hint body at the goal orientation
    (reference: reorient.py:187,198-199)."""
    if model.nmocap == 0:
      return data
    hint_id = model.body_mocapid[model.body_names.index('target_prop')]
    mocap_quat = data.mocap_quat.clone()
    mocap_quat[..., hint_id, :] = task_state.goal[..., :4].to(
        mocap_quat.dtype)
    return data.replace(mocap_quat=mocap_quat)

  def observables(self, model, data, task_state, eff_state):
    del eff_state
    obs = self._hand_obs.as_dict(model, data)
    obs.update(self._prop_obs.as_dict(model, data))
    obs['goal_state'] = task_state.goal[..., :4]
    return obs

  def failure_termination(self, model, data):
    if not self._fall_termination:
      return super().failure_termination(model, data)
    return collisions.has_collision(data,
                                    self._pair_mask(model, '_fall_mask'))

  # Planner rollouts need no kinematics refresh: the reward and the
  # failure proxy below read the free prop's qpos directly.
  plan_refresh = 'none'

  def rollout_failure(self, model, data):
    """Position-level fall proxy for planner rollouts: the prop's centre
    below 2x its size means it left the hand.  Reads the free joint's
    qpos (== xpos for a free body)."""
    if not self._fall_termination:
      return super().failure_termination(model, data)
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


def _compensate_gravity(model, data, body_ids):
  """Sets xfrc_applied to cancel gravity on the given bodies, for data
  with any leading batch shape (reference:
  dexterity/utils/mujoco_utils.py:91-99)."""
  ids = model.index(('compensate_gravity', tuple(int(b) for b in body_ids)),
                    body_ids)
  forces = -model.body_mass[ids][:, None] * model.opt.gravity[None, :]
  xfrc = data.xfrc_applied.clone()
  xfrc[..., ids, :3] = forces.to(xfrc.dtype)
  return data.replace(xfrc_applied=xfrc)


def reorient_task(observation_set: observations.ObservationSet) -> ReOrient:
  """Configures and instantiates a ReOrient task (reference:
  reorient.py:324-364)."""
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
  return ReOrient(
      arena=arena, hand=hand, hand_effector=hand_effector,
      goal_generator=goal_generator, prop=prop,
      hand_prefix=hand_prefix, prop_prefix=prop_prefix,
      observable_options=observations.make_options(
          observation_set.value, observations.HAND_OBSERVABLES),
      prop_observable_options=observations.make_options(
          observation_set.value, _FREEPROP_OBSERVABLES))


@SUITE.add(tags.STATE)
def state_dense() -> ReOrient:
  return reorient_task(observation_set=observations.ObservationSet.STATE_ONLY)
