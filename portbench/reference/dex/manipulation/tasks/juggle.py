"""Two-hand juggling (port of dexterity_tpu/manipulation/tasks/juggle.py).

Two MPL hands welded to mocap bodies and a juggling ball, a free prop
placed on the left palm after the hands settle; the reward is 0 (the
reference domain is unfinished).  Juggle is a plain Task: it runs under
the null goal.  Variant: state_sparse.  Every hook takes Data with any
leading batch shape.
"""

from __future__ import annotations

import torch

from reference.dex import task as task_lib
from reference.dex.effectors import HandEffector
from reference.dex.manipulation.shared import observations, tags
from reference.dex.models import arenas, hands, props
from reference.dex.models.binding import HandBinding
from reference.dex.models.observables import (FreePropObservables,
                                                    HandObservables)
from reference.dex.physics import step as physics_step
from reference.dex.utils.registry import TaggedTasks

_HAND_QUAT = (0.0, 0.0, 0.7, 0.0)
_RIGHT_HAND_POS = (-0.1, 0.0, 0.1)
_LEFT_HAND_POS = (0.1, 0.0, 0.1)
_BALL_RADIUS = 0.025
_BALL_OFFSET = (0.0, -0.05, 0.05)    # from the left palm
_PHYSICS_TIMESTEP = 0.02
_CONTROL_TIMESTEP = 0.02
_SETTLE_STEPS = 2

SUITE = TaggedTasks()


class Juggle(task_lib.Task):
  """Juggle a ball with two hands."""

  def __init__(self, arena, hands_, hand_effectors, use_dense_reward: bool,
               prefixes, ball, ball_prefix,
               observable_options=None,
               control_timestep: float = _CONTROL_TIMESTEP,
               physics_timestep: float = _PHYSICS_TIMESTEP) -> None:
    super().__init__(arena=arena, hands=hands_,
                     hand_effectors=hand_effectors)
    self._use_dense_reward = use_dense_reward
    self._bindings = [HandBinding(h, p) for h, p in zip(hands_, prefixes)]
    self._hand_obs = [HandObservables(h, p, options=observable_options)
                      for h, p in zip(hands_, prefixes)]
    self._ball = ball
    self._ball_obs = FreePropObservables(
        ball, ball_prefix,
        options={'position': {'enabled': True},
                 'orientation': {'enabled': True},
                 'linear_velocity': {'enabled': True},
                 'angular_velocity': {'enabled': True}})
    self.set_timesteps(control_timestep, physics_timestep)

  @property
  def left_hand(self):
    return self.hands[0]

  @property
  def right_hand(self):
    return self.hands[1]

  def after_compile(self, model):
    for b in self._bindings:
      b.resolve(model)
    for o in self._hand_obs:
      o.after_compile(model)
    self._ball_obs.after_compile(model)
    # The left palm body, for the ball's placement.
    self._left_palm = model.body_names.index(
        self._bindings[0].prefix + 'palm')
    jid = model.body_jntadr[self._ball_obs.body_id]
    self._ball_qadr = model.jnt_qposadr[jid]

  def initialize_episode(self, model, data, gen):
    """Both hands at midrange, two settle steps, the ball above the left
    palm."""
    del gen
    qpos = data.qpos.clone()
    for b in self._bindings:
      mid = torch.as_tensor(b.jnt_range.mean(axis=1), dtype=qpos.dtype,
                            device=qpos.device)
      qpos[..., model.index(('hand_qadr', b.prefix), b.qpos_adr)] = mid
    data = physics_step.step_n(model, data.replace(qpos=qpos),
                               _SETTLE_STEPS)
    ball_pos = data.xpos[..., self._left_palm, :] + torch.as_tensor(
        _BALL_OFFSET, dtype=data.qpos.dtype, device=data.qpos.device)
    qadr = self._ball_qadr
    qpos = data.qpos.clone()
    qpos[..., qadr:qadr + 3] = ball_pos
    return physics_step.fwd_position(model, data.replace(qpos=qpos))

  def observables(self, model, data, task_state, eff_state):
    del task_state, eff_state
    obs = {}
    for o in self._hand_obs:
      obs.update(o.as_dict(model, data))
    obs.update(self._ball_obs.as_dict(model, data))
    return obs

  def get_reward(self, model, data, task_state):
    del model, task_state
    return data.qpos.new_zeros(data.qpos.shape[:-1])


def juggle_task(observation_set: observations.ObservationSet,
                use_dense_reward: bool) -> Juggle:
  """Configures and instantiates a Juggle task (reference:
  juggle.py:147-181)."""
  arena = arenas.Standard()
  left = hands.MPLHand(side=hands.HandSide.LEFT, name='mpl_left')
  right = hands.MPLHand(side=hands.HandSide.RIGHT, name='mpl_right')
  arena.add_mocap(left, position=_LEFT_HAND_POS, quaternion=_HAND_QUAT,
                  name='left_mocap')
  arena.add_mocap(right, position=_RIGHT_HAND_POS, quaternion=_HAND_QUAT,
                  name='right_mocap')
  prefixes = (f'{left.name}/', f'{right.name}/')
  left_eff = HandEffector(hand=left, hand_name=left.name,
                          attach_prefix=prefixes[0])
  right_eff = HandEffector(hand=right, hand_name=right.name,
                           attach_prefix=prefixes[1])
  ball = props.JugglingBall(radius=_BALL_RADIUS)
  ball_prefix = arena.add_free_entity(ball)
  return Juggle(
      arena=arena, hands_=[left, right],
      hand_effectors=[left_eff, right_eff],
      use_dense_reward=use_dense_reward,
      prefixes=prefixes, ball=ball, ball_prefix=ball_prefix,
      observable_options=observations.make_options(
          observation_set.value, observations.HAND_OBSERVABLES))


@SUITE.add(tags.STATE, tags.SPARSE)
def state_sparse() -> Juggle:
  """Juggle task with full state observations and sparse reward."""
  return juggle_task(observation_set=observations.ObservationSet.STATE_ONLY,
                     use_dense_reward=False)
