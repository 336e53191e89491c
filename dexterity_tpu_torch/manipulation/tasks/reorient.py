"""In-hand cube re-orientation: scene composition
(port of dexterity_tpu/manipulation/tasks/reorient.py, `reorient_task`).

Shadow hand + OpenAI cube free prop + a contactless mocap goal-hint body,
at the task's physics / control timesteps.  The goal, reward and failure
hooks are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from dexterity_tpu_torch import task as task_lib
from dexterity_tpu_torch.models import arenas, hands, props


@dataclasses.dataclass(frozen=True)
class BoundingBox:
  lower: Tuple[float, float, float]
  upper: Tuple[float, float, float]


_HINT_POS = (0.12, 0.0, 0.15)
_PROP_SIZE = 0.02
_PHYSICS_TIMESTEP = 0.005
_CONTROL_TIMESTEP = 0.025

_BBOX_SIZE = 0.05
# Prop spawn workspace.
PROP_BBOX = BoundingBox(
    lower=(-_BBOX_SIZE / 2, -0.13 - _BBOX_SIZE / 2, 0.16),
    upper=(+_BBOX_SIZE / 2, -0.13 + _BBOX_SIZE / 2, 0.16))


class ReOrient(task_lib.Task):
  """Manipulate an object to a goal orientation (scene part)."""

  def __init__(self, arena, hand, prop, hand_prefix: str, prop_prefix: str,
               control_timestep: float = _CONTROL_TIMESTEP,
               physics_timestep: float = _PHYSICS_TIMESTEP) -> None:
    super().__init__(arena=arena, hands=[hand])
    self.prop = prop
    self.hand_prefix = hand_prefix
    self.prop_prefix = prop_prefix
    self.prop_bbox = PROP_BBOX
    self.set_timesteps(control_timestep, physics_timestep)

  @property
  def hand(self):
    return self.hands[0]


def reorient_task() -> ReOrient:
  """Composes the ReOrient scene."""
  arena = arenas.Standard()
  hand = hands.ShadowHandSeriesE()
  hand_prefix = arena.attach(hand, pos=hand.palm_upright_pose.xpos,
                             quat=hand.palm_upright_pose.xquat)
  prop = props.OpenAICube(size=_PROP_SIZE, name='prop')
  prop_prefix = arena.add_free_entity(prop)
  # Goal-hint cube: mocap body for viewers/export (contactless).
  arena.spec.add_mocap('target_prop', pos=_HINT_POS)
  return ReOrient(arena=arena, hand=hand, prop=prop,
                  hand_prefix=hand_prefix, prop_prefix=prop_prefix)


def state_dense() -> ReOrient:
  return reorient_task()
