"""Goal generation interface (port of dexterity_tpu/goal.py).

Goal sampling and distances act on (model, data, generator) and return
tensors with any leading batch shape.  `next_goal` also returns an `ok`
flag (the reference's GoalInitializationError as a value).
"""

from __future__ import annotations

import abc

from reference.dex.utils import specs


class GoalGenerator(abc.ABC):
  """Abstract goal generator."""

  def after_compile(self, model) -> None:
    """Hook called once after the task model is compiled."""

  @abc.abstractmethod
  def goal_spec(self) -> specs.Array:
    ...

  def initialize_episode(self, model, data, gen):
    """Episode-init physics edits; returns data."""
    del gen
    return data

  @abc.abstractmethod
  def next_goal(self, model, data, gen):
    """Samples a goal from the torch.Generator `gen`.  Returns (goal,
    data, ok)."""
    ...

  @abc.abstractmethod
  def current_state(self, model, data):
    ...

  def relative_goal(self, goal_state, current_state):
    return goal_state - current_state

  @abc.abstractmethod
  def goal_distance(self, goal_state, current_state):
    ...

  @property
  @abc.abstractmethod
  def name(self) -> str:
    ...
