"""Effector interface (port of dexterity_tpu/effector.py).

An effector turns an action sub-vector into actuator controls:
`set_control` maps (model, data, state, command) -> (data, state), where
`state` is the effector's own dictionary (filters, previous actions, ...)
with a row per episode: every leaf carries the episodes' batch shape.
Action slices into the task's merged action vector are fixed when the
model is compiled.
"""

from __future__ import annotations

import abc
from typing import Any, Dict

from reference.dex.utils import specs


class Effector(abc.ABC):
  """Abstract effector."""

  def after_compile(self, model) -> None:
    """Hook called once after the task model is compiled."""

  def initial_state(self, model, batch=()) -> Dict[str, Any]:
    """Returns the initial per-episode state of the episodes of batch
    shape `batch` (none: one episode): leaves of shape batch + (n,)."""
    del model, batch
    return {}

  @abc.abstractmethod
  def action_spec(self, model) -> specs.BoundedArray:
    ...

  @abc.abstractmethod
  def set_control(self, model, data, state, command):
    """Applies `command`; returns (data, new_state)."""
    ...

  @property
  @abc.abstractmethod
  def prefix(self) -> str:
    ...
