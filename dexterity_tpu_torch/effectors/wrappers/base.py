"""Delegating effector wrapper (port of
dexterity_tpu/effectors/wrappers/base.py; reference:
dexterity/effectors/wrappers/base.py)."""

from __future__ import annotations

from dexterity_tpu_torch import effector


class Wrapper(effector.Effector):
  """Base class for effectors that wrap other effectors."""

  def __init__(self, wrapped: effector.Effector):
    self._wrapped = wrapped

  def __getattr__(self, name):
    return getattr(self._wrapped, name)

  @property
  def wrapped(self) -> effector.Effector:
    return self._wrapped

  def after_compile(self, model) -> None:
    self._wrapped.after_compile(model)

  def initial_state(self, model, batch=()):
    return self._wrapped.initial_state(model, batch)

  def action_spec(self, model):
    return self._wrapped.action_spec(model)

  def set_control(self, model, data, state, command):
    return self._wrapped.set_control(model, data, state, command)

  @property
  def prefix(self) -> str:
    return self._wrapped.prefix
