"""Effector wrapper storing the last command (port of
dexterity_tpu/effectors/wrappers/previous_action.py; reference:
dexterity/effectors/wrappers/previous_action.py).

The command lives in the effector state (key 'previous_action'), one row
per episode, for observables and penalties to read.
"""

from __future__ import annotations

import torch

from dexterity_tpu_torch.effectors.wrappers import base


class PreviousAction(base.Wrapper):

  def initial_state(self, model, batch=()):
    state = dict(self._wrapped.initial_state(model, batch))
    n = self.action_spec(model).shape[0]
    state['previous_action'] = torch.zeros(
        tuple(batch) + (n,), dtype=model.dtype, device=model.device)
    return state

  def set_control(self, model, data, state, command):
    data, state = self._wrapped.set_control(model, data, state, command)
    state = dict(state)
    state['previous_action'] = command
    return data, state

  @staticmethod
  def previous_action(state):
    return state['previous_action']
