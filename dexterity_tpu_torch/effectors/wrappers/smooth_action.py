"""EMA-smoothing effector wrapper (port of
dexterity_tpu/effectors/wrappers/smooth_action.py; reference:
dexterity/effectors/wrappers/smooth_action.py).

smoothed = alpha · command + (1 − alpha) · previous, restarted per
episode: each episode's row carries its own previous command and
first-step flag, so a reset row starts afresh and the others keep theirs.
alpha = 1 passes commands through unchanged.
"""

from __future__ import annotations

import torch

from dexterity_tpu_torch.effectors.wrappers import base


class SmoothAction(base.Wrapper):

  def __init__(self, wrapped, alpha: float):
    if not 0.0 < alpha <= 1.0:
      raise ValueError('`alpha` must be in (0, 1].')
    super().__init__(wrapped)
    self._alpha = alpha

  def initial_state(self, model, batch=()):
    state = dict(self._wrapped.initial_state(model, batch))
    n = self.action_spec(model).shape[0]
    batch = tuple(batch)
    state['smooth_prev'] = torch.zeros(batch + (n,), dtype=model.dtype,
                                       device=model.device)
    state['smooth_first'] = torch.ones(batch, dtype=torch.bool,
                                       device=model.device)
    return state

  def set_control(self, model, data, state, command):
    prev, first = state['smooth_prev'], state['smooth_first']
    command = torch.as_tensor(command, dtype=prev.dtype, device=prev.device)
    smoothed = torch.where(first[..., None], command,
                           self._alpha * command + (1 - self._alpha) * prev)
    data, state = self._wrapped.set_control(model, data, state, smoothed)
    state = dict(state)
    state['smooth_prev'] = smoothed
    state['smooth_first'] = torch.zeros_like(first)
    return data, state
