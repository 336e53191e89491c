"""Generic actuator-group effector (port of
dexterity_tpu/effectors/mujoco_actuation.py).

`ActuatorEffector` drives a named subset of the compiled model's
actuators.  Its action spec comes from actuator_ctrlrange; names are
'{prefix}{i}' joined by tabs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from reference.dex import effector
from reference.dex.utils import specs


class ActuatorEffector(effector.Effector):
  """Effector for a set of actuators of the compiled model."""

  def __init__(self, actuator_names: Sequence[str], prefix: str):
    self._actuator_names = tuple(actuator_names)
    self._prefix = prefix
    self._indices: Optional[np.ndarray] = None

  def after_compile(self, model) -> None:
    self._indices = np.asarray(
        [model.actuator_names.index(n) for n in self._actuator_names],
        np.int32)

  def indices(self, model=None) -> np.ndarray:
    """Compiled actuator indices (resolved here when a model is given)."""
    if self._indices is None and model is not None:
      self.after_compile(model)
    if self._indices is None:
      raise RuntimeError('after_compile() was not called')
    return self._indices

  def action_spec(self, model) -> specs.BoundedArray:
    idx = self.indices(model)
    rng = model.actuator_ctrlrange.detach().cpu().double().numpy()[idx]
    names = '\t'.join(f'{self._prefix}{i}' for i in range(len(idx)))
    # Unlimited ctrl stays +/-inf (MuJoCo ctrllimited semantics).
    return specs.BoundedArray(
        shape=(len(idx),), dtype=np.float64, name=names,
        minimum=rng[:, 0], maximum=rng[:, 1])

  def set_control(self, model, data, state, command):
    """Writes `command` (..., n) into the effector's ctrl columns."""
    idx = torch.as_tensor(self.indices(model), dtype=torch.int64,
                          device=data.ctrl.device)
    ctrl = data.ctrl.clone()
    ctrl[..., idx] = command.to(ctrl.dtype)
    return data.replace(ctrl=ctrl), state

  @property
  def prefix(self) -> str:
    return self._prefix


# Backwards-compatible alias matching the reference class name.
MujocoEffector = ActuatorEffector
