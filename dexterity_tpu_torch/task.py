"""Task composition and timesteps (port of the composition part of
dexterity_tpu/task.py).

A Task composes an arena, hands and effectors into one ModelSpec and
compiles it once per (device, dtype).  Episode hooks, rewards and goals are
not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dexterity_tpu_torch.core import types


class Task:
  """Base class for dexterous manipulation tasks."""

  def __init__(self, arena, hands: Sequence) -> None:
    if len(set(hand.name for hand in hands)) != len(hands):
      raise ValueError('Each hand must have a unique name.')
    self._arena = arena
    self._hands = tuple(hands)
    self._control_timestep = 0.02
    self._physics_timestep = 0.02
    self._models = {}

  def set_timesteps(self, control_timestep: float, physics_timestep: float):
    self._control_timestep = control_timestep
    self._physics_timestep = physics_timestep
    self._arena.spec.option.timestep = physics_timestep

  @property
  def control_timestep(self) -> float:
    return self._control_timestep

  @property
  def physics_timestep(self) -> float:
    return self._physics_timestep

  @property
  def n_substeps(self) -> int:
    return max(1, round(self._control_timestep / self._physics_timestep))

  def compile(self, device=None, dtype=torch.float32) -> types.Model:
    """Compiles the composed spec on `device` (cuda unless given) in
    `dtype`.  Idempotent per (device, dtype)."""
    device = types.resolve_device(device)
    key = (str(device), dtype)
    if key not in self._models:
      self._models[key] = self._arena.spec.compile(device=device, dtype=dtype)
    return self._models[key]

  @property
  def arena(self):
    return self._arena

  @property
  def hands(self):
    return self._hands
