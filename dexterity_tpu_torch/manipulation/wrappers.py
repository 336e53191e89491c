"""Environment wrappers (port of dexterity_tpu/manipulation/wrappers.py;
reference: dexterity/manipulation/wrappers/).

`Wrapper`: delegation to an `environment.InteractiveEnvironment` (the
dm_env-style surface, numpy out).  `ActionNoise`: zero-mean Gaussian
noise scaled to the action range, then clipped to it; the noise comes
from numpy's `RandomState(seed)`, so one seed gives the JAX package's
noise exactly.
"""

from __future__ import annotations

import numpy as np


class Wrapper:
  """Delegating wrapper for interactive environments."""

  def __init__(self, env):
    self._env = env

  def __getattr__(self, name):
    return getattr(self._env, name)

  @property
  def environment(self):
    return self._env

  def reset(self):
    return self._env.reset()

  def step(self, action):
    return self._env.step(action)

  def action_spec(self):
    return self._env.action_spec()

  def observation_spec(self):
    return self._env.observation_spec()


class ActionNoise(Wrapper):
  """Adds zero-mean Gaussian noise scaled to the action range (unlimited
  bounds count as -1 and 1)."""

  def __init__(self, env, scale: float = 0.01, seed: int = 0):
    super().__init__(env)
    spec = env.action_spec()
    lo = np.where(np.isfinite(spec.minimum), spec.minimum, -1.0)
    hi = np.where(np.isfinite(spec.maximum), spec.maximum, 1.0)
    self._stddev = scale * (hi - lo)
    self._lo, self._hi = lo, hi
    self._rng = np.random.RandomState(seed)

  def step(self, action):
    noisy = np.asarray(action) + self._rng.normal(
        scale=self._stddev, size=self._stddev.shape)
    return self._env.step(np.clip(noisy, self._lo, self._hi))
