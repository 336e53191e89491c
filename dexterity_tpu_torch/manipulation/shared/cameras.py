"""Camera configurations (port of
dexterity_tpu/manipulation/shared/cameras.py).

The configurations are ported; rendering is not yet (it comes with
`rendering.py`).  `add_camera_observables` returns a CameraObservables
whose `enabled` follows the camera spec; an enabled spec raises
NotImplementedError when it is built, so no environment silently drops
pixels.  The state presets keep the camera disabled, so a task's
observables hold no camera entry.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
  name: str
  pos: Tuple[float, float, float]
  xyaxes: Tuple[float, float, float, float, float, float]


FRONT_CLOSE = CameraConfig(
    name='front_close', pos=(0.0, -0.5, 0.5),
    xyaxes=(1.0, 0.0, 0.0, 0.0, 0.7, 0.75))
LEFT_CLOSE = CameraConfig(
    name='left_close', pos=(-0.6, 0.0, 0.5),
    xyaxes=(0.0, -1.0, 0.0, 0.7, 0.0, 0.75))
RIGHT_CLOSE = CameraConfig(
    name='right_close', pos=(0.6, 0.0, 0.5),
    xyaxes=(0.0, 1.0, 0.0, -0.7, 0.0, 0.75))
FRONT_FAR = CameraConfig(
    name='front_far', pos=(0.0, -1.0, 0.7),
    xyaxes=(1.0, 0.0, 0.0, 0.0, 0.7, 0.75))
TOP_DOWN = CameraConfig(
    name='top_down', pos=(0.0, 0.0, 2.5),
    xyaxes=(1.0, 0.0, 0.0, 0.0, 1.0, 0.0))


class CameraObservables:
  """A task's camera observables; only disabled ones can be built."""

  def __init__(self, camera_configs, camera_spec):
    self.configs = tuple(camera_configs)
    self.spec = camera_spec
    if self.enabled:
      raise NotImplementedError(
          'camera observables need rendering, which the PyTorch port does '
          'not have yet; use a state-only observation set')

  @property
  def enabled(self) -> bool:
    return bool(getattr(self.spec, 'enabled', False))


def add_camera_observables(arena, obs_settings, *camera_configs):
  """Realizes obs_settings.camera for the given cameras (reference:
  manipulation/shared/cameras.py:53-64)."""
  del arena
  return CameraObservables(camera_configs, obs_settings.camera)
