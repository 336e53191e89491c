"""Camera configurations (port of
dexterity_tpu/manipulation/shared/cameras.py; reference:
manipulation/shared/cameras.py).

Offscreen rendering is host-side (dexterity_tpu_torch.rendering); the
state presets keep the camera disabled, so their observables hold no
camera entry.
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


def add_camera_observables(arena, obs_settings, *camera_configs):
  """Realizes obs_settings.camera for the given cameras
  (reference: manipulation/shared/cameras.py:53-64).

  Returns a CameraObservables whose as_dict(model, data) yields one
  (..., height, width, 3) uint8 observation per camera, rendered on the
  host (dexterity_tpu_torch.rendering's docstring describes the
  boundary).  Without mujoco, an enabled camera raises ImportError at its
  first observation.
  """
  from dexterity_tpu_torch import rendering
  return rendering.CameraObservables(arena.spec, camera_configs,
                                     obs_settings.camera)
