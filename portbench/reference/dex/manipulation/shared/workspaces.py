"""Workspace bounding boxes and their visual sites (port of
dexterity_tpu/manipulation/shared/workspaces.py)."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from reference.dex.core.types import GeomType
from reference.dex.manipulation.shared import constants

_MIN_SITE_DIMENSION = 1e-6


@dataclasses.dataclass(frozen=True)
class BoundingBox:
  lower: Tuple[float, ...]
  upper: Tuple[float, ...]


def add_bbox_site(body, lower: Sequence[float], upper: Sequence[float],
                  visible: bool = False, name: str = 'bbox',
                  rgba=(0, 1, 0, 0.3)):
  """Adds a box site visualizing a bounding box to a BodySpec."""
  lower_arr, upper_arr = np.asarray(lower), np.asarray(upper)
  assert np.all(lower_arr <= upper_arr)
  pos = (upper_arr + lower_arr) / 2.0
  size = np.maximum((upper_arr - lower_arr) / 2.0, _MIN_SITE_DIMENSION)
  group = 0 if visible else constants.TASK_SITE_GROUP
  return body.add_site(name, pos=pos, size=size, type=GeomType.BOX,
                       group=group, rgba=tuple(rgba))


def add_target_site(body, radius: float, visible: bool = False,
                    name: str = 'target', rgba=(1, 0, 0, 0.3)):
  """Adds a sphere site visualizing a target location."""
  assert radius > 0.0
  group = 0 if visible else constants.TASK_SITE_GROUP
  return body.add_site(name, size=np.full(3, radius), group=group,
                       rgba=tuple(rgba))
