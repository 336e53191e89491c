"""Workspace bounding boxes (port of
dexterity_tpu/manipulation/shared/workspaces.py).

Only `BoundingBox` is ported; the JAX module's `add_bbox_site` and
`add_target_site` (visual sites) have no caller in either package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BoundingBox:
  lower: Tuple[float, ...]
  upper: Tuple[float, ...]
