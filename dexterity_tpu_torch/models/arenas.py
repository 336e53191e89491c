"""Arenas (port of dexterity_tpu/models/arenas.py: Standard, attach,
add_free_entity)."""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from dexterity_tpu_torch.core import spec as S
from dexterity_tpu_torch.core.types import GeomType


class Arena:
  """Empty arena."""

  def __init__(self, name: str = 'arena'):
    self.spec = S.ModelSpec(name=name)
    self.name = name

  def attach(self, entity, prefix: Optional[str] = None,
             pos=(0, 0, 0), quat=(1, 0, 0, 0)) -> str:
    """Attaches an entity (object with .spec and .name). Returns prefix."""
    prefix = f'{entity.name}/' if prefix is None else prefix
    self.spec.attach(entity.spec, prefix=prefix, pos=pos, quat=quat)
    return prefix

  def add_free_entity(self, entity, prefix: Optional[str] = None) -> str:
    """Attaches an entity with a free joint on its root body."""
    prefix = f'{entity.name}/' if prefix is None else prefix
    child = copy.deepcopy(entity.spec)
    kids = child.worldbody.children
    if len(kids) != 1:
      raise ValueError('free entity must have a single root body')
    root = kids[0]
    if not any(j.type.name == 'FREE' for j in root.joints):
      root.joints.insert(0, S.JointSpec(name=f'{root.name}_freejoint',
                                        type=S.JointType.FREE))
    self.spec.attach(child, prefix=prefix)
    return prefix


class Standard(Arena):
  """Arena with a ground plane."""

  def __init__(self, name: str = 'arena'):
    super().__init__(name)
    self.ground = self.spec.worldbody.add_geom(
        'ground', type=GeomType.PLANE, size=np.array([1.0, 1.0, 0.1]),
        friction=(0.4, 0.005, 0.0001), solimp=(0.95, 0.99, 0.001, 0.5, 2.0),
        solref=(0.002, 1.0), rgba=(0.2, 0.3, 0.4, 1.0))
