"""Arenas (port of dexterity_tpu/models/arenas.py: Standard, attach and
its alias attach_offset, add_free_entity, add_mocap)."""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from reference.dex.core import spec as S
from reference.dex.core.types import GeomType


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

  # The reference's name for it (dexterity/models/arenas/arena.py:47-63).
  attach_offset = attach

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

  def add_mocap(self, entity, position=(0, 0, 0), quaternion=(1, 0, 0, 0),
                name: str = 'mocap') -> str:
    """Attaches `entity` as a free body welded to a new mocap body (the
    juggle task drives its hands through mocap targets).  Returns the
    mocap body's name."""
    prefix = self.add_free_entity(entity)
    root_name = prefix + entity.spec.worldbody.children[0].name
    root = self.spec.find_body(root_name)
    root.pos = np.asarray(position, np.float64)
    root.quat = np.asarray(quaternion, np.float64)
    self.spec.add_mocap(name, pos=position, quat=quaternion,
                        weld_body=root_name)
    return name


class Standard(Arena):
  """Arena with a ground plane."""

  def __init__(self, name: str = 'arena'):
    super().__init__(name)
    self.ground = self.spec.worldbody.add_geom(
        'ground', type=GeomType.PLANE, size=np.array([1.0, 1.0, 0.1]),
        friction=(0.4, 0.005, 0.0001), solimp=(0.95, 0.99, 0.001, 0.5, 2.0),
        solref=(0.002, 1.0), rgba=(0.2, 0.3, 0.4, 1.0))
