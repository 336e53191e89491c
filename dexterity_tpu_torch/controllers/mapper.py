"""Cartesian-velocity to joint-velocity mapper interface (port of
dexterity_tpu/controllers/mapper.py; reference:
dexterity/controllers/mapper.py).

`Parameters` validates object types and names against the port's
compiled `Model` as the JAX package validates them against its own; the
mapping is a function of (data, target velocities) over any leading batch
shape.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Sequence

from dexterity_tpu_torch.core.types import Model, ObjType


def _names(model: Model, otype) -> Sequence[str]:
  return {ObjType.BODY: model.body_names,
          ObjType.GEOM: model.geom_names,
          ObjType.SITE: model.site_names}[ObjType(otype)]


@dataclasses.dataclass(frozen=True)
class Parameters:
  """Parameters for a Cartesian-to-joint velocity mapper."""
  model: Model
  object_types: Sequence[ObjType]
  object_names: Sequence[str]

  def __post_init__(self):
    if len(self.object_types) != len(self.object_names):
      raise ValueError('object_types and object_names must align.')
    for otype, oname in zip(self.object_types, self.object_names):
      if otype not in (ObjType.BODY, ObjType.GEOM, ObjType.SITE):
        raise ValueError(
            f'Objects of type {otype} are not supported; only '
            'body, geom and site are.')
      if oname not in _names(self.model, otype):
        raise ValueError(f'Could not find MuJoCo object with name {oname!r} '
                         f'and type {ObjType(otype).name}.')

  def object_ids(self):
    return tuple(_names(self.model, otype).index(oname)
                 for otype, oname in zip(self.object_types,
                                         self.object_names))


class CartesianVelocitytoJointVelocityMapper(abc.ABC):
  """Maps Cartesian target velocities to joint velocities."""

  @abc.abstractmethod
  def compute_joint_velocities(self, data, target_velocities,
                               nullspace_bias=None):
    ...
