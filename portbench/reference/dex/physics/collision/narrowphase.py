"""Narrow-phase collision: candidate pairs -> contact points, static
shapes (port of dexterity_tpu/physics/collision/narrowphase.py).

The candidate pair list is fixed when the model compiles (Model.pair_*);
every pair is tested every step and inactive pairs are masked by distance.
"""

from __future__ import annotations

from reference.dex.core.types import Data, Model
from reference.dex.physics.collision import primitives


def collision(model: Model, data: Data) -> Data:
  """data.contact from the geom frames of a forward pass; a model with no
  candidate pairs leaves data as it is."""
  if model.npair == 0:
    return data
  return primitives.collide_all(model, data)
