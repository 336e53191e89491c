"""Props (port of dexterity_tpu/models/props.py).

Textures are rendering-only and omitted; physical parameters match the
JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from reference.dex.core import spec as S
from reference.dex.core.types import GeomType


class _Prop:
  def __init__(self, name: str):
    self.spec = S.ModelSpec(name=name)
    self.name = name


class TargetSphere(_Prop):
  """Non-colliding spherical target site."""

  def __init__(self, radius: float, rgba: Tuple[float, float, float, float],
               name: str = 'target'):
    super().__init__(name)
    body = self.spec.worldbody.add_body(name + '_body')
    self.site_name = name + '_site'
    body.add_site(self.site_name, size=np.full(3, radius), rgba=rgba)


class OpenAICube(_Prop):
  """Cube prop: box geom with default density 1000."""

  def __init__(self, size: float, name: str = 'openai_cube'):
    super().__init__(name)
    body = self.spec.worldbody.add_body(name + '_root')
    self.geom_name = name + '_geom'
    body.add_geom(self.geom_name, type=GeomType.BOX,
                  size=np.full(3, size), density=1000.0,
                  rgba=(1.0, 1.0, 1.0, 1.0))
    self.size = size


class JugglingBall(_Prop):
  """Juggling ball: sphere, condim 6, friction (1, .001, .001)."""

  def __init__(self, radius: float = 0.01, name: str = 'ball'):
    super().__init__(name)
    body = self.spec.worldbody.add_body(name + '_root')
    self.geom_name = name + '_geom'
    body.add_geom(self.geom_name, type=GeomType.SPHERE,
                  size=np.array([radius, 0, 0]), density=1000.0,
                  condim=6, friction=(1.0, 0.001, 0.001),
                  rgba=(0.8, 0.2, 0.2, 1.0))
    self.radius = radius
