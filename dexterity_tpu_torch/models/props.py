"""Props (port of dexterity_tpu/models/props.py; OpenAICube only)."""

from __future__ import annotations

import numpy as np

from dexterity_tpu_torch.core import spec as S
from dexterity_tpu_torch.core.types import GeomType


class _Prop:
  def __init__(self, name: str):
    self.spec = S.ModelSpec(name=name)
    self.name = name


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
