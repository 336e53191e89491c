"""Array specs and spec merging (the port's own copy of
dexterity_tpu/utils/specs.py).

Mirrors the dm_env specs surface the reference uses, plus `merge_specs`
(reference: dexterity/utils/spec_utils.py:10-37): flat BoundedArrays are
concatenated, names joined with tabs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Array:
  shape: Tuple[int, ...]
  dtype: np.dtype
  name: Optional[str] = None

  def validate(self, value) -> None:
    value = np.asarray(value)
    if tuple(value.shape) != tuple(self.shape):
      raise ValueError(f'Expected shape {self.shape}, got {value.shape}')

  def generate_value(self) -> np.ndarray:
    return np.zeros(self.shape, dtype=self.dtype)


@dataclasses.dataclass(frozen=True)
class BoundedArray(Array):
  minimum: np.ndarray = None
  maximum: np.ndarray = None

  def validate(self, value) -> None:
    super().validate(value)
    value = np.asarray(value)
    if np.any(value < self.minimum) or np.any(value > self.maximum):
      raise ValueError('Value out of bounds.')

  def generate_value(self) -> np.ndarray:
    return np.clip(np.zeros(self.shape, dtype=self.dtype),
                   self.minimum, self.maximum)


def merge_specs(specs: Sequence[BoundedArray]) -> BoundedArray:
  """Concatenates flat BoundedArrays (drops zero-dof specs); names are
  tab-joined — the action-spec composition mechanism."""
  specs = [s for s in specs if s.shape[0] > 0]
  if not specs:
    raise ValueError('No specs to merge.')
  for s in specs:
    if len(s.shape) != 1:
      raise ValueError('Not merging multi-dimensional spec.')
  names = []
  for s in specs:
    if s.name:
      names.extend(s.name.split('\t'))
    else:
      names.extend(f'{i}' for i in range(s.shape[0]))
  dtype = np.result_type(*[s.dtype for s in specs])
  return BoundedArray(
      shape=(sum(s.shape[0] for s in specs),), dtype=dtype,
      name='\t'.join(names),
      minimum=np.concatenate([np.broadcast_to(s.minimum, s.shape)
                              for s in specs]),
      maximum=np.concatenate([np.broadcast_to(s.maximum, s.shape)
                              for s in specs]))
