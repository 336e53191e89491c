"""Reward shaping utilities (port of
dexterity_tpu/manipulation/shared/rewards.py)."""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Reward:
  value: torch.Tensor
  weight: float


def weighted_average(rewards: Mapping[str, Reward]):
  """Weighted sum of shaped reward components."""
  total = 0.0
  for reward in rewards.values():
    total = total + reward.value * reward.weight
  return total


def tanh_squared(x, margin: float, loss_at_margin: float = 0.95):
  """tanh^2 shaping loss of the norm over the last axis."""
  if not margin > 0:
    raise ValueError('`margin` must be positive.')
  if not 0.0 < loss_at_margin < 1.0:
    raise ValueError('`loss_at_margin` must be between 0 and 1.')
  x = torch.as_tensor(x)
  error = torch.linalg.norm(torch.atleast_1d(x), dim=-1)
  w = np.arctanh(np.sqrt(loss_at_margin)) / margin
  s = torch.tanh(w * error)
  return s * s


def tolerance(x, lower: float, upper: float):
  """1.0 inside [lower, upper], else 0.0 (dm_control rewards.tolerance
  with margin=0)."""
  x = torch.as_tensor(x)
  return ((x >= lower) & (x <= upper)).to(
      x.dtype if x.is_floating_point() else torch.get_default_dtype())
