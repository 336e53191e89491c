"""Collision predicates (port of dexterity_tpu/utils/collisions.py).

Masks are static, one bool per candidate PAIR of the compiled model; at
run time each contact slot carries its pair index, so a check is one
gather and a reduction over data.contact's slots.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.dex.core.types import Model


def group_mask(model: Model, prefixes1, prefixes2) -> np.ndarray:
  """Static (npair,) mask of pairs between two geom-name prefix groups."""

  def in_group(gid, prefixes):
    name = model.geom_names[gid]
    return any(name.startswith(p) for p in prefixes)

  mask = np.zeros(model.npair, bool)
  for i in range(model.npair):
    g1, g2 = model.pair_geom1[i], model.pair_geom2[i]
    mask[i] = ((in_group(g1, prefixes1) and in_group(g2, prefixes2))
               or (in_group(g1, prefixes2) and in_group(g2, prefixes1)))
  return mask


def self_mask(model: Model, prefix: str) -> np.ndarray:
  """Static mask of pairs internal to one entity prefix."""
  return group_mask(model, [prefix], [prefix])


def has_collision(data, pair_mask, margin: float = 0.0) -> torch.Tensor:
  """True where any contact among the masked pairs penetrates (dist <
  margin): one bool per environment, data.contact's batch shape.
  `pair_mask` is a numpy mask or, on a hot path, the same mask as a bool
  tensor on the data's device (no copy per call)."""
  pair = data.contact.pair
  mask = torch.as_tensor(pair_mask, device=pair.device)
  if mask.numel() == 0:
    return torch.zeros(pair.shape[:-1], dtype=torch.bool, device=pair.device)
  in_group = mask[pair.clamp_min(0)] & (pair >= 0)
  return (in_group & (data.contact.dist < margin)).any(-1)
