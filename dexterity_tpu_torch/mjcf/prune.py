"""Sampling-based contact-pair pruning (port of dexterity_tpu/mjcf/prune.py).

The kinematic reachable set is sampled and candidate pairs are classified
by their distance statistics:

  * never-close pairs (min distance over samples > `near`)  -> pruned;
  * always-overlapping pairs (penetrating in the reference pose and in
    nearly all samples, or several mm deep in the median sampled pose) ->
    pruned as primitive-fitting artifacts of adjacent pieces (their
    meshes don't actually touch);
  * everything else stays as a candidate pair.

The samples run through the port's batched FK and exhaustive narrow phase
on the model's device (the JAX package pins the host CPU; the port's rule
is the card unless the caller compiles elsewhere).  The joint draws are
the JAX package's `np.random.RandomState(seed)` draws, so both packages
sample the same poses; the result is deterministic given the seed.
"""

from __future__ import annotations

from typing import Set, Tuple

import numpy as np
import torch

from dexterity_tpu_torch.core import spec as S
from dexterity_tpu_torch.core import types as T


def _sample_qpos(model: T.Model, num_samples: int, seed: int) -> np.ndarray:
  """(num_samples, nq) float64: hinge and slide joints uniform in their
  ranges (±0.5 where unlimited), the rest at qpos0; sample 0 is qpos0."""
  rng = np.random.RandomState(seed)
  rngs = model.jnt_range.detach().cpu().double().numpy()
  limited = np.asarray(model.jnt_limited)
  lo = np.where(limited, rngs[:, 0], -0.5)
  hi = np.where(limited, rngs[:, 1], 0.5)
  qpos0 = model.qpos0.detach().cpu().double().numpy()
  qpos = np.tile(qpos0, (num_samples, 1))
  for ji in range(model.njnt):
    if model.jnt_type[ji] in (int(T.JointType.HINGE), int(T.JointType.SLIDE)):
      qpos[:, model.jnt_qposadr[ji]] = rng.uniform(lo[ji], hi[ji],
                                                   num_samples)
  qpos[0] = qpos0
  return qpos


def per_sample_distances(model: T.Model, num_samples: int = 256,
                         seed: int = 0) -> torch.Tensor:
  """(num_samples, npair): each candidate pair's closest contact distance
  in each sampled pose, from the exhaustive narrow phase (midphase off),
  the samples as one batch on the model's device."""
  from dexterity_tpu_torch.physics import kinematics
  from dexterity_tpu_torch.physics.collision import narrowphase, primitives

  model = model.replace(opt=model.opt.replace(midphase_cap=0))
  qpos = torch.as_tensor(_sample_qpos(model, num_samples, seed),
                         dtype=model.dtype, device=model.device)
  data = T.make_data(model, (num_samples,)).replace(qpos=qpos)
  data = narrowphase.collision(model, kinematics.fwd_position(model, data))
  d = data.contact.dist                               # (samples, npoint)
  groups, _ = primitives._pair_groups(model)
  pair_of_row = torch.as_tensor(np.concatenate(
      [np.repeat(np.asarray(grp['pair'], np.int64), grp['k'])
       for grp in groups.values()]), device=d.device)
  per_sample = d.new_full((num_samples, model.npair), float('inf'))
  return per_sample.scatter_reduce(
      1, pair_of_row.expand(num_samples, -1), d, 'amin')


def pair_distance_stats(model: T.Model, num_samples: int = 256,
                        seed: int = 0):
  """Per candidate pair over the sampled poses: (pair_min_dist,
  pair_dist0, pair_frac_overlap, pair_median_dist), numpy float64 (npair,)
  arrays, computed on the model's device."""
  return distance_stats(per_sample_distances(model, num_samples, seed))


def distance_stats(per_sample: torch.Tensor):
  """pair_distance_stats' four arrays from per_sample_distances' output;
  sample 0 is the reference pose."""
  stats = (per_sample.min(0).values, per_sample[0],
           (per_sample < 0).to(per_sample.dtype).mean(0),
           torch.quantile(per_sample, 0.5, dim=0))
  return tuple(s.double().cpu().numpy() for s in stats)


def dropped_pairs(model: T.Model, stats, explicit, near: float = 0.004,
                  overlap_frac: float = 0.98) -> Tuple[Set, int, int]:
  """The sorted (geom1, geom2) name pairs the statistics drop, and the
  counts dropped as far and as overlap artifacts.  Pairs in `explicit`
  are never dropped."""
  pair_min, pair_d0, pair_frac, pair_med = stats
  dropped: Set[Tuple[str, str]] = set()
  n_far = n_artifact = 0
  for p in range(model.npair):
    g1 = model.geom_names[model.pair_geom1[p]]
    g2 = model.geom_names[model.pair_geom2[p]]
    key = tuple(sorted((g1, g2)))
    if key in explicit:
      continue
    if pair_min[p] > near:
      n_far += 1
      dropped.add(key)
    elif ((pair_d0[p] < 0 and pair_frac[p] >= overlap_frac)
          or (pair_med[p] < -0.003 and pair_frac[p] >= 0.9)):
      # Second clause: pairs whose *typical* pose penetrates several mm
      # are primitive-bloat artifacts of adjacent pieces (the source
      # meshes never touch there), not genuine self-collision pairs.
      n_artifact += 1
      dropped.add(key)
  return dropped, n_far, n_artifact


def prune_spec_pairs(spec: S.ModelSpec, num_samples: int = 256,
                     near: float = 0.004, overlap_frac: float = 0.98,
                     seed: int = 0, verbose: bool = False, device=None,
                     dtype=torch.float32) -> S.ModelSpec:
  """Computes the dropped-pair set and stores it on the spec; the
  statistics run on `device` (cuda unless given) in `dtype`."""
  model = spec.compile(device=device, dtype=dtype)
  stats = pair_distance_stats(model, num_samples=num_samples, seed=seed)
  explicit = {tuple(sorted((p.geom1, p.geom2))) for p in spec.pairs}
  dropped, n_far, n_artifact = dropped_pairs(model, stats, explicit, near,
                                             overlap_frac)
  spec.pruned_pairs |= dropped
  if verbose:
    print(f'prune: {model.npair} pairs -> kept '
          f'{model.npair - len(dropped)} (far {n_far}, artifact {n_artifact})')
  return spec
