"""Population-sharded predictive sampling over a process mesh (port of
dexterity_tpu/planners/distributed.py).

Every rank of the mesh's process group draws the FULL candidate set from
its generator (noise is ~N·H·nu floats, negligible next to one rollout),
rolls out only its contiguous slice of `ceil(N / world)` rows (padded with
repeats of the last row), and an all-gather of the per-rank returns
rebuilds the complete return vector on every rank, so selection is the
single-device rule (`PredictiveSampling._select` / `_select_batch`) on
identical inputs and every rank returns the same plan.  The tensors are
plain local tensors on the planner's device; collectives run on the
mesh's process group (NCCL between cards, gloo on the CPU).

JAX replicates one key; the port needs every rank's generator in the same
state, or the ranks would select different plans without an error.  Both
solves therefore all-gather a digest of `gen.get_state()` on entry and
raise if the ranks disagree.
"""

from __future__ import annotations

import hashlib

import torch
import torch.distributed as dist

from dexterity_tpu_torch.core import types as T
from dexterity_tpu_torch.parallel.sharding import BATCH_AXIS
from dexterity_tpu_torch.planners.predictive_sampling import (
    PlannerState, PredictiveSampling, _shift)


def _axis(mesh, axis_name: str = BATCH_AXIS):
  """(process group, number of ranks, this rank's index) of a mesh axis."""
  return (mesh.get_group(axis_name), mesh.size(),
          mesh.get_local_rank(axis_name))


def _generator_digest(gen: torch.Generator) -> bytes:
  """16 bytes that identify a generator's state: a CUDA generator's state
  is its seed and offset (16 bytes), taken as they are; a longer state
  (the CPU's Mersenne Twister) is hashed to 16 bytes."""
  state = bytes(gen.get_state().tolist())
  if len(state) <= 16:
    return state.ljust(16, b'\0')
  return hashlib.blake2b(state, digest_size=16).digest()


def _check_same_generator(gen: torch.Generator, group, device) -> None:
  """Raises RuntimeError on every rank unless all ranks' generators are in
  the same state."""
  mine = torch.tensor(list(_generator_digest(gen)), dtype=torch.uint8,
                      device=device)
  digests = gather_rows(mine, group)
  if not all(torch.equal(d, digests[0]) for d in digests):
    ranks = [i for i, d in enumerate(digests)
             if not torch.equal(d, digests[0])]
    raise RuntimeError(f'generator state differs across ranks (ranks '
                       f'{ranks} differ from rank 0): every rank must draw '
                       f'the same candidates')


def gather_rows(x: torch.Tensor, group):
  """Every rank's `x` (same shape on all), in rank order, on every rank
  (the list form of all_gather, which gloo and NCCL both take)."""
  out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
  dist.all_gather(out, x.contiguous(), group=group)
  return out


def _pad_slice(x: torch.Tensor, per: int, n_dev: int, idx: int):
  """Rank `idx`'s contiguous `per` rows of x padded to per·n_dev rows
  with repeats of its last row."""
  total = x.shape[0]
  if per * n_dev > total:
    pad = x[-1:].expand((per * n_dev - total,) + x.shape[1:])
    x = torch.cat([x, pad])
  return x[idx * per:(idx + 1) * per]


def _gathered_returns(local: torch.Tensor, group, total: int):
  return torch.cat(gather_rows(local, group))[:total]


def sharded_solve(planner: PredictiveSampling, mesh, data: T.Data,
                  goal: torch.Tensor, pstate: PlannerState,
                  gen: torch.Generator):
  """One population-sharded MPC solve: `PredictiveSampling.solve`'s CEM
  loop (`iterations` with `noise_decay`, argmax or MPPI selection, the
  receding shift) with each rank rolling out its slice of the candidates
  through `rollout_returns_batched`.  Inputs and outputs are the same on
  every rank.  Returns (action (nu,), new PlannerState)."""
  cfg = planner.config
  group, n_dev, idx = _axis(mesh)
  _check_same_generator(gen, group, planner.device)
  n = cfg.num_samples
  per = -(-n // n_dev)
  best_seq = pstate.nominal
  best_ret = torch.tensor(-float('inf'), dtype=planner.dtype,
                          device=planner.device)
  mult = 1.0
  for _ in range(max(cfg.iterations, 1)):
    candidates = planner._candidates(best_seq, gen, mult)
    local = planner.rollout_returns_batched(
        data, goal, _pad_slice(candidates, per, n_dev, idx))
    returns = _gathered_returns(local, group, n)
    best_seq, best_ret = planner._select(candidates, returns)
    mult = mult * cfg.noise_decay
  return best_seq[0], PlannerState(nominal=_shift(best_seq),
                                   best_return=best_ret)


def sharded_solve_batch(planner: PredictiveSampling, mesh, data_b: T.Data,
                        goals: torch.Tensor, pstates: PlannerState,
                        gen: torch.Generator):
  """G concurrent population-sharded MPC solves (the multi-stream form):
  `PredictiveSampling.solve_batch`'s loop with the flattened (G·N)
  rollout batch split over the ranks.  The per-candidate start states and
  goals are padded and sliced once, before the loop.  Argmax selection
  per stream; `temperature` is ignored, as in `solve_batch`.  Returns
  (actions (G, nu), new PlannerState), the same on every rank."""
  cfg = planner.config
  group, n_dev, idx = _axis(mesh)
  _check_same_generator(gen, group, planner.device)
  g = goals.shape[0]
  total = g * cfg.num_samples
  per = -(-total // n_dev)
  best_seq = pstates.nominal                             # (G, H, nu)
  best_ret = torch.full((g,), -float('inf'), dtype=planner.dtype,
                        device=planner.device)
  mult = 1.0
  bdata, goals_f = planner._flatten_streams(data_b, goals)
  bdata_my = T.map_data(bdata, lambda x: _pad_slice(x, per, n_dev, idx))
  goals_my = _pad_slice(goals_f, per, n_dev, idx)
  for _ in range(max(cfg.iterations, 1)):
    cands = planner._candidates_batch(best_seq, gen, mult)
    flat = cands.reshape((total,) + cands.shape[2:])
    local = planner.rollout_returns_flat(
        bdata_my, goals_my, _pad_slice(flat, per, n_dev, idx))
    returns = _gathered_returns(local, group, total)
    best_seq, best_ret = planner._select_batch(cands, returns.reshape(g, -1))
    mult = mult * cfg.noise_decay
  return best_seq[:, 0], PlannerState(nominal=_shift(best_seq),
                                      best_return=best_ret)
