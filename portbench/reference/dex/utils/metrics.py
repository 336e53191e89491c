"""Episode metric accumulation (port of dexterity_tpu/utils/metrics.py).

A small metrics state rides in the training loop beside the environment
state, accumulated on the environments' device, readable at any point
with `summary()`.  It composes with `envs.batched.BatchedEnvironment`'s
auto-reset (accumulation happens on the pre-reset terminal state).
"""

from __future__ import annotations

import torch

from reference.dex.utils import structs


@structs.dataclass
class EpisodeMetrics:
  """Running episode statistics for a batch of B environments."""
  episodes: torch.Tensor        # () int32 completed episodes
  env_steps: torch.Tensor       # () int32 total environment steps taken
  return_sum: torch.Tensor      # () sum of completed-episode returns
  length_sum: torch.Tensor      # () int32 sum of completed-episode lengths
  success_sum: torch.Tensor     # () int32 completed episodes with a success
  cur_return: torch.Tensor      # (B,) running return of the live episode
  cur_length: torch.Tensor      # (B,) int32 running length


def init(batch_size: int, dtype=torch.float32, device=None) -> EpisodeMetrics:
  def i32(*shape):
    return torch.zeros(shape, dtype=torch.int32, device=device)

  return EpisodeMetrics(
      episodes=i32(), env_steps=i32(),
      return_sum=torch.zeros((), dtype=dtype, device=device),
      length_sum=i32(), success_sum=i32(),
      cur_return=torch.zeros((batch_size,), dtype=dtype, device=device),
      cur_length=i32(batch_size))


def update(metrics: EpisodeMetrics, reward: torch.Tensor, done: torch.Tensor,
           successes: torch.Tensor) -> EpisodeMetrics:
  """Accumulates one batched step.

  Args:
    reward: (B,) step rewards.
    done: (B,) bool, True where the episode ended this step.
    successes: (B,) int32 success counters of the (pre-reset) state.
  """
  cur_return = metrics.cur_return + reward
  cur_length = metrics.cur_length + 1
  donef = done.to(cur_return.dtype)
  donei = done.to(torch.int32)
  return EpisodeMetrics(
      episodes=metrics.episodes + donei.sum(dtype=torch.int32),
      env_steps=metrics.env_steps + reward.shape[0],
      return_sum=metrics.return_sum + (cur_return * donef).sum(),
      length_sum=metrics.length_sum
      + (cur_length * donei).sum(dtype=torch.int32),
      success_sum=metrics.success_sum
      + (donei * (successes > 0).to(torch.int32)).sum(dtype=torch.int32),
      cur_return=cur_return * (1.0 - donef),
      cur_length=cur_length * (1 - donei))


def summary(metrics: EpisodeMetrics) -> dict:
  """Host-side scalar summary, for logging."""
  n = max(int(metrics.episodes), 1)
  return {
      'episodes': int(metrics.episodes),
      'env_steps': int(metrics.env_steps),
      'mean_return': float(metrics.return_sum) / n,
      'mean_length': float(metrics.length_sum) / n,
      'success_rate': float(metrics.success_sum) / n,
  }
