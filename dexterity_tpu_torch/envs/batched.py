"""An auto-resetting batch of environments (port of
dexterity_tpu/envs/batched.py).

`BatchedEnvironment` holds B independent episodes as one batched state;
`step` resets the episodes that ended (the standard RL training loop
contract).  The reset runs only when some episode ended, and only for
those rows, which are merged in with the row helpers of utils/structs.
"""

from __future__ import annotations

import torch

from dexterity_tpu_torch import environment as env_lib
from dexterity_tpu_torch.utils import metrics as metrics_lib
from dexterity_tpu_torch.utils import profiling, structs


class BatchedEnvironment:
  """Auto-resetting batch of GoalEnvironment episodes."""

  def __init__(self, env: env_lib.GoalEnvironment, batch_size: int):
    self.env = env
    self.batch_size = batch_size

  def reset(self, gen: torch.Generator):
    return self.env.reset(gen, (self.batch_size,))

  def _merge_resets(self, new_state, done, gen):
    """Resets the done episodes in place: a new episode for each done row
    (goal sampling and the placement tries cost several steps' worth of
    physics, so the others are not reset and then discarded)."""
    with profiling.trace_annotation('env.merge_resets'):
      n = int(done.sum())
      profiling.count('rows_reset', n)
      if n == 0:
        return new_state
      with profiling.trace_annotation('env.reset'):
        reset_state, _ = self.env.reset(gen, (n,))
      return structs.put_rows(done, new_state, reset_state)

  def step(self, state, actions, gen: torch.Generator):
    """Steps all episodes; episodes that ended are reset in place.

    Returns (state, timestep) where ended episodes report their terminal
    timestep and the state already holds the next episode's start.
    """
    new_state, ts = self.env.step(state, actions, gen)
    done = ts.step_type == env_lib.StepType.LAST
    return self._merge_resets(new_state, done, gen), ts

  def step_with_metrics(self, state, actions, metrics, gen: torch.Generator):
    """Like step(), also accumulating episode metrics
    (utils.metrics.EpisodeMetrics) on the pre-reset terminal state."""
    new_state, ts = self.env.step(state, actions, gen)
    done = ts.step_type == env_lib.StepType.LAST
    metrics = metrics_lib.update(metrics, ts.reward, done,
                                 new_state.task.successes)
    return self._merge_resets(new_state, done, gen), ts, metrics
