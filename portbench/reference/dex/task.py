"""Task and GoalTask (port of dexterity_tpu/task.py).

A Task composes an arena, hands and effectors into one ModelSpec, compiles
it once per (device, dtype), and defines the episode hooks: the action
spec and effector slices, `initialize_episode`, `observables`,
`get_reward`, `failure_termination`, `on_goal_update`, and the planner's
`rollout_failure` and `plan_refresh`.  GoalTask adds the goal generator
and the goal thresholds.  The per-episode state machine (goal switching,
success counting, termination, discounts) runs in
`environment.GoalEnvironment`.  The hooks take batch-leading Data (any
leading batch shape, none for one environment) and return one value per
environment.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from reference.dex import goal as goal_lib
from reference.dex.core import types
from reference.dex.utils import specs as spec_utils


class Task:
  """Base class for dexterous manipulation tasks."""

  def __init__(self, arena, hands: Sequence,
               hand_effectors: Sequence = ()) -> None:
    if len(set(hand.name for hand in hands)) != len(hands):
      raise ValueError('Each hand must have a unique name.')
    if len(set(eff.prefix for eff in hand_effectors)) != len(hand_effectors):
      raise ValueError('Each effector must have a unique prefix.')
    self._arena = arena
    self._hands = tuple(hands)
    self._hand_effectors = tuple(hand_effectors)
    self._control_timestep = 0.02
    self._physics_timestep = 0.02
    self._models = {}

  def set_timesteps(self, control_timestep: float, physics_timestep: float):
    self._control_timestep = control_timestep
    self._physics_timestep = physics_timestep
    self._arena.spec.option.timestep = physics_timestep

  @property
  def control_timestep(self) -> float:
    return self._control_timestep

  @property
  def physics_timestep(self) -> float:
    return self._physics_timestep

  @property
  def n_substeps(self) -> int:
    return max(1, round(self._control_timestep / self._physics_timestep))

  # -- compilation -------------------------------------------------------

  def compile(self, device=None, dtype=torch.float32) -> types.Model:
    """Compiles the composed spec on `device` (cuda unless given) in
    `dtype` and wires the effectors.  Idempotent per (device, dtype)."""
    device = types.resolve_device(device)
    key = (str(device), dtype)
    if key not in self._models:
      model = self._arena.spec.compile(device=device, dtype=dtype)
      for eff in self._hand_effectors:
        eff.after_compile(model)
      self.after_compile(model)
      self._models[key] = model
    return self._models[key]

  def after_compile(self, model) -> None:
    """Subclass hook once the model exists."""

  def action_spec(self, model=None) -> spec_utils.BoundedArray:
    model = model if model is not None else self.compile()
    return spec_utils.merge_specs(
        [eff.action_spec(model) for eff in self._hand_effectors])

  def effector_slices(self, model=None) -> Tuple[Tuple[int, int], ...]:
    """Static (start, stop) action slices per effector."""
    model = model if model is not None else self.compile()
    out = []
    ofs = 0
    for eff in self._hand_effectors:
      n = eff.action_spec(model).shape[0]
      out.append((ofs, ofs + n))
      ofs += n
    return tuple(out)

  # -- episode hooks ---------------------------------------------------------

  def initialize_episode(self, model, data, gen):
    """Returns data after per-episode physics edits, drawing from the
    torch.Generator `gen`."""
    del model, gen
    return data

  def observables(self, model, data, task_state, eff_state) -> dict:
    """Returns the observation dict (a fixed keyset)."""
    del model, data, task_state, eff_state
    return {}

  def get_reward(self, model, data, task_state):
    del model, task_state
    return data.qpos.new_zeros(data.qpos.shape[:-1])

  def failure_termination(self, model, data):
    """Task-specific failure predicate (e.g. the prop fell), one bool per
    environment."""
    del model
    return torch.zeros(data.qpos.shape[:-1], dtype=torch.bool,
                       device=data.qpos.device)

  def rollout_failure(self, model, data):
    """Failure predicate for planner rollouts: may be a cheap
    position-level proxy of failure_termination (rollouts refresh no
    contact data).  Defaults to the exact predicate."""
    return self.failure_termination(model, data)

  # Kinematics refresh level planner rollouts need per control step so the
  # planning reward and rollout_failure read consistent state: 'position'
  # (frames + sites), or 'none' when they read qpos directly.
  plan_refresh = 'position'

  def on_goal_update(self, model, data, task_state):
    """Hook after a goal is (re)sampled, e.g. to move a visual hint
    body."""
    del model, task_state
    return data

  # -- accessors -------------------------------------------------------------

  @property
  def arena(self):
    return self._arena

  @property
  def hands(self) -> Tuple:
    return self._hands

  @property
  def hand_effectors(self) -> Tuple:
    return self._hand_effectors

  @property
  def step_limit(self) -> Optional[int]:
    return None

  @property
  def time_limit(self) -> float:
    return float('inf')

  # Non-goal tasks run with a null goal: zero-dim goal, never-successful
  # threshold, no switching.
  @property
  def goal_generator(self):
    return _NULL_GOAL

  @property
  def success_threshold(self) -> float:
    return -float('inf')

  @property
  def successes_needed(self) -> int:
    return 2 ** 31 - 1

  @property
  def steps_before_changing_goal(self) -> int:
    return 2 ** 31 - 1

  @property
  def max_time_per_goal(self) -> Optional[float]:
    return None


class _NullGoalGenerator(goal_lib.GoalGenerator):
  """Zero-dimensional goal for plain (non-goal) tasks."""

  def goal_spec(self):
    return spec_utils.Array(shape=(0,), dtype=np.float64, name='null_goal')

  def full_goal_shape(self):
    return (0,)

  def next_goal(self, model, data, gen):
    del model, gen
    batch = data.qpos.shape[:-1]
    return (data.qpos.new_zeros(batch + (0,)), data,
            torch.ones(batch, dtype=torch.bool, device=data.qpos.device))

  def current_state(self, model, data):
    return data.qpos.new_zeros(data.qpos.shape[:-1] + (0,))

  def goal_distance(self, goal_state, current_state):
    # Never within a -inf threshold.
    return current_state.new_ones(current_state.shape[:-1] + (1,))

  @property
  def name(self) -> str:
    return 'null_goal'


_NULL_GOAL = _NullGoalGenerator()


class GoalTask(Task):
  """Goal-reaching task configuration."""

  def __init__(self, arena, hands, hand_effectors,
               goal_generator: goal_lib.GoalGenerator,
               success_threshold: float,
               successes_needed: int = 1,
               steps_before_changing_goal: int = 0,
               max_time_per_goal: Optional[float] = None) -> None:
    super().__init__(arena, hands, hand_effectors)
    self._goal_generator = goal_generator
    self._success_threshold = success_threshold
    self._successes_needed = successes_needed
    self._steps_before_changing_goal = steps_before_changing_goal
    self._max_time_per_goal = max_time_per_goal

  @property
  def goal_generator(self) -> goal_lib.GoalGenerator:
    return self._goal_generator

  @property
  def success_threshold(self) -> float:
    return self._success_threshold

  @property
  def successes_needed(self) -> int:
    return self._successes_needed

  @property
  def steps_before_changing_goal(self) -> int:
    return self._steps_before_changing_goal

  @property
  def max_time_per_goal(self) -> Optional[float]:
    return self._max_time_per_goal
