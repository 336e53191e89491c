"""Goal environments (port of dexterity_tpu/environment.py; reference:
dexterity/environment.py and the composer.Environment episode loop).

`GoalEnvironment` compiles a GoalTask once and exposes `reset(gen,
batch)` and `step(state, action, gen)`.  Both work on any leading batch
shape (none for one environment): where the JAX package vmaps a
per-environment function, the port runs the batch at once.  The
reference's retry-forever-on-GoalInitializationError semantics become a
bounded resampling loop plus a `goal_ok` flag.

Random draws come from an explicit torch.Generator, passed to each call;
the state carries no key, and JAX's threefry streams are not reproduced.
The environment's draws are small (the cube's placement tries and the
goals), so pass a CPU generator: they are drawn in float64 on the CPU and
moved to the model's device and dtype, and a card run and a CPU run from
one seed see the same draws.

`step` has the semantics of the JAX package's `vmap(step)`: the goal
resample runs only when some environment switches goal, and only on the
rows that switch; a task whose switch threshold is 2**31 - 1 skips it
outright.  `step_batch` is `step`.

`InteractiveEnvironment` is the stateful single-environment wrapper with
the dm_env-style reset()/step() surface (numpy out).

`state_from_numpy` builds an EnvState from another package's state given
as numpy arrays; it is for tests, as `types.data_from_numpy` is.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Optional

import numpy as np
import torch

from dexterity_tpu_torch import exception
from dexterity_tpu_torch import task as task_lib
from dexterity_tpu_torch.core import types as T
from dexterity_tpu_torch.physics import step as physics_step
from dexterity_tpu_torch.utils import profiling, specs, structs

_NEVER = 2 ** 31 - 1


class StepType(enum.IntEnum):
  FIRST = 0
  MID = 1
  LAST = 2


@structs.dataclass
class TaskState:
  goal: torch.Tensor
  goal_distance: torch.Tensor
  successes: torch.Tensor               # int32
  success_change_counter: torch.Tensor  # int32
  solve_start_time: torch.Tensor        # model dtype
  exceeded_single_goal_time: torch.Tensor  # bool
  success_registered: torch.Tensor      # bool
  goal_changed: torch.Tensor            # bool
  failure_termination: torch.Tensor     # bool
  goal_ok: torch.Tensor                 # bool (goal sampling succeeded)


@structs.dataclass
class EnvState:
  data: T.Data
  task: TaskState
  eff_state: Any
  step_count: torch.Tensor              # int32


@structs.dataclass
class TimeStep:
  step_type: torch.Tensor
  reward: torch.Tensor
  discount: torch.Tensor
  observation: Dict[str, torch.Tensor]

  def first(self):
    return self.step_type == StepType.FIRST

  def mid(self):
    return self.step_type == StepType.MID

  def last(self):
    return self.step_type == StepType.LAST


class GoalEnvironment:
  """A compiled goal environment over any batch of episodes."""

  def __init__(self, task: task_lib.GoalTask, dtype=torch.float32,
               device=None, goal_retries: int = 10,
               time_limit: Optional[float] = None,
               seed: Optional[int] = None,
               strip_singleton_obs_buffer_dim: bool = True):
    """Args:
      device: where the model and every episode live (cuda unless given).
      dtype: the model's dtype.
      goal_retries: goal-sampling attempts before `goal_ok` stays False.
      time_limit: episode truncation in seconds, converted to a step limit
        at the task's control rate (overrides the task's own).
      seed: default seed of the InteractiveEnvironment wrapper.
      strip_singleton_obs_buffer_dim: when False, every observation keeps
        the (buffer_size=1,) axis of the reference's composer observables,
        after the batch axes.
    """
    self.task = task
    self.model = task.compile(device=device, dtype=dtype)
    self.dtype = self.model.dtype
    self.device = self.model.device
    self._goal_retries = goal_retries
    self._slices = task.effector_slices(self.model)
    self._action_spec = task.action_spec(self.model)
    self._act_min = torch.as_tensor(self._action_spec.minimum,
                                    dtype=self.dtype, device=self.device)
    self._act_max = torch.as_tensor(self._action_spec.maximum,
                                    dtype=self.dtype, device=self.device)
    self.default_seed = seed
    self._strip_obs_buffer_dim = strip_singleton_obs_buffer_dim
    if time_limit is not None and np.isfinite(time_limit):
      self._step_limit = int(round(time_limit / task.control_timestep))
    else:
      self._step_limit = task.step_limit

  def _observations(self, data, tstate, eff_state):
    obs = self.task.observables(self.model, data, tstate, eff_state)
    if not self._strip_obs_buffer_dim:
      nb = data.qpos.ndim - 1
      obs = {k: v.unsqueeze(nb) for k, v in obs.items()}
    return obs

  # -- specs ------------------------------------------------------------

  def action_spec(self) -> specs.BoundedArray:
    return self._action_spec

  def observation_spec(self) -> Dict[str, specs.Array]:
    """One environment's observation shapes and dtypes (read from the
    observables of a fresh state; no physics runs)."""
    data = T.make_data(self.model)
    goal = data.qpos.new_zeros(self._goal_shape())
    tstate = self._task_state_after_goal(
        goal, torch.ones((), dtype=torch.bool, device=self.device),
        data.time, data.time.new_zeros(1))
    obs = self._observations(data, tstate, self._initial_eff_state())
    return {k: specs.Array(shape=tuple(v.shape),
                           dtype=torch.empty((), dtype=v.dtype).numpy().dtype,
                           name=k)
            for k, v in obs.items()}

  # -- helpers ----------------------------------------------------------

  def _goal_shape(self):
    gen = self.task.goal_generator
    return tuple(gen.full_goal_shape() if hasattr(gen, 'full_goal_shape')
                 else gen.goal_spec().shape)

  def _sample_goal(self, data, gen):
    """Bounded retries around the goal generator: each environment keeps
    its first accepted goal, or its last attempt with goal_ok False."""
    goal_gen = self.task.goal_generator
    batch = data.qpos.shape[:-1]
    goal = data.qpos.new_zeros(batch + self._goal_shape())
    ok = torch.zeros(batch, dtype=torch.bool, device=self.device)
    for _ in range(self._goal_retries):
      goal2, data2, ok2 = goal_gen.next_goal(self.model, data, gen)
      todo = ~ok
      goal = structs.where_rows(todo, goal2, goal)
      if data2 is not data:
        data = structs.where_rows(todo, data2, data)
      ok = torch.where(todo, ok2, ok)
      if bool(ok.all()):
        break
    return goal, data, ok

  def _apply_effectors(self, data, eff_state, action):
    new_state = dict(eff_state)
    for eff, (lo, hi) in zip(self.task.hand_effectors, self._slices):
      sub = torch.clamp(action[..., lo:hi], self._act_min[lo:hi],
                        self._act_max[lo:hi])
      data, st = eff.set_control(self.model, data,
                                 new_state.get(eff.prefix, {}), sub)
      new_state[eff.prefix] = st
    return data, new_state

  def _initial_eff_state(self, batch=()):
    return {eff.prefix: eff.initial_state(self.model, batch)
            for eff in self.task.hand_effectors}

  def _task_state_after_goal(self, goal, ok, time, goal_distance):
    batch = ok.shape

    def flag(value):
      return torch.full(batch, value, dtype=torch.bool, device=self.device)

    zero = torch.zeros(batch, dtype=torch.int32, device=self.device)
    return TaskState(
        goal=goal, goal_distance=goal_distance, successes=zero,
        success_change_counter=zero.clone(),
        solve_start_time=time.to(self.dtype).clone(),
        exceeded_single_goal_time=flag(False),
        success_registered=flag(False), goal_changed=flag(True),
        failure_termination=flag(False), goal_ok=ok)

  # -- public API ------------------------------------------------------------

  def reset(self, gen: torch.Generator, batch=()):
    """New episodes for the batch shape `batch` (none: one environment),
    drawing from `gen` (a CPU generator; see the module docstring).
    Returns (EnvState, TimeStep)."""
    model, task = self.model, self.task
    batch = tuple(batch)
    data = T.make_data(model, batch)
    data = physics_step.fwd_position(model, data)
    data = task.initialize_episode(model, data, gen)
    data = task.goal_generator.initialize_episode(model, data, gen)
    goal, data, ok = self._sample_goal(data, gen)
    data = task.on_goal_update(model, data, self._task_state_after_goal(
        goal, ok, data.time, data.time.new_zeros(batch + (1,))))
    data = physics_step.forward(model, data)
    cur = task.goal_generator.current_state(model, data)
    tstate = self._task_state_after_goal(
        goal, ok, data.time, task.goal_generator.goal_distance(goal, cur))
    eff_state = self._initial_eff_state(batch)
    state = EnvState(data=data, task=tstate, eff_state=eff_state,
                     step_count=torch.zeros(batch, dtype=torch.int32,
                                            device=self.device))
    ts = TimeStep(
        step_type=torch.full(batch, int(StepType.FIRST), dtype=torch.int32,
                             device=self.device),
        reward=torch.zeros(batch, dtype=self.dtype, device=self.device),
        discount=torch.ones(batch, dtype=self.dtype, device=self.device),
        observation=self._observations(data, tstate, eff_state))
    return state, ts

  def step(self, state: EnvState, action,
           gen: Optional[torch.Generator] = None):
    """One control step of every environment in `state` with `action`
    (the batch shape + (nu,)); `gen` draws the new goals of environments
    that switch goal (needed only then).  Returns (EnvState, TimeStep)."""
    with profiling.trace_annotation('env.step'):
      tstate = state.task
      data = state.data
      goal, goal_ok = tstate.goal, tstate.goal_ok
      # before_step: goal switching (reference task.py:154-165).
      with profiling.trace_annotation('env.goal_switch'):
        switch = (tstate.success_change_counter
                  > self.task.steps_before_changing_goal)
        if (self.task.steps_before_changing_goal < _NEVER
            and bool(switch.any())):
          if gen is None:
            raise ValueError('an environment switches goal: step needs a '
                             'generator')
          goal2, sub, ok2 = self._sample_goal(structs.take_rows(switch, data),
                                              gen)
          data = structs.put_rows(switch, data, sub)
          goal = structs.put_rows(switch, goal, goal2)
          goal_ok = structs.put_rows(switch, goal_ok, ok2)
      action = torch.as_tensor(action, dtype=self.dtype, device=self.device)
      return self._step_after_switch(state, action, switch, goal, data,
                                     goal_ok)

  step_batch = step

  def _step_after_switch(self, state, action, switch, goal, data, goal_ok):
    """Everything in step() after goal switching."""
    model, task = self.model, self.task
    tstate = state.task
    tstate = tstate.replace(
        goal=goal, goal_ok=goal_ok, goal_changed=switch,
        success_change_counter=torch.where(
            switch, 0, tstate.success_change_counter),
        exceeded_single_goal_time=tstate.exceeded_single_goal_time & ~switch,
        solve_start_time=torch.where(switch, data.time.to(self.dtype),
                                     tstate.solve_start_time),
        success_registered=tstate.success_registered & ~switch)
    data = task.on_goal_update(model, data, tstate)

    data, eff_state = self._apply_effectors(data, state.eff_state, action)
    # refresh='full': failure_termination reads fresh contacts.
    data = physics_step.step_n(model, data, task.n_substeps)

    with profiling.trace_annotation('env.task'):
      # after_step (reference task.py:167-185).
      gen = task.goal_generator
      dist = gen.goal_distance(tstate.goal, gen.current_state(model, data))
      success_now = (dist <= task.success_threshold).all(-1)
      counter = torch.where(success_now, tstate.success_change_counter + 1,
                            tstate.success_change_counter)
      new_success = success_now & ~tstate.success_registered
      successes = tstate.successes + new_success.to(torch.int32)
      registered = tstate.success_registered | success_now
      exceeded = tstate.exceeded_single_goal_time
      if task.max_time_per_goal is not None:
        exceeded = exceeded | (
            ~success_now
            & (data.time - tstate.solve_start_time > task.max_time_per_goal))
      failure = task.failure_termination(model, data)
      tstate = tstate.replace(
          goal_distance=dist, success_change_counter=counter,
          successes=successes, success_registered=registered,
          exceeded_single_goal_time=exceeded, failure_termination=failure)

      # Termination, reward, discount (reference task.py:187-204).
      solved = successes >= task.successes_needed
      terminate = solved | exceeded | failure
      discount = torch.where(solved & ~failure, 0.0, 1.0).to(self.dtype)
      reward = torch.as_tensor(task.get_reward(model, data, tstate),
                               dtype=self.dtype, device=self.device)
      obs = self._observations(data, tstate, eff_state)
    step_count = state.step_count + 1
    if self._step_limit is not None:
      terminate = terminate | (step_count >= self._step_limit)
    step_type = torch.where(terminate, int(StepType.LAST),
                            int(StepType.MID)).to(torch.int32)
    new_state = EnvState(data=data, task=tstate, eff_state=eff_state,
                         step_count=step_count)
    return new_state, TimeStep(step_type=step_type, reward=reward,
                               discount=discount, observation=obs)


# Plain tasks (no goal machinery) run under the same environment; the base
# Task exposes a null goal generator (see task.py).
Environment = GoalEnvironment


class InteractiveEnvironment:
  """Stateful single-environment wrapper with the dm_env-style interface;
  time steps come out as numpy arrays."""

  def __init__(self, env: GoalEnvironment, seed: Optional[int] = None):
    self._env = env
    self._gen = torch.Generator().manual_seed(seed or 0)
    self._state = None
    self._needs_reset = True

  def action_spec(self):
    return self._env.action_spec()

  def observation_spec(self):
    return self._env.observation_spec()

  @property
  def state(self) -> EnvState:
    return self._state

  @property
  def task(self):
    return self._env.task

  def reset(self):
    for _ in range(20):  # reference: retry forever; bounded here
      self._state, ts = self._env.reset(self._gen)
      if bool(self._state.task.goal_ok):
        self._needs_reset = False
        return _to_numpy(ts)
    raise exception.GoalInitializationError(
        'goal sampling failed across retries')

  def step(self, action):
    if self._state is None or self._needs_reset:
      return self.reset()
    self._state, ts = self._env.step(self._state, action, self._gen)
    if bool(ts.last()):
      self._needs_reset = True
    return _to_numpy(ts)


def _to_numpy(ts: TimeStep) -> TimeStep:
  return structs.tree_map(lambda x: x.detach().cpu().numpy(), ts)


def state_from_numpy(fields: Dict[str, Any], device=None,
                     dtype=torch.float32) -> EnvState:
  """An EnvState from numpy arrays: fields 'data' (as
  types.data_from_numpy takes it), 'task' (TaskState field -> array),
  'eff_state' (nested dicts of arrays) and 'step_count'.  Floats become
  `dtype`, integers int32, bools bool."""
  device = T.resolve_device(device)

  def tensor(v):
    v = np.array(v)
    if v.dtype == bool:
      dt = torch.bool
    elif np.issubdtype(v.dtype, np.integer):
      dt = torch.int32
    else:
      dt = dtype
    return torch.as_tensor(v, device=device).to(dt)

  def nested(v):
    if isinstance(v, dict):
      return {k: nested(x) for k, x in v.items()}
    return tensor(v)

  return EnvState(
      data=T.data_from_numpy(fields['data'], device=device, dtype=dtype),
      task=TaskState(**{k: tensor(v) for k, v in fields['task'].items()}),
      eff_state=nested(fields['eff_state']),
      step_count=tensor(fields['step_count']))
