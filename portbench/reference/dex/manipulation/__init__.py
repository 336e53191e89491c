"""Manipulation task suite (port of dexterity_tpu/manipulation/__init__.py;
reference: dexterity/manipulation/__init__.py).

`load(domain, task)` mirrors the reference API surface: ALL_TASKS,
ALL_NAMES, TASKS_BY_DOMAIN and per-domain SUITE registries; it returns a
compiled `GoalEnvironment` on `cuda` unless given a device.
`load_interactive` wraps it with the stateful dm_env-style interface.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from reference.dex import environment as _environment
from reference.dex import task as _task
from reference.dex.manipulation.tasks import juggle as _juggle
from reference.dex.manipulation.tasks import reorient as _reorient

_DOMAINS = {
    name: module
    for name, module in (('reorient', _reorient), ('juggle', _juggle))
    if hasattr(module, 'SUITE')
}


def _get_tasks(tag):
  """Returns a sequence of (domain name, task name) pairs."""
  result = []
  for domain_name in sorted(_DOMAINS.keys()):
    domain = _DOMAINS[domain_name]
    if tag is None:
      tasks_in_domain = sorted(domain.SUITE.keys())
    else:
      tasks_in_domain = sorted(domain.SUITE.tagged(tag))
    for task_name in tasks_in_domain:
      result.append((domain_name, task_name))
  return tuple(result)


def _get_tasks_by_domain(tasks):
  result = collections.defaultdict(list)
  for domain_name, task_name in tasks:
    result[domain_name].append(task_name)
  return {k: tuple(v) for k, v in result.items()}


ALL_TASKS = _get_tasks(tag=None)
ALL_NAMES = ['.'.join(domain_task) for domain_task in ALL_TASKS]
TASKS_BY_DOMAIN = _get_tasks_by_domain(ALL_TASKS)


def build_task(domain_name: str, task_name: str) -> _task.Task:
  """Builds the named task (no tensors yet: `task.compile(device=...)`)."""
  if domain_name not in _DOMAINS:
    raise ValueError(f'Unknown domain: {domain_name}')
  domain = _DOMAINS[domain_name]
  if task_name not in domain.SUITE:
    raise ValueError(f'Unknown task: {task_name}')
  return domain.SUITE[task_name]()


def load(domain_name: str, task_name: str, seed: Optional[int] = None,
         strip_singleton_obs_buffer_dim: bool = True,
         time_limit: Optional[float] = None,
         dtype=torch.float32, device=None) -> _environment.GoalEnvironment:
  """Builds and compiles a task environment on `device` (cuda unless
  given) in `dtype`.

  Honors the reference `load()` contract
  (dexterity/manipulation/__init__.py:57-86):
    seed: default seed, used when the environment is driven through the
      stateful InteractiveEnvironment wrapper (`reset(gen, batch)` takes an
      explicit generator).
    strip_singleton_obs_buffer_dim: when False, every observation keeps the
      (buffer_size=1,) axis the reference's composer observables carry,
      after the batch axes.
    time_limit: episode truncation in seconds; converted to a step limit
      at the task's control rate like composer.Environment.

  Contact-pair pruning is baked into the model assets (the reference
  prunes per load, manipulation/__init__.py:71-74).
  """
  task = build_task(domain_name, task_name)
  return _environment.GoalEnvironment(
      task, dtype=dtype, device=device, time_limit=time_limit, seed=seed,
      strip_singleton_obs_buffer_dim=strip_singleton_obs_buffer_dim)


def load_interactive(domain_name: str, task_name: str,
                     seed: Optional[int] = None, **kwargs):
  env = load(domain_name, task_name, seed=seed, **kwargs)
  return _environment.InteractiveEnvironment(env, seed=seed)
