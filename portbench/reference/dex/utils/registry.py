"""Tagged task registry (port of dexterity_tpu/utils/registry.py; the
dm_control containers.TaggedTasks equivalent)."""

from __future__ import annotations

from typing import Callable, Dict, List


class TaggedTasks:

  def __init__(self):
    self._tasks: Dict[str, Callable] = {}
    self._tags: Dict[str, List[str]] = {}

  def add(self, *tags: str):
    def wrap(fn):
      self._tasks[fn.__name__] = fn
      self._tags[fn.__name__] = list(tags)
      return fn
    return wrap

  def __contains__(self, name: str) -> bool:
    return name in self._tasks

  def __getitem__(self, name: str) -> Callable:
    return self._tasks[name]

  def __iter__(self):
    return iter(self._tasks)

  def keys(self):
    return self._tasks.keys()

  def items(self):
    return self._tasks.items()

  def tagged(self, *tags: str):
    """Returns task names carrying all given tags."""
    return [name for name, t in self._tags.items()
            if all(tag in t for tag in tags)]

  def tags(self, name: str):
    return tuple(self._tags[name])
