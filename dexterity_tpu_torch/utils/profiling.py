"""Profiling and tracing helpers (port of dexterity_tpu/utils/profiling.py):
named regions in profiler traces, a device trace written to a directory,
a steps-per-second counter and a host-side finiteness check."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from dexterity_tpu_torch.utils import structs


@contextlib.contextmanager
def trace_annotation(name: str):
  """Named region in torch.profiler traces."""
  with torch.profiler.record_function(name):
    yield


@contextlib.contextmanager
def device_trace(logdir: str):
  """Profiles the block (CPU activity, and the card's where there is one)
  and writes a Chrome trace, `logdir/trace.json`."""
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(logdir, exist_ok=True)
  with torch.profiler.profile(activities=activities) as prof:
    yield prof
  prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


class Throughput:
  """Steps/solves-per-second counter with warmup exclusion."""

  def __init__(self, warmup: int = 1):
    self._warmup = warmup
    self._count = 0
    self._t0 = None

  def tick(self, n: int = 1) -> None:
    self._count += n
    if self._count >= self._warmup and self._t0 is None:
      self._t0 = time.time()
      self._base = self._count

  @property
  def per_second(self) -> Optional[float]:
    if self._t0 is None or self._count <= self._base:
      return None
    return (self._count - self._base) / (time.time() - self._t0)


def assert_finite(tree, name: str = 'state'):
  """Host-side NaN/Inf check over the tensors of `tree` (structs.tree_map's
  order), for debugging; raises FloatingPointError naming the first leaf
  that holds one."""
  for i, leaf in enumerate(structs.tree_leaves(tree)):
    if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
      raise FloatingPointError(
          f'non-finite values in {name}, leaf {i} of shape '
          f'{tuple(leaf.shape)}')
