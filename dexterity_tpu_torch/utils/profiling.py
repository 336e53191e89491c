"""Tracing of the port's layers, and a host-side finiteness check (port of
dexterity_tpu/utils/profiling.py).

Spans.  The port opens a span (`trace_annotation`) at each layer boundary
of its hot path; children nest in their parents:
  planner.solve_batch > planner.iteration > planner.rollout
  physics.step_n (step_n_b) > physics.planes (the tree sweep's planes),
      collision.midphase, collision.narrowphase, physics.smooth
      (actuation, passive, applied forces), constraint.solve
      (> constraint.assemble, constraint.newton), physics.integrate,
      physics.refresh (> collision.narrowphase)
  env.step > env.goal_switch, physics.step_n, env.task (termination,
      reward, observations)
  env.merge_resets > env.reset
A span is recorded only while a torch.profiler session runs; otherwise
`trace_annotation` returns a shared no-op and costs one call of torch's
profiler-enabled test.  So an operator who profiles the port
(`device_trace`, or any torch.profiler session) gets its spans, and a run
that is not profiled allocates nothing for them.  A span is (name,
start_ns, end_ns, depth, parent), stamped with `time.time_ns()`, the
clock that the profiler's kernel records carry: an idle stretch of the
card can be charged to the innermost span the host was in.  Spans use no `record_function` range, which the
profiler could report among the card's records.

Counters.  `count(name, value, reduce)` attaches a count to the innermost
open span (nothing when none is open).  The value is a host integer, or a
device tensor that the hot path computed anyway, with `reduce` turning it
into an integer.  The reduction runs when the records are read, never
inside the profiled window: a counter launches no kernel and reads nothing
from the card while it is traced.  A counter's tensor stays allocated
until `records()` reads it, so counters hold small tensors only.  The
port's counters:
  constraint.assemble  slots   rows x the narrow phase's contact slots
                       live    slots the solve keeps as active contacts
                               (its top-k mask: dist - margin < 0, at
                               most contact_top_k a row)
  constraint.newton    row_iters, moved   per Newton iteration: rows, and
                               rows whose line search moved (step > 0)
  env.merge_resets     rows_reset

`records()` returns what was recorded since the last `clear()`, with the
counters reduced to numbers; the buffer keeps growing while sessions run,
and `clear()` empties it (and drops the tensors counters hold).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import NamedTuple, Tuple

import torch

from dexterity_tpu_torch.utils import structs

# torch's profiler-enabled test: true while a torch.profiler session runs.
_profiling = torch._C._autograd._profiler_enabled

# The recorded spans, in start order, each a list
# [name, start_ns, end_ns, depth, parent, counters, index]; end_ns is None
# while the span is open, counters [(name, value, reduce), ...].
_records = []
# The records of the spans open now, innermost last.
_open = []


class Span(NamedTuple):
  """A recorded span.  parent: the index in `records()` of the enclosing
  span, -1 for none; end_ns: None while the span is open; counters:
  ((name, number), ...) in the order they were attached."""
  name: str
  start_ns: int
  end_ns: int
  depth: int
  parent: int
  counters: Tuple[Tuple[str, int], ...]


class _Recording:
  """A span being recorded; `trace_annotation` hands one out only while
  the profiler runs."""
  __slots__ = ('_name', '_rec')

  def __init__(self, name):
    self._name = name

  def __enter__(self):
    parent = _open[-1][6] if _open else -1
    rec = [self._name, time.time_ns(), None, len(_open), parent, [],
           len(_records)]
    _records.append(rec)
    _open.append(rec)
    self._rec = rec
    return self

  def __exit__(self, *exc):
    self._rec[2] = time.time_ns()
    if _open and _open[-1] is self._rec:
      _open.pop()
    return False


# The span of a run that is not profiled: records nothing.
_OFF = contextlib.nullcontext()


def trace_annotation(name: str):
  """A span named `name` over the `with` block, recorded while a
  torch.profiler session runs; `as` gives None when it is not recorded."""
  return _Recording(name) if _profiling() else _OFF


def count(name: str, value, reduce=None) -> None:
  """Attaches a count to the innermost open span: a host integer, or any
  value (a device tensor) with `reduce(value) -> int`, called only when
  the records are read.  Does nothing when no span is open."""
  if _open:
    _open[-1][5].append((name, value, reduce))


def records():
  """The spans recorded since the last clear(), as `Span`s with their
  counters reduced (each reduction runs once; its value is then dropped)."""
  out = []
  for rec in _records:
    counters = rec[5]
    for j, (name, value, reduce) in enumerate(counters):
      if reduce is not None:
        counters[j] = (name, int(reduce(value)), None)
    out.append(Span(rec[0], rec[1], rec[2], rec[3], rec[4],
                    tuple((n, v) for n, v, _ in counters)))
  return out


def clear() -> None:
  """Empties the buffer; spans open now are not recorded when they end."""
  _records.clear()
  _open.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
  """Profiles the block (CPU activity, and the card's where there is one)
  and writes a Chrome trace, `logdir/trace.json`, with the port's spans
  of the block on a track of their own ("program spans") above the
  kernels, on the profiler's clock; each span's counters are its args."""
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(logdir, exist_ok=True)
  t0 = time.time_ns()
  with torch.profiler.profile(activities=activities) as prof:
    yield prof
  path = os.path.join(logdir, 'trace.json')
  prof.export_chrome_trace(path)
  with open(path) as f:
    trace = json.load(f)
  # The trace's times are µs from its base (absolute where it has none).
  base = int(trace.get('baseTimeNanoseconds', 0))
  events = trace.setdefault('traceEvents', [])
  events.append({'ph': 'M', 'name': 'process_name', 'pid': 'program',
                 'args': {'name': 'dexterity_tpu_torch'}})
  for s in records():
    if s.start_ns >= t0 and s.end_ns is not None:
      events.append({'ph': 'X', 'cat': 'program', 'name': s.name,
                     'pid': 'program', 'tid': 'program spans',
                     'ts': (s.start_ns - base) / 1e3,
                     'dur': (s.end_ns - s.start_ns) / 1e3,
                     'args': dict(s.counters)})
  with open(path, 'w') as f:
    json.dump(trace, f)


def assert_finite(tree, name: str = 'state'):
  """Host-side NaN/Inf check over the tensors of `tree` (structs.tree_map's
  order), for debugging; raises FloatingPointError naming the first leaf
  that holds one."""
  for i, leaf in enumerate(structs.tree_leaves(tree)):
    if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
      raise FloatingPointError(
          f'non-finite values in {name}, leaf {i} of shape '
          f'{tuple(leaf.shape)}')
