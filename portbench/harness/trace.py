"""The traced window: host spans that the benchmark places around calls
into the program's layers, the device's kernel records from
torch.profiler, and their reduction to what the per-layer readers take.

Spans wrap module or object attributes for the traced window only and
stamp the host's wall clock (`time.time_ns`), the clock the profiler's
records carry, so an idle stretch of the device can be named by the
innermost span the host was in.  The profiler traces CUDA activity only:
a planner call launches some 300,000 kernels, and the host's own
operations would multiply the records.

The profiler drops kernel records on the H100, mostly the first ones of
a window, and more as a process goes on.  So a window opens with spin
kernels (left out of every sum), and stands only where it holds a record
of every launch that the program's counters saw for the kernels they
count; a window that does not stand is run again with twice the spins,
up to five times, and never reported short.
"""

import contextlib
import time

SPIN_PREROLL = 64
SPIN = 'spin_kernel'
# The kernels whose launches the program counts (linalg_cuda.launches,
# tree_cuda.launches), by a part of their names.
COUNTED_KERNELS = ('cholesky_kernel', 'cholesky_regs_', 'cholesky_wide_',
                   'tree_fk_kernel', 'tree_dyn_kernel')
CHOLESKY_KERNELS = ('cholesky_kernel', 'cholesky_regs_', 'cholesky_wide_')
OUTSIDE = 'driver'     # an idle stretch while the host was in no span
NAME_CHARS = 160       # of a kernel's name in the breakdown


class Spans:
  """Host spans around attributes, recorded while `active`."""

  def __init__(self):
    self.active = False
    self.records = []          # (name, start_ns, end_ns, depth)
    self._depth = 0
    self._saved = []

  def wrap(self, owner, attr, name):
    orig = getattr(owner, attr)
    spans = self

    def wrapped(*args, **kwargs):
      if not spans.active:
        return orig(*args, **kwargs)
      depth = spans._depth
      spans._depth += 1
      t0 = time.time_ns()
      try:
        return orig(*args, **kwargs)
      finally:
        spans._depth = depth
        spans.records.append((name, t0, time.time_ns(), depth))

    self._saved.append((owner, attr, orig))
    setattr(owner, attr, wrapped)

  def unwrap(self):
    for owner, attr, orig in reversed(self._saved):
      setattr(owner, attr, orig)
    self._saved.clear()


def _start_ns(e):
  return e.start_ns() if hasattr(e, 'start_ns') else e.start_us() * 1000


def _duration_ns(e):
  return (e.duration_ns() if hasattr(e, 'duration_ns')
          else e.duration_us() * 1000)


def kernel_records(prof):
  """(name, start_ns, end_ns) of every CUDA kernel record of a profile."""
  from torch.autograd import DeviceType
  out = []
  for e in prof.profiler.kineto_results.events():
    if e.device_type() != DeviceType.CUDA:
      continue
    s = _start_ns(e)
    out.append((e.name(), s, s + _duration_ns(e)))
  return out


def union(intervals, lo, hi):
  """Merged (start, end) intervals clipped to [lo, hi], sorted."""
  out = []
  for s, e in sorted(intervals):
    s, e = max(s, lo), min(e, hi)
    if e <= s:
      continue
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return out


def gaps(merged, lo, hi):
  """The idle stretches of [lo, hi] between merged busy intervals."""
  out, at = [], lo
  for s, e in merged:
    if s > at:
      out.append((at, s))
    at = max(at, e)
  if hi > at:
    out.append((at, hi))
  return out


def name_gaps(idle, span_records):
  """{span name: idle seconds}: each idle stretch charged to the innermost
  span the host was in at its middle (OUTSIDE where it was in none)."""
  spans = sorted(span_records, key=lambda r: r[1])
  out = {}
  for s, e in idle:
    mid = (s + e) / 2
    best, depth = OUTSIDE, -1
    for name, t0, t1, d in spans:
      if t0 > mid:
        break
      if t1 >= mid and d > depth:
        best, depth = name, d
    out[best] = out.get(best, 0.0) + (e - s) / 1e9
  return out


class Window:
  """What the per-layer readers take from one traced window."""

  def __init__(self, cell, calls, wall_s, kernels, span_records, counters):
    self.cell = cell                # {'config', 'traffic', 'driver', ...}
    self.calls = calls              # whole calls or steps in the window
    self.wall_s = wall_s            # host wall from first call to last sync
    self.span_records = span_records
    self.counters = counters        # the benchmark's own counts
    self.kernels = [k for k in kernels if SPIN not in k[0]]
    self.by_name = {}
    for name, s, e in self.kernels:
      tot = self.by_name.setdefault(name, [0, 0.0])
      tot[0] += 1
      tot[1] += (e - s) / 1e9

  def spans(self):
    return _totals(self.span_records)

  def device_s(self, parts):
    """Device seconds of the kernel records whose names hold a part."""
    return sum(t for n, (_, t) in self.by_name.items()
               if any(p in n for p in parts))

  def records(self):
    """Kernel records (spins left out)."""
    return sum(c for c, _ in self.by_name.values())

  def busy(self, lo, hi):
    """Merged busy intervals of the window's kernels within [lo, hi]."""
    return union(((s, e) for _, s, e in self.kernels), lo, hi)


def _totals(records):
  out = {}
  for name, t0, t1, _ in records:
    tot = out.setdefault(name, [0, 0.0])
    tot[0] += 1
    tot[1] += (t1 - t0) / 1e9
  return out


def traced_window(torch, calls, run_call, spans, launch_counts, cell,
                  counters_fn):
  """Runs `calls` whole calls under the profiler (CUDA activity) with the
  spans active, until a window stands.  Returns (Window, busy_s,
  window_s, breakdown)."""
  from torch.profiler import ProfilerActivity, profile
  not_standing = []
  for attempt in range(5):
    spins = SPIN_PREROLL << attempt
    spans.records.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(spins):
        torch.cuda._sleep(100)
      torch.cuda.synchronize()
      t_sync = time.time_ns()
      before = launch_counts()
      c0 = counters_fn()
      spans.active = True
      lo = time.time_ns()
      for _ in range(calls):
        run_call()
      torch.cuda.synchronize()
      hi = time.time_ns()
      spans.active = False
    after = launch_counts()
    launched = {k: after[k] - before.get(k, 0) for k in after}
    recs = kernel_records(prof)
    spin_ends = [e for n, _, e in recs if SPIN in n]
    counted = sum(1 for n, _, _ in recs
                  if any(p in n for p in COUNTED_KERNELS))
    want = sum(launched.values())
    busy_any = any(SPIN not in n for n, _, _ in recs)
    if busy_any and (counted == want if want else spin_ends):
      skew = t_sync - max(spin_ends) if spin_ends else 0
      # The records carry the host's wall clock; a host clock that moved
      # against it by more than 50 ms is corrected by the last spin's end.
      if abs(skew) > 50_000_000:
        recs = [(n, s + skew, e + skew) for n, s, e in recs]
      c1 = counters_fn()
      window = Window(cell, calls, (hi - lo) / 1e9, recs,
                      list(spans.records),
                      {k: c1[k] - c0.get(k, 0) for k in c1})
      merged = window.busy(lo, hi)
      busy_s = sum(e - s for s, e in merged) / 1e9
      idle = name_gaps(gaps(merged, lo, hi), window.span_records)
      top_ops = sorted(window.by_name.items(), key=lambda kv: -kv[1][1])
      breakdown = {
          'device_ops': [[n[:NAME_CHARS], t] for n, (_, t) in top_ops[:10]],
          'idle_gaps': sorted(([n, t] for n, t in idle.items()),
                              key=lambda x: -x[1])[:10]}
      window.busy_s = busy_s
      return window, busy_s, (hi - lo) / 1e9, breakdown
    not_standing.append({'spins': spins, 'spins_seen': len(spin_ends),
                         'counted_records': counted, 'launches': want})
  raise RuntimeError(f'no traced window stood in five: {not_standing}')


@contextlib.contextmanager
def wrapped(spans, targets):
  """Places the spans on (owner, attr, name) targets for the block."""
  for owner, attr, name in targets:
    spans.wrap(owner, attr, name)
  try:
    yield spans
  finally:
    spans.unwrap()
