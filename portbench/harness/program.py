"""The program's own spans and counters (`dexterity_tpu_torch.utils.
profiling`, recorded while the profiler runs) inside a traced window.

A window's program records are those that lie from the earliest start to
the latest end of the benchmark's depth-0 spans, so the records of a
window that did not stand are left out.  Nothing is read where the
program has no recorder or recorded nothing in the window: the readers
then report nothing.
"""

import importlib

PACKAGE = 'dexterity_tpu_torch'


def records(w):
  """(records, inside): the program's span records (`profiling.records()`,
  counters reduced) and the indices of those inside the window `w`; None
  where there are none."""
  top = [(t0, t1) for _, t0, t1, depth in w.span_records if depth == 0]
  if not top:
    return None
  try:
    profiling = importlib.import_module(PACKAGE + '.utils.profiling')
  except ImportError:
    return None
  read = getattr(profiling, 'records', None)
  if read is None:
    return None
  lo, hi = min(t0 for t0, _ in top), max(t1 for _, t1 in top)
  recs = read()
  inside = [i for i, r in enumerate(recs)
            if r.end_ns is not None and lo <= r.start_ns and r.end_ns <= hi]
  return (recs, inside) if inside else None


def kinematics_ms(w):
  """Host ms per call or step in the kinematics: the `physics.planes`
  spans (the tree sweep's planes: FK, frames, inertias, CRB, RNE) and the
  self time of the `physics.refresh` spans less their
  `collision.narrowphase` children."""
  found = records(w)
  if found is None:
    return None
  recs, inside = found
  ns = 0
  for i in inside:
    r = recs[i]
    if r.name in ('physics.planes', 'physics.refresh'):
      ns += r.end_ns - r.start_ns
    elif (r.name == 'collision.narrowphase' and r.parent >= 0
          and recs[r.parent].name == 'physics.refresh'):
      ns -= r.end_ns - r.start_ns
  return ns / 1e6 / w.calls


def counter_share(w, span, part, whole):
  """100 x the sum of counter `part` over that of `whole`, across the
  window's spans named `span`; None where `whole` sums to 0."""
  found = records(w)
  if found is None:
    return None
  recs, inside = found
  sums = {part: 0, whole: 0}
  for i in inside:
    r = recs[i]
    if r.name == span:
      for name, value in r.counters:
        if name in sums:
          sums[name] += value
  return 100.0 * sums[part] / sums[whole] if sums[whole] else None
