#!/usr/bin/env python3
"""One traced run of a cell, as `run.py --trace 1` makes it, with the
device's idle stretches of its window charged to the program's own spans
(`dexterity_tpu_torch.utils.profiling`) beside the benchmark's, by the
same rule (`trace.name_gaps`: the innermost span the host was in at the
stretch's middle), and what the program's counters say per Newton
iteration and per narrow-phase call.

    python3 portbench/tools/program_gaps.py --workload CELL --seed N

Prints one JSON line: the run's result (metrics, device, breakdown,
correct), the idle seconds by program span, the share of idle seconds
that fall inside a program span, the moved share of each Newton
iteration (by its index in the solve) and the live share of the narrow
phase's slots in the constraint solves.
"""

import argparse
import json
import os
import sys
import time

START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import program, runner, trace  # noqa: E402


def newton_by_iteration(recs, inside):
  """[moved share %, ...] of each Newton iteration index over the
  window's solves."""
  moved, rows = [], []
  for i in inside:
    r = recs[i]
    if r.name != 'constraint.newton':
      continue
    it = 0
    for name, value in r.counters:
      if name == 'row_iters':
        if it == len(rows):
          rows.append(0)
          moved.append(0)
        rows[it] += value
      elif name == 'moved':
        moved[it] += value
        it += 1
  return [100.0 * m / n if n else None for m, n in zip(moved, rows)]


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  args = parser.parse_args()
  runner._set_caches()
  import torch
  if not torch.cuda.is_available():
    print('no CUDA device', file=sys.stderr)
    return 3
  seen = {}
  name_gaps = trace.name_gaps

  def capture(idle, span_records):
    seen['idle'], seen['spans'] = list(idle), list(span_records)
    return name_gaps(idle, span_records)

  trace.name_gaps = capture
  cell = runner.load_cell(args.workload)
  result = runner.run_cell(cell, args.seed, 0.0, True, START)
  out = {'workload': args.workload, 'seed': args.seed, 'result': result}
  window = trace.Window(None, cell.traffic['trace_calls'], 0.0, [],
                        seen['spans'], {})
  found = program.records(window)
  if found is None:
    out['program'] = None
  else:
    recs, inside = found
    spans = [(recs[i].name, recs[i].start_ns, recs[i].end_ns,
              recs[i].depth) for i in inside]
    charged = name_gaps(seen['idle'], spans)
    idle_s = sum(e - s for s, e in seen['idle']) / 1e9
    names = {}
    for name, *_ in spans:
      names[name] = names.get(name, 0) + 1
    out['program'] = {
        'idle_s': idle_s,
        'idle_by_span': sorted(([n, t] for n, t in charged.items()),
                               key=lambda x: -x[1]),
        'inside_share': 1.0 - charged.get(trace.OUTSIDE, 0.0) / idle_s,
        'spans': names,
        'newton_moved_by_iteration': newton_by_iteration(recs, inside),
        'contacts_live': program.counter_share(
            window, 'constraint.assemble', 'live', 'slots')}
  print(json.dumps(out), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
