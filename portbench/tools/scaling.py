#!/usr/bin/env python3
"""The stream-scaling check of the planner cell: one warm-up and then one
traced `solve_batch` call at each stream count, in one process: the
call's wall, the device's busy time and idle share, and its launches.

    python3 portbench/tools/scaling.py --workload reorient.mpc.s32 \
        --streams 4,16,32 --seed N
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import port, runner, trace  # noqa: E402


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--workload', default='reorient.mpc.s32')
  parser.add_argument('--streams', default='4,16,32')
  parser.add_argument('--seed', type=int, required=True)
  args = parser.parse_args()
  runner._set_caches()
  import torch
  if not torch.cuda.is_available():
    print('no CUDA device', file=sys.stderr)
    return 3
  pkg = port.load()
  port.build_kernels(pkg)
  for g in (int(s) for s in args.streams.split(',')):
    cell = runner.load_cell(args.workload)
    cell.traffic['streams'] = g
    ctx = runner.Context(torch, pkg, cell, args.seed, torch.device('cuda'),
                         torch.float32)
    drv = cell.driver.setup(ctx)
    spans = trace.Spans()
    window, busy_s, window_s, breakdown = trace.traced_window(
        torch, 1, drv.call, spans, lambda: port.launches(pkg),
        {'name': cell.name}, drv.counters)
    print(json.dumps({
        'streams': g, 'rollouts_per_iteration': g * cell.traffic['samples'],
        'call_wall_s': window_s, 'device_busy_s': busy_s,
        'device_idle_share': 1 - busy_s / window_s,
        'launches': window.records(),
        'device_ops': breakdown['device_ops'][:5],
        'memory_peak_bytes': torch.cuda.max_memory_allocated(),
        'device': runner._power_limit()}), flush=True)
    del drv
    torch.cuda.empty_cache()
  return 0


if __name__ == '__main__':
  sys.exit(main())
