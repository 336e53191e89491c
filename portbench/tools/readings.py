#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the numbers that decide
`correct` for sound runs of the program over many seeds, and for the
control (the reference in float32 with TF32 products, in the program's
place) and the reference in plain float32 on the first few, all in one
process.  The benchmark's own runs never run the control.

    python3 portbench/tools/readings.py --workload CELL --seeds 12 \
        --controls 3 --first-seed N [--fault NAME] [--out FILE]

Each seed sets the cell up anew, runs --calls timed calls past the
warm-up, and judges the last as a run does.  One JSON line per seed.
With --fault, the program runs with that fault of `tools/faults.py`
planted underneath, and its readings are the fault's.
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import port, runner  # noqa: E402
from tools import faults  # noqa: E402


def readings(cell, seed, controls, device, calls=1):
  import torch
  pkg = port.load()
  if torch.device(device).type == 'cuda':
    port.build_kernels(pkg)
  ctx = runner.Context(torch, pkg, cell, seed, torch.device(device),
                       getattr(torch, cell.config['dtype']))
  t0 = time.perf_counter()
  drv = cell.driver.setup(ctx)
  for _ in range(calls):
    drv.call()
  wall = time.perf_counter() - t0
  drv.release()
  nums, failed = drv.numbers()
  out = {'seed': seed, 'sound': nums, 'failed': failed,
         'setup_and_call_s': wall}
  if controls:
    out['control_tf32'] = drv.control_numbers(tf32=True)
    out['reference_f32'] = drv.control_numbers(tf32=False)
  out['with_checks_s'] = time.perf_counter() - t0
  del drv
  gc.collect()
  if torch.device(device).type == 'cuda':
    torch.cuda.empty_cache()
  return out


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', type=int, default=12)
  parser.add_argument('--controls', type=int, default=3)
  parser.add_argument('--first-seed', type=int, required=True)
  parser.add_argument('--calls', type=int, default=1,
                      help='timed calls past the warm-up; the last is judged')
  parser.add_argument('--fault', choices=sorted(faults.FAULTS))
  parser.add_argument('--out')
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args()
  runner._set_caches()
  cell = runner.load_cell(args.workload)
  if args.fault:
    faults.FAULTS[args.fault](port.load(), cell.driver_name, setattr)
  import torch
  if args.device == 'cuda' and not torch.cuda.is_available():
    print('no CUDA device', file=sys.stderr)
    return 3
  sink = open(args.out, 'a') if args.out else None
  for i in range(args.seeds):
    line = json.dumps({'workload': cell.name, 'fault': args.fault, **readings(
        cell, args.first_seed + 7919 * i, i < args.controls, args.device,
        args.calls)})
    print(line, flush=True)
    if sink:
      sink.write(line + '\n')
      sink.flush()
  return 0


if __name__ == '__main__':
  sys.exit(main())
