"""One run of one cell: set-up, the measured or traced window, the check
of what the window produced, and the result line.

The cell `workloads/<cell>.json` names its configuration
(`configs/<config>.json`) and traffic mix (`traffic/<traffic>.json`); the
traffic names its driver (`drivers/<driver>.py`), which builds the
program's model and traffic from the seed, runs whole calls, and judges
them against the reference.  The per-layer readers are the files of
`metrics/`, each declaring the drivers it reads.
"""

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import resource
import statistics
import subprocess
import sys
import time

from harness import port, trace

BENCH = port.BENCH
# Top-level module names that no run may hold: JAX and the JAX package.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'dexterity_tpu')


def _json(*parts):
  with open(os.path.join(BENCH, *parts)) as f:
    return json.load(f)


def _module(path, name):
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@dataclasses.dataclass
class Cell:
  name: str
  workload: dict
  config: dict
  traffic: dict
  driver_name: str
  driver: object


def load_cell(name):
  """The cell's files, found by its name."""
  workload = _json('workloads', name + '.json')
  config = _json('configs', workload['config'] + '.json')
  traffic = _json('traffic', workload['traffic'] + '.json')
  driver_name = traffic['driver']
  driver = _module(os.path.join(BENCH, 'drivers', driver_name + '.py'),
                   'portbench_driver_' + driver_name)
  return Cell(name, workload, config, traffic, driver_name, driver)


def readers(driver_name):
  """The per-layer readers that read this driver's windows, by name."""
  out = {}
  folder = os.path.join(BENCH, 'metrics')
  for fname in sorted(os.listdir(folder)):
    if not fname.endswith('.py'):
      continue
    name = fname[:-3]
    mod = _module(os.path.join(folder, fname),
                  'portbench_metric_' + name.replace('.', '_'))
    if driver_name in mod.DRIVERS:
      out[name] = mod
  return out


def forbidden_modules():
  return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def seeds(seed, n):
  """n seeds for the run's generators, drawn from --seed (any whole
  number; the same seed gives the same ones)."""
  import numpy as np
  return [int(s) for s in np.random.SeedSequence(
      abs(int(seed)), spawn_key=(int(seed < 0),)).generate_state(n, np.uint64)
          % (2 ** 63)]


@dataclasses.dataclass
class Context:
  """What a driver's set-up takes."""
  torch: object
  pkg: dict
  cell: Cell
  seed: int
  device: object
  dtype: object

  def seeds(self, n):
    return seeds(self.seed, n)


def _power_limit():
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()
    return out[0] if out else 'not read'
  except (OSError, subprocess.SubprocessError):
    return 'not read'


def _set_caches():
  """Every build and kernel cache at a fixed path inside the checkout."""
  cache = os.path.join(port.ROOT, 'build', 'portbench')
  for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                   ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('CUDA_CACHE_PATH', 'nv_compute')):
    os.environ[var] = os.path.join(cache, sub)
  os.environ['USE_FLAX'] = '0'
  os.environ['USE_JAX'] = '0'


class HostNote:
  """What the host did over the window, for a line on standard error:
  the calls' walls, this process's CPU seconds over the window's, and
  the collector's passes and seconds."""

  def __init__(self):
    self.gc_s = 0.0
    self._gc_t0 = None
    gc.callbacks.append(self._gc)
    self.t0 = self._now()

  def _gc(self, phase, info):
    del info
    if phase == 'start':
      self._gc_t0 = time.perf_counter()
    elif self._gc_t0 is not None:
      self.gc_s += time.perf_counter() - self._gc_t0

  @staticmethod
  def _now():
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {'wall': time.perf_counter(), 'proc_s': ru.ru_utime + ru.ru_stime,
            'gc': sum(g['collections'] for g in gc.get_stats())}

  def close(self, call_walls):
    gc.callbacks.remove(self._gc)
    t1, t0 = self._now(), self.t0
    return {'calls': len(call_walls),
            'call_s': [min(call_walls), statistics.median(call_walls),
                       max(call_walls)],
            'proc_cpu_share': ((t1['proc_s'] - t0['proc_s'])
                               / (t1['wall'] - t0['wall'])),
            'gc_passes': t1['gc'] - t0['gc'], 'gc_s': self.gc_s}


def run_cell(cell, seed, seconds, traced, start, device='cuda', dtype=None):
  """Set-up, window and check of one cell; returns the result line.
  device='cpu' drives the same run on the CPU (for the tests: no device
  number is read there)."""
  import torch
  dtype = dtype or getattr(torch, cell.config['dtype'])
  on_card = torch.device(device).type == 'cuda'
  pkg = port.load()
  if on_card:
    port.build_kernels(pkg)
  ctx = Context(torch, pkg, cell, seed, torch.device(device), dtype)
  drv = cell.driver.setup(ctx)
  if on_card:
    torch.cuda.synchronize()
  # The collector skips set-up's objects until the window has closed.
  gc.collect()
  gc.freeze()
  setup_s = time.perf_counter() - start
  metrics, device_info, breakdown = {}, {}, None
  if traced:
    spans = trace.Spans()
    with trace.wrapped(spans, drv.span_targets()):
      window, busy_s, window_s, breakdown = trace.traced_window(
          torch, cell.traffic['trace_calls'], drv.call, spans,
          lambda: port.launches(pkg),
          {'name': cell.name, 'config': cell.config,
           'traffic': cell.traffic, 'driver': cell.driver_name},
          drv.counters)
    for name, mod in readers(cell.driver_name).items():
      value = mod.read(window)
      if value is not None:
        metrics[name] = {'value': value, 'unit': mod.UNIT}
    device_info.update(busy_s=busy_s, window_s=window_s)
    attempted = drv.units * window.calls
  else:
    host = HostNote()
    walls = []
    t0 = last = time.perf_counter()
    while last - t0 < seconds:
      drv.call()
      now = time.perf_counter()
      walls.append(now - last)
      last = now
    elapsed, calls = last - t0, len(walls)
    print(f'window: {json.dumps(host.close(walls))}', file=sys.stderr)
    metrics[drv.rate_name] = {'value': drv.units * calls / elapsed,
                              'unit': drv.rate_unit}
    metrics['setup_s'] = {'value': setup_s, 'unit': 's'}
    attempted = drv.units * calls
  gc.unfreeze()
  peak = torch.cuda.max_memory_allocated() if on_card else 0
  drv.release()
  nums, failed = drv.numbers()
  checks = {k: (nums[k], lim)
            for k, lim in cell.workload['limits'].items()}
  result = {
      'correct': all(v <= lim for v, lim in checks.values()),
      'attempted': attempted, 'failed': failed, 'metrics': metrics,
      'device': {'platform': 'gpu' if on_card else 'cpu',
                 'kind': (torch.cuda.get_device_name(0) if on_card
                          else 'cpu'),
                 'count': 1, 'memory_peak_bytes': peak, **device_info,
                 'name_and_power_limit': (_power_limit() if on_card
                                          else 'not read')}}
  if breakdown is not None:
    result['breakdown'] = breakdown
  result['checks'] = {k: {'value': v, 'limit': lim}
                      for k, (v, lim) in checks.items()}
  return result


def main(argv, start):
  parser = argparse.ArgumentParser(description='One run of one cell.')
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)
  _set_caches()
  cell = load_cell(args.workload)
  import torch
  chips = cell.workload.get('chips', 1)
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f'no result: the cell needs {chips} CUDA device(s); this machine '
          f'has {have}', file=sys.stderr)
    return 3
  try:
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), start)
  except port.Missing as e:
    print(f'no result: {e}', file=sys.stderr)
    return 2
  bad = forbidden_modules()
  if bad:
    print(f'no result: the run loaded {bad}', file=sys.stderr)
    return 4
  print(f'device: {result["device"]["name_and_power_limit"]}',
        file=sys.stderr)
  for k, c in result['checks'].items():
    print(f'check {k}: {c["value"]!r} (limit {c["limit"]!r})',
          file=sys.stderr)
  print(json.dumps(result), flush=True)
  return 0
