"""The benchmark's files are found by name, and BENCHMARK.json keeps to
the names, units and lists the harness reads."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, tiny_cell

from harness import runner

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def _bench():
  with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
    return json.load(f)


def test_names_and_units_use_allowed_characters():
  b = _bench()
  for entry in b['configs'] + b['workloads'] + b['end_to_end'] + b['per_layer']:
    assert NAME.match(entry['name']), entry['name']
  for m in b['end_to_end'] + b['per_layer']:
    assert UNIT.match(m['unit']), m['unit']
    assert m['better'] in ('lower', 'higher')
  for w in b['workloads']:
    assert NAME.match(w['config']) and NAME.match(w['traffic'])
  for c in b['configs']:
    assert all(NAME.match(k) for k in c['reduced'])


def test_every_cell_config_traffic_and_driver_is_found_by_name():
  b = _bench()
  for w in b['workloads']:
    cell = runner.load_cell(w['name'])
    assert cell.workload['config'] == w['config']
    assert cell.workload['traffic'] == w['traffic']
    assert cell.config['name'] == w['config']
    assert hasattr(cell.driver, 'setup')
    assert set(cell.workload['limits']), w['name']
  for c in b['configs']:
    path = os.path.join(ROOT, c['file'])
    with open(path) as f:
      assert json.load(f)['source'] == c['source']


def test_per_layer_metrics_match_their_readers():
  b = _bench()
  drivers = {w['name']: runner.load_cell(w['name']).driver_name
             for w in b['workloads']}
  e2e = {m['name'] for m in b['end_to_end']}
  names = set()
  for m in b['per_layer']:
    names.add(m['name'])
    mod = runner.readers(drivers[m['workloads'][0]])[m['name']]
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m['layer'], m['unit'],
                                                m['moves'])
    assert m['moves'] in e2e
    assert all(drivers[w] in mod.DRIVERS for w in m['workloads'])
  files = {f[:-3] for f in os.listdir(os.path.join(BENCH, 'metrics'))
           if f.endswith('.py')}
  assert files == names


def test_a_dummy_workload_runs_through_the_harness(tmp_path):
  """A cell added as data alone (a workload and a traffic file) runs with
  no other file edited."""
  copy = tmp_path / 'portbench'
  shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns('__pycache__'))
  with open(copy / 'traffic' / 'suite.b4.json', 'w') as f:
    json.dump({'name': 'suite.b4', 'driver': 'suite', 'batch': 4,
               'warm_steps': 1, 'trace_calls': 1}, f)
  with open(copy / 'workloads' / 'reorient.suite.b4.json', 'w') as f:
    json.dump({'name': 'reorient.suite.b4', 'config': 'shadowhand_reorient',
               'traffic': 'suite.b4', 'chips': 1,
               'limits': {'qpos_p99': 1.0}}, f)
  code = (
      'import sys, json, time; sys.path.insert(0, sys.argv[1]);'
      'import torch; torch.set_num_threads(2);'
      'from harness import port, runner;'
      f'port.ROOT = {ROOT!r};'
      'cell = runner.load_cell("reorient.suite.b4");'
      'r = runner.run_cell(cell, 2**40 + 3, 0.5, False, time.perf_counter(),'
      ' device="cpu");'
      'print(json.dumps(r))')
  out = subprocess.run([sys.executable, '-c', code, str(copy)],
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr[-3000:]
  result = json.loads(out.stdout.strip().splitlines()[-1])
  assert result['correct'] is True
  assert list(result)[-1] == 'checks'
  assert result['metrics']['env_steps_per_s']['value'] > 0


@pytest.mark.parametrize('name', ['reorient.mpc.s32', 'juggle.suite.b16384'])
def test_a_cpu_run_reports_its_metrics_and_checks(name):
  import time
  cell = tiny_cell(name)
  r = runner.run_cell(cell, 2**33 + 17, 0.2, False, time.perf_counter(),
                      device='cpu')
  assert r['correct'] is True, r['checks']
  assert set(r['metrics']) == {cell.driver.RATE[0], 'setup_s'}
  assert set(r['checks']) == set(cell.workload['limits'])
