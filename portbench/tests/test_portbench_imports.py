"""Nothing that a run loads is JAX or the JAX package, compared by whole
top-level module names; the reference loads nothing of the program."""

import os
import subprocess
import sys

from conftest import BENCH

from harness import runner

_RUN = (
    'import sys, time; sys.path.insert(0, sys.argv[1]);'
    'import torch; torch.set_num_threads(2);'
    'sys.path.insert(0, sys.argv[1] + "/tests");'
    'from conftest import tiny_cell; from harness import runner;'
    'runner.run_cell(tiny_cell(sys.argv[2]), 5, 0.1, False,'
    ' time.perf_counter(), device="cpu");'
    'print(sorted({m.split(".")[0] for m in sys.modules}))')


def _top_level(code, *args):
  out = subprocess.run([sys.executable, '-c', code, *args],
                       capture_output=True, text=True, timeout=600)
  assert out.returncode == 0, out.stderr[-3000:]
  return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
  names = _top_level(_RUN, BENCH, 'juggle.suite.b16384')
  assert 'dexterity_tpu_torch' in names
  assert not names & set(runner.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
  code = ('import sys; sys.path.insert(0, sys.argv[1]);'
          'from reference import planning, stepping, convert, precision;'
          'from reference.dex import manipulation;'
          'manipulation.load("juggle", "state_sparse", device="cpu");'
          'print(sorted({m.split(".")[0] for m in sys.modules}))')
  names = _top_level(code, BENCH)
  assert not names & (set(runner.FORBIDDEN) | {'dexterity_tpu_torch'})


def test_the_check_compares_whole_top_level_names(monkeypatch):
  monkeypatch.setitem(sys.modules, 'dexterity_tpu_torch_extra', sys)
  assert 'dexterity_tpu_torch_extra' not in runner.forbidden_modules()
  monkeypatch.setitem(sys.modules, 'dexterity_tpu.physics', sys)
  assert runner.forbidden_modules() == ['dexterity_tpu']


def test_no_benchmark_source_imports_jax():
  for folder, _, files in os.walk(BENCH):
    for f in files:
      if f.endswith('.py') and not f.startswith('test_'):
        text = open(os.path.join(folder, f)).read()
        for line in text.splitlines():
          words = line.split()
          if words[:1] in (['import'], ['from']) and len(words) > 1:
            assert words[1].split('.')[0] not in runner.FORBIDDEN, (f, line)
