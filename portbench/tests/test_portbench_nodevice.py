"""A measured run never falls back to the CPU: without a CUDA device, or
without the program beside the benchmark, it exits non-zero and prints
no result."""

import os
import shutil
import subprocess
import sys
import time

import pytest
from conftest import BENCH, tiny_cell

from harness import port, runner

ROOT = os.path.dirname(BENCH)


def _run(cwd, env=None):
  return subprocess.run(
      [sys.executable, 'portbench/run.py', '--workload', 'juggle.suite.b16384',
       '--seed', str(2 ** 31 + 9), '--seconds', '1', '--trace', '0'],
      cwd=cwd, capture_output=True, text=True, timeout=300,
      env={**os.environ, **(env or {})})


def test_no_card_no_result():
  out = _run(ROOT, {'CUDA_VISIBLE_DEVICES': ''})
  assert out.returncode != 0
  assert out.stdout.strip() == ''


def test_benchmark_alone_no_result(tmp_path):
  shutil.copytree(BENCH, tmp_path / 'portbench',
                  ignore=shutil.ignore_patterns('__pycache__'))
  shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
  out = _run(tmp_path, {'CUDA_VISIBLE_DEVICES': ''})
  assert out.returncode != 0
  assert out.stdout.strip() == ''


def test_without_the_program_the_run_stops(monkeypatch, tmp_path):
  monkeypatch.setattr(port, 'ROOT', str(tmp_path))
  with pytest.raises(port.Missing):
    runner.run_cell(tiny_cell('juggle.suite.b16384'), 1, 0.1, False,
                    time.perf_counter(), device='cpu')


@pytest.mark.cuda
def test_a_short_run_on_the_card():
  import torch
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  out = _run(ROOT)
  assert out.returncode == 0, out.stderr[-3000:]
  assert '"correct": true' in out.stdout.splitlines()[-1]
