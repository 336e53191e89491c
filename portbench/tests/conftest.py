"""Shared set-up of the benchmark's CPU tests: the benchmark's folder on
the import path, and cells cut to a size the CPU runs in seconds."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
  sys.path.insert(0, BENCH)

# Traffic overrides that make each driver's cell tiny on the CPU.
TINY = {'mpc': dict(streams=2, samples=4, horizon=5, trace_calls=1),
        'suite': dict(batch=4, warm_steps=1, trace_calls=1)}


def tiny_cell(name):
  from harness import runner
  cell = runner.load_cell(name)
  cell.traffic.update(TINY[cell.driver_name])
  return cell


@pytest.fixture(autouse=True)
def _few_threads():
  import torch
  n = torch.get_num_threads()
  torch.set_num_threads(min(n, 4))
  yield
  torch.set_num_threads(n)
