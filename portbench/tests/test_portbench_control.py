"""The comparison that decides `correct` fails what it has to, at a size
a CPU test run holds: the control (the reference in float32 with TF32
products, in the program's place), and the program with each fault a
cell can have planted underneath a whole run.  The cells run on one
chip, so no exchange between chips can be left out."""

import time

import pytest
import torch
from conftest import tiny_cell

from harness import port, runner
from tools import faults

CELLS = ['reorient.mpc.s32', 'juggle.suite.b16384', 'reorient.suite.b16384']


def _over(nums, limits):
  return {k: nums[k] for k, lim in limits.items() if not nums[k] <= lim}


@pytest.mark.parametrize('name', CELLS)
def test_the_control_is_not_correct(name):
  cell = tiny_cell(name)
  ctx = runner.Context(torch, port.load(), cell, 2 ** 35 + 1,
                       torch.device('cpu'), torch.float32)
  drv = cell.driver.setup(ctx)
  drv.call()
  drv.release()
  assert not _over(drv.numbers()[0], cell.workload['limits'])
  assert _over(drv.control_numbers(tf32=True), cell.workload['limits'])


def _run_with(name, fault, monkeypatch):
  cell = tiny_cell(name)
  faults.FAULTS[fault](port.load(), cell.driver_name, monkeypatch.setattr)
  return runner.run_cell(cell, 2 ** 36 + 5, 0.1, False, time.perf_counter(),
                         device='cpu')


@pytest.mark.parametrize('fault', ['unchanged', 'half_batch', 'altered'])
@pytest.mark.parametrize('name', CELLS)
def test_a_fault_is_not_correct(name, fault, monkeypatch):
  assert _run_with(name, fault, monkeypatch)['correct'] is False


@pytest.mark.parametrize('name', CELLS[1:])
def test_a_termination_fault_is_not_correct(name, monkeypatch):
  r = _run_with(name, 'first_flipped', monkeypatch)
  assert r['correct'] is False
  assert r['checks']['flag_share']['value'] > 0
