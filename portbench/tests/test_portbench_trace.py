"""The traced window's reduction: busy intervals, idle stretches named by
the host's innermost span, and the per-layer readers over a window built
by hand."""

import json
import os

import pytest
from conftest import BENCH

from harness import runner, trace


def _json(*parts):
  with open(os.path.join(BENCH, *parts)) as f:
    return json.load(f)


def test_union_gaps_and_names():
  busy = trace.union([(100, 200), (150, 300), (400, 500), (0, 50)], 100, 600)
  assert busy == [[100, 300], [400, 500]]
  idle = trace.gaps(busy, 100, 600)
  assert idle == [(300, 400), (500, 600)]
  spans = [('env.step', 90, 600, 0), ('constraint.solve', 320, 480, 1)]
  assert trace.name_gaps(idle, spans) == {'constraint.solve': 1e-7,
                                          'env.step': 1e-7}
  assert trace.name_gaps([(700, 800)], spans) == {trace.OUTSIDE: 1e-7}


def _window(driver, config, traffic, counters):
  cell = {'config': _json('configs', config + '.json'),
          'traffic': _json('traffic', traffic + '.json'), 'driver': driver}
  kernels = [('cholesky_regs_solve', 0, 1000), ('elementwise', 1000, 3000),
             (trace.SPIN, 0, 10)]
  spans = [('planner.solve_batch', 0, 4000, 0),
           ('planner.rollout_returns_flat', 0, 3000, 1),
           ('env.merge_resets', 0, 500, 1),
           ('collision.collide_group_planes', 100, 600, 2),
           ('constraint.solve', 700, 900, 2)]
  w = trace.Window(cell, 2, 4e-6, kernels, spans, counters)
  w.busy_s = 3e-6
  return w


def test_planner_readers():
  w = _window('mpc', 'shadowhand_reorient', 'mpc.s32', {})
  got = {n: m.read(w) for n, m in runner.readers('mpc').items()}
  assert got['rollout_share.mpc'] == pytest.approx(75.0)
  assert got['narrowphase_ms.mpc'] == pytest.approx(0.5e-3 / 2)
  assert got['constraint_ms.mpc'] == pytest.approx(0.2e-3 / 2)
  assert got['launches.mpc'] == 1.0
  assert got['device_idle.mpc'] == pytest.approx(25.0)
  assert got['chol_roofline.mpc'] > 0


def test_suite_readers_leave_out_what_they_cannot_read():
  w = _window('suite', 'mpl_juggle', 'suite.b16384', {'rows_reset': 0})
  got = {n: m.read(w) for n, m in runner.readers('suite').items()}
  assert got['reset_ms.env'] is None
  w.counters['rows_reset'] = 5
  assert runner.readers('suite')['reset_ms.env'].read(w) == pytest.approx(
      0.5e-3 / 2)
  w.kernels, w.by_name = [], {}
  assert runner.readers('suite')['chol_roofline.env'].read(w) is None
