"""The readers of the program's own spans and counters (`harness.program`
and the six `metrics/` files that use it), on hand-built windows whose
benchmark spans bracket real program records from a CPU run."""

import importlib
import time

import pytest

from harness import port, runner, trace

_B = 4
_READERS = {
    'suite': ('kinematics_ms.env', 'contacts_live.env', 'newton_live.env'),
    'mpc': ('kinematics_ms.mpc', 'contacts_live.mpc', 'newton_live.mpc')}


@pytest.fixture(scope='module')
def pkg():
  return port.load()


def _profiling():
  return importlib.import_module(port.PACKAGE + '.utils.profiling')


def _traced(fn):
  """(t0, t1): fn() under a CPU profiler session, bracketed by the clock."""
  from torch.profiler import ProfilerActivity, profile
  t0 = time.time_ns()
  with profile(activities=[ProfilerActivity.CPU]):
    fn()
  return t0, time.time_ns()


@pytest.fixture(scope='module')
def suite_calls(pkg):
  """Two traced reorient steps at B = 4 after the cubes landed: the
  program's records and the brackets of each step."""
  import torch
  prof = _profiling()
  env = pkg['manipulation'].load('reorient', 'state_dense', device='cpu',
                                 dtype=torch.float64)
  benv = pkg['batched'].BatchedEnvironment(env, _B)
  gen = torch.Generator().manual_seed(3)
  state, _ = benv.reset(gen)
  action = torch.zeros(_B, env.action_spec().shape[0], dtype=torch.float64)
  for _ in range(3):
    state, _ = benv.step(state, action, gen)
  brackets = [_traced(lambda: benv.step(state, action, gen))
              for _ in range(2)]
  return prof.records(), brackets


@pytest.fixture(scope='module')
def mpc_call(pkg):
  import torch
  prof = _profiling()
  ps = pkg['ps']
  task = pkg['manipulation'].build_task('reorient', 'state_dense')
  pp = ps.PredictiveSampling(task, ps.PredictiveSamplingConfig(
      horizon=2, num_samples=4), device='cpu', dtype=torch.float64)
  env = pkg['manipulation'].load('reorient', 'state_dense', device='cpu',
                                 dtype=torch.float64)
  state, _ = env.reset(torch.Generator().manual_seed(4), (2,))
  bracket = _traced(lambda: pp.solve_batch(
      state.data, state.task.goal, pp.init_state(streams=2),
      torch.Generator().manual_seed(5)))
  return prof.records(), [bracket]


def _window(brackets, name):
  spans = [(name, t0, t1, 0) for t0, t1 in brackets]
  return trace.Window({}, len(brackets), 1.0, [], spans, {})


def _by_hand(recs, lo, hi):
  """The three readings from the records inside [lo, hi], summed here."""
  inside = [r for r in recs if lo <= r.start_ns and r.end_ns <= hi]
  kin = 0
  sums = {'live': 0, 'slots': 0, 'moved': 0, 'row_iters': 0}
  for r in inside:
    dur = r.end_ns - r.start_ns
    if r.name in ('physics.planes', 'physics.refresh'):
      kin += dur
    if r.name == 'collision.narrowphase' and \
        recs[r.parent].name == 'physics.refresh':
      kin -= dur
    for n, v in r.counters:
      if n in sums:
        sums[n] += v
  return (kin / 1e6, 100 * sums['live'] / sums['slots'],
          100 * sums['moved'] / sums['row_iters'])


@pytest.mark.parametrize('driver', ['suite', 'mpc'])
def test_readers_read_the_program_records_of_the_window(
    driver, suite_calls, mpc_call):
  recs, brackets = suite_calls if driver == 'suite' else mpc_call
  root = ('env.step_with_metrics' if driver == 'suite'
          else 'planner.solve_batch')
  w = _window(brackets, root)
  readers = runner.readers(driver)
  got = [readers[n].read(w) for n in _READERS[driver]]
  kin, live, moved = _by_hand(recs, brackets[0][0], brackets[-1][1])
  assert got[0] == pytest.approx(kin / len(brackets))
  assert got[1] == pytest.approx(live) and 0 < got[1] <= 100
  assert got[2] == pytest.approx(moved) and 0 < got[2] <= 100
  assert got[0] > 0


def test_records_outside_the_window_are_left_out(suite_calls):
  recs, brackets = suite_calls
  readers = runner.readers('suite')
  first = _window(brackets[:1], 'env.step_with_metrics')
  got = [readers[n].read(first) for n in _READERS['suite']]
  kin, live, moved = _by_hand(recs, *brackets[0])
  assert got == pytest.approx([kin, live, moved])
  both = _window(brackets, 'env.step_with_metrics')
  assert readers['kinematics_ms.env'].read(both) != pytest.approx(got[0])
  # A window that holds no program record, and a window with no
  # benchmark span, read nothing.
  t = brackets[-1][1] + 1
  for w in (_window([(t, t + 10)], 'env.step_with_metrics'),
            _window([], 'env.step_with_metrics')):
    assert all(readers[n].read(w) is None for n in _READERS['suite'])


def test_readers_read_nothing_from_a_program_without_the_recorder(
    suite_calls, monkeypatch):
  _, brackets = suite_calls
  prof = _profiling()
  monkeypatch.delattr(prof, 'records')
  w = _window(brackets, 'env.step_with_metrics')
  readers = runner.readers('suite')
  assert all(readers[n].read(w) is None for n in _READERS['suite'])
