"""The port's own spans and counters (utils/profiling.py) on the CPU: the
span tree of a batched reorient step and of a planner solve under a
torch.profiler session, nothing recorded without one, the counters
against recounts, and the device trace's program track."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dexterity_tpu_torch import manipulation
from dexterity_tpu_torch.envs import batched
from dexterity_tpu_torch.physics import step as physics_step
from dexterity_tpu_torch.physics.collision import primitives
from dexterity_tpu_torch.planners import predictive_sampling as ps
from dexterity_tpu_torch.utils import profiling

F64 = dict(device='cpu', dtype=torch.float64)
_B = 4
_G, _N = 2, 8

# (parent, child) span names each call gives, and the roots.
_ENV_TREE = {
    (None, 'env.step'), (None, 'env.merge_resets'),
    ('env.step', 'env.goal_switch'), ('env.step', 'physics.step_n'),
    ('env.step', 'env.task'),
    ('physics.step_n', 'physics.planes'),
    ('physics.step_n', 'collision.narrowphase'),
    ('physics.step_n', 'physics.smooth'),
    ('physics.step_n', 'constraint.solve'),
    ('physics.step_n', 'physics.integrate'),
    ('physics.step_n', 'physics.refresh'),
    ('physics.refresh', 'collision.narrowphase'),
    ('constraint.solve', 'constraint.assemble'),
    ('constraint.solve', 'constraint.newton')}
_PLANNER_TREE = {
    (None, 'planner.solve_batch'),
    ('planner.solve_batch', 'planner.iteration'),
    ('planner.iteration', 'planner.rollout'),
    ('planner.rollout', 'physics.step_n'),
    ('physics.step_n', 'physics.planes'),
    ('physics.step_n', 'collision.midphase'),
    ('physics.step_n', 'collision.narrowphase'),
    ('physics.step_n', 'physics.smooth'),
    ('physics.step_n', 'constraint.solve'),
    ('physics.step_n', 'physics.integrate'),
    ('constraint.solve', 'constraint.assemble'),
    ('constraint.solve', 'constraint.newton')}


@pytest.fixture(autouse=True)
def _empty_buffer():
  profiling.clear()
  yield
  profiling.clear()


@pytest.fixture(scope='module')
def suite():
  """A reorient batch of 4 after three steps, so the cubes touch the
  hands (the narrow phase has live contacts)."""
  torch.set_num_threads(min(torch.get_num_threads(), 4))
  env = manipulation.load('reorient', 'state_dense', **F64)
  benv = batched.BatchedEnvironment(env, _B)
  gen = torch.Generator().manual_seed(5)
  state, _ = benv.reset(gen)
  action = torch.zeros(_B, env.action_spec().shape[0], dtype=torch.float64)
  for _ in range(3):
    state, _ = benv.step(state, action, gen)
  return dict(env=env, benv=benv, state=state, action=action)


@pytest.fixture(scope='module')
def planner():
  task = manipulation.build_task('reorient', 'state_dense')
  pp = ps.PredictiveSampling(
      task, ps.PredictiveSamplingConfig(horizon=2, num_samples=_N), **F64)
  env = manipulation.load('reorient', 'state_dense', **F64)
  state, _ = env.reset(torch.Generator().manual_seed(6), (_G,))
  return dict(pp=pp, data=state.data, goals=state.task.goal)


def _step(suite, seed=7):
  return suite['benv'].step(suite['state'], suite['action'],
                            torch.Generator().manual_seed(seed))


def _solve(planner):
  pp = planner['pp']
  return pp.solve_batch(planner['data'], planner['goals'],
                        pp.init_state(streams=_G),
                        torch.Generator().manual_seed(8))


def _traced(fn):
  """fn() under a CPU profiler session, between two reads of the clock,
  and the spans it recorded."""
  import time
  profiling.clear()
  t0 = time.time_ns()
  with profile(activities=[ProfilerActivity.CPU]):
    out = fn()
  t1 = time.time_ns()
  return out, profiling.records(), t0, t1


def _tree(recs):
  return {(recs[r.parent].name if r.parent >= 0 else None, r.name)
          for r in recs}


def _check_nesting(recs, t0, t1):
  for r in recs:
    assert t0 <= r.start_ns <= r.end_ns <= t1
    if r.parent < 0:
      assert r.depth == 0
      continue
    p = recs[r.parent]
    assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert r.depth == p.depth + 1


@pytest.mark.parametrize('call', ['env_step', 'solve_batch'])
def test_spans_form_the_layer_tree(call, suite, planner):
  if call == 'env_step':
    _, recs, t0, t1 = _traced(lambda: _step(suite))
    want = _ENV_TREE
  else:
    _, recs, t0, t1 = _traced(lambda: _solve(planner))
    want = _PLANNER_TREE
  assert _tree(recs) == want
  _check_nesting(recs, t0, t1)


@pytest.mark.parametrize('call', ['env_step', 'solve_batch'])
def test_nothing_is_recorded_without_a_profiler(call, suite, planner):
  if call == 'env_step':
    _step(suite)
  else:
    _solve(planner)
  assert profiling.records() == []
  assert profiling._records == [] and profiling._open == []


def test_spans_and_counters_cost_nothing_outside_a_session():
  with profiling.trace_annotation('outer') as span:
    profiling.count('rows', 3)
    profiling.count('live', torch.ones(3), lambda t: t.sum())
  assert span is None
  assert profiling._records == []


def test_the_same_call_traced_and_untraced_gives_the_same_step(suite):
  (state_a, ts_a), _, _, _ = _traced(lambda: _step(suite))
  state_b, ts_b = _step(suite)
  assert torch.equal(state_a.data.qpos, state_b.data.qpos)
  assert torch.equal(ts_a.reward, ts_b.reward)


def _live_recount(groups, top_k):
  score = torch.cat([g['dist'] - g['margin'] for g in groups], -1)
  live = (score < 0).sum(-1)
  return int(torch.minimum(live, torch.full_like(live, top_k)).sum())


def _keep_narrow_phase(monkeypatch):
  """Copies of every collide_group_planes output's dist and margin."""
  outputs = []
  orig = primitives.collide_group_planes

  def keep(*args, **kwargs):
    out = orig(*args, **kwargs)
    outputs.append([dict(dist=g['dist'].clone(), margin=g['margin'].clone())
                    for g in out])
    return out

  monkeypatch.setattr(primitives, 'collide_group_planes', keep)
  return outputs


def test_live_and_slots_recount_the_narrow_phase(suite, monkeypatch):
  outputs = _keep_narrow_phase(monkeypatch)
  model = suite['env'].model
  n_sub = suite['env'].task.n_substeps
  _, recs, _, _ = _traced(lambda: _step(suite))
  assemble = [r for r in recs if r.name == 'constraint.assemble']
  # Each substep's narrow phase feeds its constraint solve; the refresh's
  # narrow phase comes last and feeds none.
  assert len(assemble) == n_sub and len(outputs) == n_sub + 1
  slots = primitives.num_contact_points(model)
  total_live = 0
  for r, groups in zip(assemble, outputs):
    c = dict(r.counters)
    assert c['slots'] == _B * slots
    assert c['live'] == _live_recount(groups, model.opt.contact_top_k)
    total_live += c['live']
  assert total_live > 0


def test_live_keeps_at_most_top_k_a_row(suite, monkeypatch):
  outputs = _keep_narrow_phase(monkeypatch)
  model = suite['env'].model
  model = model.replace(opt=model.opt.replace(contact_top_k=1))
  _, recs, _, _ = _traced(lambda: physics_step.step_n(
      model, suite['state'].data, 1, refresh='none'))
  (r,) = [r for r in recs if r.name == 'constraint.assemble']
  live = dict(r.counters)['live']
  assert live == _live_recount(outputs[0], 1)
  assert 0 < live < _live_recount(outputs[0], 64)


def test_moved_recounts_the_newton_steps(suite, monkeypatch):
  steps = []
  orig = profiling.count

  def keep(name, value, reduce=None):
    if name == 'moved':
      steps.append(value.clone())
    orig(name, value, reduce)

  monkeypatch.setattr(profiling, 'count', keep)
  model = suite['env'].model
  _, recs, _, _ = _traced(lambda: _step(suite))
  newton = [r for r in recs if r.name == 'constraint.newton']
  got = [(n, v) for r in newton for n, v in r.counters]
  assert len(got) == 2 * len(steps) == (
      2 * model.opt.solver_iterations * len(newton))
  for it, step in enumerate(steps):
    assert got[2 * it] == ('row_iters', _B)
    assert got[2 * it + 1] == ('moved', int((step > 0).sum()))


def test_rows_reset_counts_the_done_rows(suite):
  benv, state = suite['benv'], suite['state']
  done = torch.tensor([True, False, True, False])
  _, recs, t0, t1 = _traced(lambda: benv._merge_resets(
      state, done, torch.Generator().manual_seed(9)))
  merge = [r for r in recs if r.name == 'env.merge_resets']
  assert len(merge) == 1 and dict(merge[0].counters) == {'rows_reset': 2}
  assert ('env.merge_resets', 'env.reset') in _tree(recs)
  _check_nesting(recs, t0, t1)
  _, recs, _, _ = _traced(lambda: benv._merge_resets(
      state, torch.zeros(_B, dtype=torch.bool), None))
  assert [dict(r.counters) for r in recs] == [{'rows_reset': 0}]


def test_records_reduce_each_counter_once_and_drop_its_value():
  calls = []

  def reduce(value):
    calls.append(value)
    return 5

  with profile(activities=[ProfilerActivity.CPU]):
    with profiling.trace_annotation('outer'):
      profiling.count('n', 2)
      with profiling.trace_annotation('inner'):
        profiling.count('x', torch.ones(2), reduce)
  first = profiling.records()
  assert profiling.records() == first and len(calls) == 1
  assert [r.counters for r in first] == [(('n', 2),), (('x', 5),)]
  assert profiling._records[1][5] == [('x', 5, None)]
  profiling.clear()
  assert profiling.records() == []


def test_device_trace_holds_the_program_spans(tmp_path, suite):
  with profiling.device_trace(str(tmp_path)):
    _step(suite)
  trace = json.loads((tmp_path / 'trace.json').read_text())
  program = [e for e in trace['traceEvents']
             if e.get('ph') == 'X' and e.get('tid') == 'program spans']
  names = {e['name'] for e in program}
  assert {n for _, n in _ENV_TREE} <= names
  assemble = [e for e in program if e['name'] == 'constraint.assemble']
  assert assemble and all(set(e['args']) == {'slots', 'live'}
                          for e in assemble)
  # On the profiler's clock: each program span lies within the session's
  # own record.
  session = [e for e in trace['traceEvents']
             if e.get('ph') == 'X' and 'PyTorch Profiler' in e['name']]
  lo = min(e['ts'] for e in session)
  hi = max(e['ts'] + e['dur'] for e in session)
  assert all(lo <= e['ts'] and e['ts'] + e['dur'] <= hi + 1 for e in program)
