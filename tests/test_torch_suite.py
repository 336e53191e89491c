"""The port's task suite against the JAX package (float64 on the CPU).

The registry equals JAX's; every task loads and steps on the CPU; reach
and juggle `reset` and 3 `step`s match JAX's vmap(reset) and vmap(step)
(juggle's steps: JAX's `step` of each environment, see its test) given
JAX's own episode draws (reach: the start configuration's and the
goal's rejection tries, derived from JAX's keys; juggle draws nothing);
a reach goal switch after 5 in-threshold steps resamples the goal from
JAX's draws; and the reach oracle of examples/oracle_reach.py solves a
goal on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu_torch import environment as penv_lib
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.utils import structs
from torch_scene import to_np as _np

F64 = dict(device='cpu', dtype=torch.float64)
_NB = 3
_TRIES = 100      # reach's init and goal rejection budgets

# Limits against JAX after `reset` and after each of 3 steps, with the
# largest readings (reach state_dense, with its goal switch; juggle).
_LIMITS = {'qpos': 1e-8,        # reach 4.4e-16, juggle 2.9e-9
           'qvel': 1e-6,        # reach 1.2e-14, juggle 3.8e-7
           'xpos': 1e-8,        # reach 1.1e-16, juggle 6.1e-11
           'obs': 1e-6,         # reach 4.6e-11, juggle 3.3e-7 (velocities)
           'reward': 1e-9,      # reach 1.4e-10 (dense); juggle 0
           'goal': 1e-8}        # reach 1.9e-9: a goal's joint slots are
                                # settled by 2 physics steps


def _tree_np(x):
  if hasattr(x, '__dataclass_fields__'):
    return {k: _tree_np(getattr(x, k)) for k in x.__dataclass_fields__}
  if isinstance(x, dict):
    return {k: _tree_np(v) for k, v in x.items()}
  return np.asarray(x)


def _err(got, want):
  want = np.asarray(want)
  return float(np.max(np.abs(_np(got) - want))) if want.size else 0.0


def _port_state(jstate):
  return penv_lib.state_from_numpy(_tree_np(jstate), **F64)


def _compare(state, ts, jstate, jts, first=False):
  """Port (state, ts) against JAX's; returns the readings."""
  out = {}
  for f in ('qpos', 'qvel', 'xpos'):
    out[f] = _err(getattr(state.data, f), getattr(jstate.data, f))
    assert out[f] <= _LIMITS[f], (f, out[f])
  for f in ('time', 'ctrl', 'mocap_pos', 'xfrc_applied'):
    assert _err(getattr(state.data, f), getattr(jstate.data, f)) <= 1e-12, f
  out['reward'] = _err(ts.reward, jts.reward)
  assert out['reward'] <= _LIMITS['reward']
  np.testing.assert_array_equal(_np(ts.step_type), np.asarray(jts.step_type))
  np.testing.assert_array_equal(_np(ts.discount), np.asarray(jts.discount))
  for f, v in _tree_np(jstate.task).items():
    got = getattr(state.task, f)
    assert tuple(got.shape) == v.shape, f
    if f in ('goal', 'goal_distance', 'solve_start_time'):
      out[f] = _err(got, v)
      assert out[f] <= _LIMITS['goal'], (f, out[f])
    else:
      np.testing.assert_array_equal(_np(got), v, err_msg=f)
  np.testing.assert_array_equal(_np(state.step_count),
                                np.asarray(jstate.step_count))
  assert set(ts.observation) == set(jts.observation)
  out['obs'] = max(_err(ts.observation[k], v)
                   for k, v in jts.observation.items())
  assert out['obs'] <= _LIMITS['obs'], out
  if first:
    for k, v in jts.observation.items():
      assert tuple(ts.observation[k].shape) == np.asarray(v).shape, k
  return out


def test_registry_matches_jax():
  assert pmanip.ALL_TASKS == jmanip.ALL_TASKS
  assert pmanip.ALL_NAMES == jmanip.ALL_NAMES
  assert pmanip.TASKS_BY_DOMAIN == jmanip.TASKS_BY_DOMAIN
  assert pmanip.ALL_NAMES == ['juggle.state_sparse', 'reach.state_dense',
                              'reach.state_sparse', 'reorient.state_dense']
  for dom, task in pmanip.ALL_TASKS:
    assert (pmanip._DOMAINS[dom].SUITE.tags(task)
            == jmanip._DOMAINS[dom].SUITE.tags(task))


@pytest.mark.parametrize('name', ['juggle.state_sparse', 'reach.state_dense',
                                  'reach.state_sparse',
                                  'reorient.state_dense'])
def test_every_task_loads_and_steps_on_the_cpu(name):
  """load(device='cpu') in float64, a reset of two episodes and one step
  of zero actions: finite state, the action and observation specs of the
  JAX environment."""
  env = pmanip.load(*name.split('.'), **F64)
  jenv = jmanip.load(*name.split('.'))
  assert env.action_spec().shape == jenv.action_spec().shape
  np.testing.assert_array_equal(env.action_spec().minimum,
                                jenv.action_spec().minimum)
  gen = torch.Generator().manual_seed(0)
  state, ts = env.reset(gen, (2,))
  assert bool(state.task.goal_ok.all())
  state, ts = env.step(state, torch.zeros(2, env.model.nu,
                                          dtype=torch.float64), gen)
  assert np.isfinite(_np(state.data.qpos)).all()
  np.testing.assert_array_equal(_np(ts.step_type), [1, 1])
  spec = env.observation_spec()
  assert set(spec) == set(ts.observation)
  for k, v in spec.items():
    assert (2,) + v.shape == tuple(ts.observation[k].shape), k


# ---------------------------------------------------------------------------
# reach
# ---------------------------------------------------------------------------


def _unit_tries(key, n, tries=_TRIES):
  """Unit uniforms of each try of the collision-free start sampler
  (models/hands.py: key, sub = split(key); uniform(sub))."""
  out = []
  for _ in range(tries):
    key, sub = jax.random.split(key)
    out.append(np.asarray(jax.random.uniform(sub, (n,), jnp.float64)))
  return np.stack(out)


def _goal_tries(k_goal, n, tries=_TRIES):
  """Normals of each try of the first goal sample from k_goal
  (environment._sample_goal: key, sub = split(key), then
  FingertipCartesianPosition.next_goal: key, sub = split(key);
  normal(sub))."""
  _, key = jax.random.split(k_goal)
  out = []
  for _ in range(tries):
    key, sub = jax.random.split(key)
    out.append(np.asarray(jax.random.normal(sub, (n,), jnp.float64)))
  return np.stack(out)


@pytest.fixture(scope='module')
def reach():
  jenv = jmanip.load('reach', 'state_dense')
  penv = pmanip.load('reach', 'state_dense', **F64)
  nj = penv.task.hand.num_joints
  keys = jax.random.split(jax.random.PRNGKey(11), _NB)
  state, ts = jax.jit(jax.vmap(jenv.reset))(keys)
  init, goal = [], []
  for key in keys:
    _, k_init, _, k_goal = jax.random.split(key, 4)
    init.append(_unit_tries(k_init, nj))
    goal.append(_goal_tries(k_goal, nj))
  return dict(jenv=jenv, penv=penv, state=state, ts=ts,
              init=np.stack(init), goal=np.stack(goal),
              step=jax.jit(jax.vmap(jenv.step)))


def _patch_reach_draws(monkeypatch, ptask, init, goal):
  monkeypatch.setattr(ptask, 'init_draws',
                      lambda gen, batch: torch.as_tensor(init))
  monkeypatch.setattr(ptask.goal_generator, 'draws',
                      lambda gen, batch: torch.as_tensor(goal))


def test_reach_reset_and_steps_match_jax(reach, monkeypatch):
  """reset with JAX's start and goal tries for 3 keys, then 3 steps of
  seeded actions (some outside the spec), against JAX's vmap(reset) and
  vmap(step); one environment also steps alone against its row."""
  penv = reach['penv']
  _patch_reach_draws(monkeypatch, penv.task, reach['init'], reach['goal'])
  state, ts = penv.reset(torch.Generator(), (_NB,))
  assert bool(state.task.goal_ok.all())
  _compare(state, ts, reach['state'], reach['ts'], first=True)
  assert state.task.goal.shape == (_NB, 15 + 24)
  jstate = reach['state']
  one = structs.tree_map(lambda x: x[1], state)
  rng = np.random.default_rng(2)
  spec = penv.action_spec()
  for _ in range(3):
    act = spec.minimum + (spec.maximum - spec.minimum) * rng.uniform(
        -0.2, 1.2, (_NB, penv.model.nu))
    jstate, jts = reach['step'](jstate, jnp.asarray(act))
    state, ts = penv.step(state, torch.as_tensor(act))
    _compare(state, ts, jstate, jts)
    one, ts1 = penv.step(one, torch.as_tensor(act[1]))
    row = lambda x: jax.tree_util.tree_map(lambda y: y[1:2], x)
    _compare(structs.tree_map(lambda x: x[None], one),
             structs.tree_map(lambda x: x[None], ts1), row(jstate), row(jts))


def test_reach_goal_switch_matches_jax(reach, monkeypatch):
  """Rows 0 and 2 have held the goal for 6 steps (> 5): they draw a new
  goal, from JAX's draws of their step keys (environment.py: key, k_goal
  = split(state.key)); row 1 keeps its goal.  Against JAX's vmap(step)."""
  penv = reach['penv']
  nj = penv.task.hand.num_joints
  jstate = reach['state']
  jstate = jstate.replace(task=jstate.task.replace(
      success_change_counter=jnp.asarray([6, 0, 6], jnp.int32),
      success_registered=jnp.asarray([True, False, True])))
  goals = np.stack([_goal_tries(jax.random.split(k)[1], nj)
                    for k in np.asarray(jstate.key)[[0, 2]]])
  _patch_reach_draws(monkeypatch, penv.task, reach['init'], goals)
  act = np.zeros((_NB, penv.model.nu))
  jnew, jts = reach['step'](jstate, jnp.asarray(act))
  state, ts = penv.step(_port_state(jstate), torch.as_tensor(act),
                        torch.Generator())
  _compare(state, ts, jnew, jts)
  np.testing.assert_array_equal(_np(state.task.goal_changed),
                                [True, False, True])
  old = np.asarray(jstate.task.goal)
  assert np.abs(_np(state.task.goal)[1] - old[1]).max() == 0.0
  assert np.abs(_np(state.task.goal)[[0, 2]] - old[[0, 2]]).min() > 1e-6


def test_reach_rewards_match_jax(reach):
  """Dense and sparse rewards of distances inside, at and beyond the
  1 cm threshold, against the JAX tasks' get_reward."""
  dense_p = reach['penv'].task
  sparse_p = pmanip.build_task('reach', 'state_sparse')
  dense_j = reach['jenv'].task
  sparse_j = jmanip.build_task('reach', 'state_sparse')
  dist = np.array([[0.0, 0.005, 0.01, 0.02, 0.3],
                   [0.011, 0.0, 0.0, 0.0, 0.0],
                   [0.0] * 5])

  class _T:
    def __init__(self, d):
      self.goal_distance = d
  for pt, jt in ((dense_p, dense_j), (sparse_p, sparse_j)):
    want = np.stack([np.asarray(jt.get_reward(None, None, _T(jnp.asarray(d))))
                     for d in dist])
    got = pt.get_reward(None, None, _T(torch.as_tensor(dist)))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-15)
  assert _np(sparse_p.get_reward(None, None, _T(torch.as_tensor(dist))))[
      2] == 0.0


def test_reach_oracle_solves_a_goal_on_the_cpu():
  """examples/oracle_reach.py's policy (ctrl = joint_positions_to_control
  of the goal's joint slots) on two sparse-reward episodes, as JAX's
  tests/test_suite.py drives one: every episode registers a solve and
  reaches reward 0 within 30 steps."""
  env = pmanip.load('reach', 'state_sparse', **F64)
  gen = torch.Generator().manual_seed(42)
  state, _ = env.reset(gen, (2,))
  hand = env.task.hand
  best = torch.full((2,), -np.inf, dtype=torch.float64)
  solved = torch.zeros(2, dtype=torch.int32)
  first = None
  for _ in range(30):
    ctrl = hand.joint_positions_to_control(state.task.goal[..., 15:])
    state, ts = env.step(state, ctrl, gen)
    first = ts.reward if first is None else first
    best = torch.maximum(best, ts.reward)
    solved = torch.maximum(solved, state.task.successes)
    if bool(((solved >= 1) & (best == 0)).all()):
      break
  assert (first <= 0).all()
  assert (solved >= 1).all() and (best == 0).all(), (solved, best)


# ---------------------------------------------------------------------------
# juggle
# ---------------------------------------------------------------------------


def test_juggle_reset_and_steps_match_jax():
  """reset of 3 environments (juggle draws nothing: the hands start at
  midrange, settle 2 steps, and the ball is set on the left palm) against
  JAX's vmap(reset), then 3 steps of seeded actions against JAX's `step`
  of each environment.  JAX's vmap(step) is not the reference for the
  steps: in environment 0's second step it departs from JAX's own `step`
  by 1.1e-8 in qpos and 1.1e-6 in qvel (a different line-search step
  under vmap's rounding, as in tests/test_torch_equality.py), and the
  port follows JAX's `step` (2.6e-9 in qvel there)."""
  jenv = jmanip.load('juggle', 'state_sparse')
  penv = pmanip.load('juggle', 'state_sparse', **F64)
  jstate, jts = jax.jit(jax.vmap(jenv.reset))(
      jax.random.split(jax.random.PRNGKey(0), _NB))
  state, ts = penv.reset(torch.Generator(), (_NB,))
  _compare(state, ts, jstate, jts, first=True)
  assert state.task.goal.shape == (_NB, 0)
  qadr = penv.task._ball_qadr
  palm = _np(state.data.xpos)[:, penv.task._left_palm]
  np.testing.assert_allclose(_np(state.data.qpos)[:, qadr:qadr + 3],
                             palm + [0.0, -0.05, 0.05], atol=1e-12)
  step = jax.jit(jenv.step)
  rng = np.random.default_rng(4)
  spec = penv.action_spec()
  lo = np.where(np.isfinite(spec.minimum), spec.minimum, -1.0)
  hi = np.where(np.isfinite(spec.maximum), spec.maximum, 1.0)
  for _ in range(3):
    act = lo + (hi - lo) * rng.uniform(0.3, 0.7, (_NB, penv.model.nu))
    rows = [step(jax.tree_util.tree_map(lambda x, i=i: x[i], jstate),
                 jnp.asarray(act[i])) for i in range(_NB)]
    jstate, jts = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *rows)
    state, ts = penv.step(state, torch.as_tensor(act))
    _compare(state, ts, jstate, jts)
    np.testing.assert_array_equal(_np(ts.reward), 0.0)
