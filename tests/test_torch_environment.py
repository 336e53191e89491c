"""The port's reorient environment against the JAX package.

Both sides run in float64 on the CPU (JAX functions jitted on the CPU,
shared through module-scoped fixtures).  Module by module: the collision
masks and predicate, the hand and prop observables, the placement pick,
then the environment as a whole: `reset` (the placement candidates and
goals derived from JAX's own keys), `step` for a batch and for one
environment, the goal switch, the reorient episode semantics,
`manipulation.load`, `BatchedEnvironment` and the episode metrics, and a
planner solve started from `reset`'s state.

Limits are stated beside their readings (float64 on this CPU).  `step`
runs 5 substeps of exact Newton on the environment model: the port's
batched solve rounds differently from JAX's vmapped one, and the stiff
contact solve amplifies it (PERF.md §7).
"""

import dataclasses
import types as pytypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.core import types as JT
from dexterity_tpu.manipulation.goals import fingertip_position as jfp
from dexterity_tpu.manipulation.goals import prop_orientation as jpo
from dexterity_tpu.models import observables as jobs
from dexterity_tpu.physics import math as jmath
from dexterity_tpu.physics import step as jstep
from dexterity_tpu.utils import collisions as jcoll
from dexterity_tpu.utils import metrics as jmetrics
from dexterity_tpu_torch import environment as penv_lib
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.envs import batched as pbatched
from dexterity_tpu_torch.manipulation.goals import fingertip_position as pfp
from dexterity_tpu_torch.manipulation.goals import prop_orientation as ppo
from dexterity_tpu_torch.manipulation.tasks import reorient as preorient
from dexterity_tpu_torch.models import hands as phands
from dexterity_tpu_torch.models import observables as pobs
from dexterity_tpu_torch.physics import math as pmath
from dexterity_tpu_torch.physics import step as pstep
from dexterity_tpu_torch.planners import predictive_sampling as pps
from dexterity_tpu_torch.utils import collisions as pcoll
from dexterity_tpu_torch.utils import metrics as pmetrics
from dexterity_tpu_torch.utils import structs
from torch_scene import build_scene, jdata
from torch_scene import to_np as _np

F64 = dict(device='cpu', dtype=torch.float64)
_NB = 3                 # environments in the batched parity tests
_TRIES = 20             # reorient's _MAX_PLACE_SAMPLES


def _tree_np(x):
  """A JAX state (nested dataclasses and dicts) as numpy arrays."""
  if hasattr(x, '__dataclass_fields__'):
    return {k: _tree_np(getattr(x, k)) for k in x.__dataclass_fields__}
  if isinstance(x, dict):
    return {k: _tree_np(v) for k, v in x.items()}
  return np.asarray(x)


def _close(got, want, rtol, atol, msg=''):
  np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                             err_msg=msg)


def _max_err(got, want):
  return float(np.max(np.abs(_np(got) - _np(want)))) if np.size(
      _np(want)) else 0.0


# ---------------------------------------------------------------------------
# Fixtures: both environments, JAX's reset and jitted step
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def envs():
  jenv = jmanip.load('reorient', 'state_dense')
  penv = pmanip.load('reorient', 'state_dense', **F64)
  return dict(jenv=jenv, penv=penv, jm=jenv.model, pm=penv.model,
              jtask=jenv.task, ptask=penv.task)


@pytest.fixture(scope='module')
def jax_reset(envs):
  """JAX's vmap(reset) of _NB keys, and each key's placement candidates
  and goal, derived from JAX's own splits (environment.py:176,
  reorient.py:131-133, environment.py:121)."""
  jenv = envs['jenv']
  keys = jax.random.split(jax.random.PRNGKey(3), _NB)
  state, ts = jax.jit(jax.vmap(jenv.reset))(keys)
  box = envs['jtask']._workspace.prop_bbox
  lo, hi = jnp.asarray(box.lower), jnp.asarray(box.upper)
  pos, quat, goal = [], [], []
  for key in keys:
    _, k_init, _, k_goal = jax.random.split(key, 4)
    k, p, q = k_init, [], []
    for _ in range(_TRIES):
      k, k_pos, k_quat = jax.random.split(k, 3)
      p.append(jax.random.uniform(k_pos, (3,), jnp.float64, lo, hi))
      q.append(jpo.uniform_quaternion(k_quat, jnp.float64))
    pos.append(np.stack(p))
    quat.append(np.stack(q))
    goal.append(np.asarray(jpo.uniform_quaternion(
        jax.random.split(k_goal)[1], jnp.float64)))
  return dict(state=state, ts=ts, pos=np.stack(pos), quat=np.stack(quat),
              goal=np.stack(goal))


@pytest.fixture(scope='module')
def jax_step(envs, jax_reset):
  """JAX's vmap(step), and its step_batch, traced with a deterministic
  goal generator (_JaxDetGoal) so that the goal-switch test can hold the
  port to them; in the other tests no environment switches goal, and the
  generator is not reached.  (JAX's reset was traced before, with the
  task's own generator.)"""
  jtask = envs['jtask']
  jtask._goal_generator = _JaxDetGoal(jtask._prop, jtask._prop_prefix)
  return (jax.jit(jax.vmap(envs['jenv'].step)),
          jax.jit(envs['jenv'].step_batch))


def _actions(pm, rng, batch):
  """Seeded actions, a quarter of them outside the action spec (so the
  clipping runs)."""
  lo = pm.actuator_ctrlrange[:, 0].numpy()
  hi = pm.actuator_ctrlrange[:, 1].numpy()
  return lo + (hi - lo) * rng.uniform(-0.25, 1.25, (batch, pm.nu))


def _port_state(jstate):
  return penv_lib.state_from_numpy(_tree_np(jstate), **F64)


# ---------------------------------------------------------------------------
# The row helpers of utils/structs.py
# ---------------------------------------------------------------------------


@structs.dataclass
class _Inner:
  a: torch.Tensor
  b: torch.Tensor


@structs.dataclass
class _Outer:
  inner: _Inner
  extra: dict
  n: int


def _tree(offset):
  return _Outer(inner=_Inner(a=torch.arange(6.0).reshape(3, 2) + offset,
                             b=torch.arange(3) + int(offset)),
                extra={'c': torch.ones(3, 4) * offset, 'empty': {}}, n=7)


def test_row_helpers_select_whole_environments():
  """where_rows is jnp.where over tree_map (row-wise, through dataclasses
  and dicts); take_rows / put_rows gather and scatter the masked rows;
  other leaves pass through; replace keeps the dataclass frozen."""
  a, b = _tree(0.0), _tree(100.0)
  mask = torch.tensor([True, False, True])
  w = structs.where_rows(mask, a, b)
  np.testing.assert_array_equal(w.inner.a.numpy(),
                                [[0, 1], [102, 103], [4, 5]])
  np.testing.assert_array_equal(w.inner.b.numpy(), [0, 101, 2])
  np.testing.assert_array_equal(w.extra['c'][:, 0].numpy(), [0, 100, 0])
  assert w.n == 7 and w.extra['empty'] == {}
  taken = structs.take_rows(mask, b)
  assert taken.inner.a.shape == (2, 2) and taken.extra['c'].shape == (2, 4)
  put = structs.put_rows(mask, a, taken)
  np.testing.assert_array_equal(put.inner.b.numpy(), [100, 1, 102])
  np.testing.assert_array_equal(a.inner.b.numpy(), [0, 1, 2])  # a intact
  one = structs.tree_map(lambda x: x[1], a)
  assert one.inner.a.shape == (2,)
  assert structs.where_rows(torch.tensor(True), one, one).inner.b == 1
  r = a.replace(n=3)
  assert r.n == 3 and a.n == 7
  with pytest.raises(Exception):
    a.n = 1


# ---------------------------------------------------------------------------
# 1. Collision masks and predicate
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def jax_forward(envs):
  """JAX's vmap(forward) on the environment model."""
  jm = envs['jm']
  return jax.jit(jax.vmap(lambda d: jstep.forward(jm, d)))


@pytest.fixture(scope='module')
def scene_forward(envs, jax_forward):
  """JAX's forward of the seeded contact-rich scene of torch_scene.py on
  the environment model (4 environments), carried to the port."""
  scene = build_scene()
  jd = jax_forward(jdata(envs['jm'], scene['state']))
  return jd, PT.data_from_numpy(_tree_np(jd), **F64)


def test_collision_masks_and_predicate_match_jax(envs, scene_forward):
  jm, pm = envs['jm'], envs['pm']
  assert pm.npair == jm.npair == 833
  prop, hand = envs['ptask']._prop_prefix, envs['ptask']._hand_prefix
  others = [n for n in pm.geom_names if not n.startswith(prop)]
  masks = {
      'fall': (jcoll.group_mask(jm, [prop], ['ground']),
               pcoll.group_mask(pm, [prop], ['ground'])),
      'spawn': (jcoll.group_mask(jm, [prop], others),
                pcoll.group_mask(pm, [prop], others)),
      'hand_self': (jcoll.self_mask(jm, hand), pcoll.self_mask(pm, hand)),
      'none': (np.zeros(jm.npair, bool), np.zeros(pm.npair, bool))}
  for name, (jmask, pmask) in masks.items():
    np.testing.assert_array_equal(pmask, jmask, err_msg=name)
  assert masks['spawn'][1].sum() > masks['fall'][1].sum() > 0
  jd, pd = scene_forward
  seen = set()
  for name, (jmask, pmask) in masks.items():
    for margin in (0.0, 0.01):
      want = np.asarray(jax.vmap(
          lambda d: jcoll.has_collision(d, jmask, margin))(jd))
      got = pcoll.has_collision(pd, pmask, margin)
      assert got.shape == (4,) and got.dtype == torch.bool
      np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
      # One environment without a batch axis.
      one = pcoll.has_collision(PT.map_data(pd, lambda x: x[1]), pmask,
                                margin)
      assert one.shape == () and bool(one) == bool(want[1])
      seen |= set(want.tolist())
  assert seen == {True, False}


# ---------------------------------------------------------------------------
# 2. Observables
# ---------------------------------------------------------------------------


def _all_enabled(names):
  return {n: {'enabled': True} for n in names}


def test_observables_match_jax(envs, scene_forward):
  """All nine hand observables, the four prop observables and the task's
  observation dict on JAX's forward of the scene (the same inputs on
  both sides), for a batch of 3 and for one environment.  Reading: 2e-16
  at most; limit 1e-10."""
  jm, pm = envs['jm'], envs['pm']
  jtask, ptask = envs['jtask'], envs['ptask']
  jd, pd = scene_forward
  jd3 = jax.tree_util.tree_map(lambda x: x[:_NB], jd)
  pd3 = PT.map_data(pd, lambda x: x[:_NB])
  goals = np.random.default_rng(21).normal(size=(_NB, 4))
  goals /= np.linalg.norm(goals, axis=1, keepdims=True)
  jhand = jobs.HandObservables(jtask.hand, jtask._hand_prefix,
                               _all_enabled(jobs.HandObservables.ALL))
  phand = pobs.HandObservables(ptask.hand, ptask._hand_prefix,
                               _all_enabled(pobs.HandObservables.ALL))
  jprop = jobs.FreePropObservables(jtask._prop, jtask._prop_prefix,
                                   _all_enabled(jobs.FreePropObservables.ALL))
  pprop = pobs.FreePropObservables(ptask._prop, ptask._prop_prefix,
                                   _all_enabled(pobs.FreePropObservables.ALL))
  want = jax.vmap(lambda d, g: {
      **jhand.as_dict(jm, d), **jprop.as_dict(jm, d),
      **{'task/' + k: v for k, v in jtask.observables(
          jm, d, pytypes.SimpleNamespace(goal=g), {}).items()}})(
              jd3, jnp.asarray(goals))

  def port(d, g):
    return {**phand.as_dict(pm, d), **pprop.as_dict(pm, d),
            **{'task/' + k: v for k, v in ptask.observables(
                pm, d, pytypes.SimpleNamespace(goal=g), {}).items()}}

  got = port(pd3, torch.as_tensor(goals))
  one = port(PT.map_data(pd3, lambda x: x[1]), torch.as_tensor(goals[1]))
  assert len(want) == 9 + 4 + 9 and set(got) == set(want) == set(one)
  assert {k for k in got if k.startswith('task/')} == {
      'task/' + k for k in ('shadow_hand_e/joint_positions_sin_cos',
                            'shadow_hand_e/joint_velocities',
                            'shadow_hand_e/fingertip_positions',
                            'shadow_hand_e/fingertip_linear_velocities',
                            'prop/position', 'prop/orientation',
                            'prop/linear_velocity', 'prop/angular_velocity',
                            'goal_state')}
  for key, w in want.items():
    w = np.asarray(w)
    assert tuple(got[key].shape) == w.shape, key
    _close(got[key], w, 1e-10, 1e-10, key)
    assert tuple(one[key].shape) == w.shape[1:], key
    _close(one[key], w[1], 1e-10, 1e-10, key)
  # Every value is live: velocities and torques of a moving, contact-rich
  # scene are not zero.
  for key in ('shadow_hand_e/joint_torques', 'prop/linear_velocity',
              'shadow_hand_e/fingertip_angular_velocities'):
    assert np.abs(np.asarray(want[key])).max() > 1e-6, key


def test_observable_options_are_validated(envs):
  ptask = envs['ptask']
  with pytest.raises(NotImplementedError, match='buffer_size'):
    pobs.HandObservables(ptask.hand, 'x/', {'joint_positions': {
        'enabled': True, 'buffer_size': 2}})
  # Cameras render (the JAX package's CameraObservables); depth and
  # segmentation raise as JAX's do.
  from dexterity_tpu_torch.manipulation.shared import cameras, observations
  vision = observations.ObservationSet.VISION_ONLY.value
  with pytest.raises(NotImplementedError, match='depth/segmentation'):
    cameras.add_camera_observables(
        ptask.arena, dataclasses.replace(vision, camera=dataclasses.replace(
            vision.camera, depth=True)), cameras.FRONT_CLOSE)


# ---------------------------------------------------------------------------
# 3. reset
# ---------------------------------------------------------------------------


def test_first_free_picks_the_first_free_try_or_the_last():
  free = torch.tensor([[False, True, True], [True, False, False],
                       [False, False, False], [False, False, True]])
  np.testing.assert_array_equal(phands.first_free(free).numpy(),
                                [1, 0, 2, 2])
  assert int(phands.first_free(torch.tensor([False, True]))) == 1


def test_place_prop_rejects_a_penetrating_try_as_jax_does(envs, jax_reset,
                                                         jax_forward):
  """JAX's own candidates for the first key with the first try moved into
  the palm (no natural try of these keys penetrates).  JAX's loop keeps
  the first try whose fwd_position shows no prop contact
  (reorient.py:135-146): its verdict on the first 4 tries (fwd_position
  through JAX's forward) against the port's place_prop over all 20."""
  jm, pm, jtask, ptask = (envs['jm'], envs['pm'], envs['jtask'],
                          envs['ptask'])
  d = pstep.fwd_position(pm, PT.make_data(pm))
  d = pfp.compensate_gravity(pm, d, ptask._binding.body_ids)
  palm = pm.geom_names.index(ptask._hand_prefix + 'palm_geom1')
  pos = jax_reset['pos'][0].copy()
  quat = jax_reset['quat'][0].copy()
  pos[0] = d.geom_xpos[palm].numpy()
  qadr = ptask._prop_qadr
  # Each try is a fresh data at qpos0 with the hand's gravity
  # compensation; forward recomputes everything else from qpos.
  jd0 = jfp.compensate_gravity(jm, JT.make_data(jm), jtask._binding.body_ids)
  qpos = np.repeat(np.asarray(jd0.qpos)[None], 4, 0)
  qpos[:, qadr:qadr + 3] = pos[:4]
  qpos[:, qadr + 3:qadr + 7] = quat[:4]
  jd = jax_forward(jax.tree_util.tree_map(
      lambda x: jnp.broadcast_to(x[None], (4,) + x.shape), jd0).replace(
          qpos=jnp.asarray(qpos)))
  colliding = np.asarray(jax.vmap(
      lambda x: jcoll.has_collision(x, jtask._prop_mask))(jd))
  assert colliding[0] and not colliding[1]
  jqpos = np.asarray(jd.qpos)
  got, tries = ptask.place_prop(pm, d, torch.as_tensor(pos),
                                torch.as_tensor(quat))
  assert int(tries) == 2
  _close(got.qpos, np.asarray(jqpos)[1], 1e-12, 1e-12)
  # Every try colliding keeps the last; a batch picks per environment.
  got2, tries2 = ptask.place_prop(
      pm, PT.map_data(d, lambda x: x.expand((2,) + x.shape).clone()),
      torch.as_tensor(np.stack([pos, np.repeat(pos[:1], _TRIES, 0)])),
      torch.as_tensor(np.stack([quat, quat])))
  np.testing.assert_array_equal(tries2.numpy(), [2, _TRIES])
  _close(got2.qpos[0], np.asarray(jqpos)[1], 1e-12, 1e-12)
  assert float(got2.qpos[1, qadr + 3:qadr + 7].sub(
      torch.as_tensor(quat[-1])).abs().max()) == 0.0


def _patched_draws(monkeypatch, ptask, jr):
  """The port's reset draws replaced by JAX's candidates and goals."""
  monkeypatch.setattr(ptask, 'placement_candidates', lambda gen, batch: (
      torch.as_tensor(jr['pos']), torch.as_tensor(jr['quat'])))

  def next_goal(model, data, gen):
    return (torch.as_tensor(jr['goal']), data,
            torch.ones(data.qpos.shape[:-1], dtype=torch.bool))
  monkeypatch.setattr(ptask.goal_generator, 'next_goal', next_goal)


def test_reset_matches_jax(envs, jax_reset, monkeypatch):
  """reset with JAX's candidates and goals for _NB keys: the chosen
  qpos, the forward products, TaskState, observations and TimeStep.
  Readings: qpos 0, xpos 5.6e-17, qacc 7.2e-13, observations 5.6e-17,
  goal_distance 2.2e-16; limit 1e-10."""
  penv = envs['penv']
  _patched_draws(monkeypatch, envs['ptask'], jax_reset)
  state, ts = penv.reset(torch.Generator(), (_NB,))
  jstate, jts = jax_reset['state'], jax_reset['ts']
  for f in ('qpos', 'qvel', 'xfrc_applied', 'mocap_quat', 'xpos', 'xquat',
            'site_xpos', 'cvel', 'qacc', 'qfrc_constraint'):
    _close(getattr(state.data, f), getattr(jstate.data, f), 1e-10, 1e-10, f)
  assert float(state.data.xfrc_applied.abs().max()) > 0   # compensation on
  for f, w in _tree_np(jstate.task).items():
    g = getattr(state.task, f)
    assert tuple(g.shape) == w.shape, f
    _close(g, w, 1e-10, 1e-12, f)
  np.testing.assert_array_equal(state.step_count.numpy(),
                                np.asarray(jstate.step_count))
  assert state.step_count.dtype == torch.int32
  for f in ('step_type', 'reward', 'discount'):
    np.testing.assert_array_equal(_np(getattr(ts, f)),
                                  np.asarray(getattr(jts, f)))
  assert set(ts.observation) == set(jts.observation)
  for k, w in jts.observation.items():
    _close(ts.observation[k], w, 1e-10, 1e-10, k)


def test_reset_draws_from_the_generator_and_reports_tries(envs):
  """Without patching: a seeded CPU generator gives the same episodes
  twice, for a batch and for one environment; goals are unit
  quaternions and every placement is collision-free."""
  penv, ptask = envs['penv'], envs['ptask']
  a, _ = penv.reset(torch.Generator().manual_seed(5), (2,))
  b, _ = penv.reset(torch.Generator().manual_seed(5), (2,))
  _close(a.data.qpos, b.data.qpos, 0, 0)
  _close(a.task.goal, b.task.goal, 0, 0)
  _close(a.task.goal.norm(dim=-1), np.ones(2), 0, 1e-12)
  one, ts = penv.reset(torch.Generator().manual_seed(6))
  assert one.data.qpos.shape == (penv.model.nq,)
  assert ts.step_type.shape == () and int(ts.step_type) == 0
  assert not bool(pcoll.has_collision(
      pstep.fwd_position(penv.model, one.data), ptask._prop_mask))


# ---------------------------------------------------------------------------
# 4. step
# ---------------------------------------------------------------------------

# Limits of the port's step against JAX's vmap(step) after 2 control
# steps (10 substeps of exact Newton), with the readings they bound.
_STEP_LIMITS = {'qpos': 1e-8,        # reading 6.8e-12
                'qvel': 1e-6,        # reading 2.5e-10
                'xpos': 1e-8,        # reading 6.3e-13
                'reward': 1e-9,      # reading 5.6e-16, relative to max |r|
                'goal_distance': 1e-9,   # reading 1.3e-14 (also goal,
                                         # solve_start_time)
                'obs': 1e-6}         # reading 2.5e-10 (the velocities)


def _compare_step(state, ts, jstate, jts, rows=slice(None)):
  """Port (state, ts) against rows of JAX's; returns the readings."""
  def w(x):
    return np.asarray(x)[rows]

  out = {}
  for f in ('qpos', 'qvel', 'xpos'):
    out[f] = _max_err(getattr(state.data, f), w(getattr(jstate.data, f)))
    assert out[f] <= _STEP_LIMITS[f], (f, out[f])
  for f in ('time', 'ctrl'):
    _close(getattr(state.data, f), w(getattr(jstate.data, f)), 0, 1e-12, f)
  out['reward'] = _max_err(ts.reward, w(jts.reward))
  assert out['reward'] <= _STEP_LIMITS['reward'] * max(
      1.0, float(np.abs(w(jts.reward)).max()))
  np.testing.assert_array_equal(_np(ts.step_type), w(jts.step_type))
  np.testing.assert_array_equal(_np(ts.discount), w(jts.discount))
  for f, v in _tree_np(jstate.task).items():
    got = getattr(state.task, f)
    if f in ('goal_distance', 'solve_start_time', 'goal'):
      err = _max_err(got, v[rows])
      assert err <= _STEP_LIMITS['goal_distance'], (f, err)
    else:
      np.testing.assert_array_equal(_np(got), v[rows], err_msg=f)
  np.testing.assert_array_equal(_np(state.step_count),
                                w(jstate.step_count))
  out['obs'] = max(_max_err(ts.observation[k], w(v))
                   for k, v in jts.observation.items())
  assert out['obs'] <= _STEP_LIMITS['obs'], out
  return out


def test_step_matches_jax_vmap_step(envs, jax_reset, jax_step):
  """Two control steps from JAX's reset state, carried across with
  state_from_numpy, seeded actions partly outside the spec."""
  penv = envs['penv']
  rng = np.random.default_rng(31)
  jstate, state = jax_reset['state'], _port_state(jax_reset['state'])
  one = structs.tree_map(lambda x: x[0], state)
  for _ in range(2):
    act = _actions(envs['pm'], rng, _NB)
    jstate, jts = jax_step[0](jstate, jnp.asarray(act))
    state, ts = penv.step(state, torch.as_tensor(act))
    _compare_step(state, ts, jstate, jts)
    # One environment without a batch axis, against its row of JAX's.
    one, ts1 = penv.step(one, torch.as_tensor(act[0]))
    assert ts1.reward.shape == () and one.data.qpos.shape == (
        penv.model.nq,)
    _compare_step(one, ts1, jstate, jts, rows=0)
  # The clipped action reached ctrl: inside the spec, and equal to JAX's.
  spec = penv.action_spec()
  ctrl = state.data.ctrl.numpy()
  assert (ctrl >= spec.minimum - 1e-12).all() and (
      ctrl <= spec.maximum + 1e-12).all()
  assert (np.isclose(ctrl, spec.minimum) | np.isclose(ctrl, spec.maximum)
          ).any()


# ---------------------------------------------------------------------------
# 5. The goal switch
# ---------------------------------------------------------------------------

_DET = np.array([0.9, 0.3, -0.2, 0.1]) / np.linalg.norm([0.9, 0.3, -0.2,
                                                         0.1])


class _JaxDetGoal(jpo.PropOrientation):
  """Goal = the prop's orientation times a fixed rotation: the same goal
  on both sides for the same state."""

  def next_goal(self, model, data, key):
    cur = self.current_state(model, data)
    return (jmath.quat_mul(cur, jnp.asarray(_DET)), data,
            jnp.asarray(True))


class _PortDetGoal(ppo.PropOrientation):

  def next_goal(self, model, data, gen):
    cur = self.current_state(model, data)
    return (pmath.quat_mul(cur, torch.as_tensor(_DET).to(cur)), data,
            torch.ones(cur.shape[:-1], dtype=torch.bool))


@pytest.fixture(scope='module')
def switch_env():
  """A port environment with the deterministic goal generator."""
  penv = pmanip.load('reorient', 'state_dense', **F64)
  pt = penv.task
  pt._goal_generator = _PortDetGoal(pt._prop, pt._prop_prefix)
  return penv


def test_goal_switch_matches_jax_step_batch_and_vmap_step(
    jax_reset, jax_step, switch_env):
  """success_change_counter above the threshold (5) in rows 0 and 2 only:
  those rows get a new goal (from their own state), a reset counter and
  solve_start_time; row 1 keeps its goal.  The port's step against JAX's
  step_batch and vmap(step)."""
  penv = switch_env
  jstate = jax_reset['state']
  counter = np.array([6, 0, 7], np.int32)
  jstate = jstate.replace(task=jstate.task.replace(
      success_change_counter=jnp.asarray(counter),
      success_registered=jnp.asarray([True, False, True])))
  act = _actions(penv.model, np.random.default_rng(41), _NB)
  want_v = jax_step[0](jstate, jnp.asarray(act))
  want_b = jax_step[1](jstate, jnp.asarray(act))
  state, ts = penv.step(_port_state(jstate), torch.as_tensor(act),
                        torch.Generator())
  for want in (want_b, want_v):
    _compare_step(state, ts, *want)
  np.testing.assert_array_equal(state.task.goal_changed.numpy(),
                                [True, False, True])
  old = np.asarray(jstate.task.goal)
  assert np.abs(state.task.goal.numpy()[1] - old[1]).max() == 0.0
  assert np.abs(state.task.goal.numpy()[[0, 2]] - old[[0, 2]]).min() > 1e-3
  # The hint body follows the new goals.
  _close(state.data.mocap_quat[:, 0], state.task.goal, 0, 1e-15)


def test_goal_switch_needs_a_generator_and_never_switch_skips(jax_reset,
                                                              switch_env):
  penv = switch_env
  state = _port_state(jax_reset['state'])
  state = state.replace(task=state.task.replace(
      success_change_counter=torch.tensor([6, 0, 0], dtype=torch.int32)))
  act = torch.zeros(_NB, penv.model.nu, dtype=torch.float64)
  with pytest.raises(ValueError, match='generator'):
    penv.step(state, act)
  # A task that never switches goal never resamples.
  task = penv.task
  saved = task._steps_before_changing_goal
  task._steps_before_changing_goal = 2 ** 31 - 1
  try:
    new, _ = penv.step(state, act)
  finally:
    task._steps_before_changing_goal = saved
  np.testing.assert_array_equal(new.task.goal_changed.numpy(), False)
  _close(new.task.goal, state.task.goal, 0, 0)
  assert penv.step_batch == penv.step


# ---------------------------------------------------------------------------
# 6. Reorient episode semantics
# ---------------------------------------------------------------------------


def test_reward_components_at_goal(envs):
  """Orientation 1/(d+0.1), success bonus 800, ctrl penalty
  -0.1||u||^2, as tests/test_reorient_semantics.py holds JAX to."""
  pm, ptask = envs['pm'], envs['ptask']
  data = PT.make_data(pm, (3,))
  tstate = pytypes.SimpleNamespace(
      goal_distance=torch.tensor([[0.0], [0.11], [0.11]],
                                 dtype=torch.float64))
  ctrl = data.ctrl.clone()
  ctrl[2] = 1.0
  r = ptask.get_reward(pm, data.replace(ctrl=ctrl), tstate).numpy()
  np.testing.assert_allclose(r, [810.0, 1 / 0.21, 1 / 0.21 - 0.1 * pm.nu],
                             atol=1e-9)


def test_episode_semantics_match_jax(envs, jax_reset, jax_step):
  """Row 0: the cube on the ground gives failure_termination, LAST and
  discount 1.  Row 1: the goal at the cube's orientation solves: LAST,
  discount 0, one success.  Row 2: a solve_start_time far in the past
  gives exceeded_single_goal_time, LAST, discount 1.  Against JAX's
  vmap(step) on the same states."""
  penv, qa = envs['penv'], envs['ptask']._prop_qadr
  jstate = jax_reset['state']
  qpos = np.asarray(jstate.data.qpos).copy()
  qpos[0, qa:qa + 3] = (0.3, 0.3, 0.019)
  goal = np.asarray(jstate.task.goal).copy()
  goal[1] = qpos[1, qa + 3:qa + 7]
  start = np.asarray(jstate.task.solve_start_time).copy()
  start[2] = -100.0
  jstate = jstate.replace(
      data=jstate.data.replace(qpos=jnp.asarray(qpos)),
      task=jstate.task.replace(goal=jnp.asarray(goal),
                               solve_start_time=jnp.asarray(start)))
  act = np.zeros((_NB, penv.model.nu))
  jnew, jts = jax_step[0](jstate, jnp.asarray(act))
  state, ts = penv.step(_port_state(jstate), torch.as_tensor(act))
  _compare_step(state, ts, jnew, jts)
  np.testing.assert_array_equal(ts.step_type.numpy(), [2, 2, 2])
  np.testing.assert_array_equal(ts.discount.numpy(), [1.0, 0.0, 1.0])
  np.testing.assert_array_equal(state.task.failure_termination.numpy(),
                                [True, False, False])
  np.testing.assert_array_equal(state.task.successes.numpy(), [0, 1, 0])
  np.testing.assert_array_equal(
      state.task.exceeded_single_goal_time.numpy(), [False, False, True])


# ---------------------------------------------------------------------------
# 7. manipulation.load and the interactive wrapper
# ---------------------------------------------------------------------------


def test_load_names_and_errors():
  assert pmanip.ALL_TASKS == jmanip.ALL_TASKS
  assert pmanip.ALL_NAMES == jmanip.ALL_NAMES
  assert pmanip.TASKS_BY_DOMAIN == jmanip.TASKS_BY_DOMAIN
  assert ('reorient', 'state_dense') in pmanip.ALL_TASKS
  with pytest.raises(ValueError, match='Unknown domain'):
    pmanip.load('nope', 'state_dense', **F64)
  with pytest.raises(ValueError, match='Unknown task'):
    pmanip.load('reorient', 'nope', **F64)


def test_load_time_limit_and_obs_buffer_dim():
  env = pmanip.load('reorient', 'state_dense', time_limit=0.05,
                    strip_singleton_obs_buffer_dim=False, **F64)
  assert env._step_limit == 2
  assert env.model.device == torch.device('cpu')
  assert env.model.dtype == torch.float64
  spec = env.observation_spec()
  assert spec['goal_state'].shape == (1, 4)
  assert spec['shadow_hand_e/joint_positions_sin_cos'].shape == (1, 48)
  state, ts = env.reset(torch.Generator().manual_seed(0), (2,))
  assert ts.observation['goal_state'].shape == (2, 1, 4)
  act = torch.zeros(2, env.model.nu, dtype=torch.float64)
  state, ts = env.step(state, act)
  np.testing.assert_array_equal(ts.step_type.numpy(), [1, 1])
  state, ts = env.step(state, act)
  np.testing.assert_array_equal(ts.step_type.numpy(), [2, 2])
  assert pmanip.load('reorient', 'state_dense', **F64)._step_limit is None


def test_interactive_environment_runs_an_episode_to_last():
  env = pmanip.load_interactive('reorient', 'state_dense', seed=3,
                                time_limit=0.05, **F64)
  spec = env.action_spec()
  ts = env.reset()
  assert int(ts.step_type) == 0 and isinstance(ts.reward, np.ndarray)
  types_seen = [int(ts.step_type)]
  for _ in range(2):
    ts = env.step(np.zeros(spec.shape))
    types_seen.append(int(ts.step_type))
    assert np.isfinite(ts.observation['prop/position']).all()
  assert types_seen == [0, 1, 2]
  assert int(env.step(np.zeros(spec.shape)).step_type) == 0  # new episode
  assert bool(env.state.task.goal_ok)


# ---------------------------------------------------------------------------
# 8. BatchedEnvironment and the episode metrics
# ---------------------------------------------------------------------------


def test_batched_environment_resets_finished_rows_only(envs, jax_reset):
  penv, qa = envs['penv'], envs['ptask']._prop_qadr
  benv = pbatched.BatchedEnvironment(penv, _NB)
  state = _port_state(jax_reset['state'])
  qpos = state.data.qpos.clone()
  qpos[1, qa:qa + 3] = torch.tensor([0.3, 0.3, 0.019])   # falls: LAST
  state = state.replace(data=state.data.replace(qpos=qpos))
  act = torch.zeros(_NB, penv.model.nu, dtype=torch.float64)
  gen = torch.Generator().manual_seed(8)
  plain, pts = penv.step(state, act)
  metrics = pmetrics.init(_NB, torch.float64)
  new, ts, metrics = benv.step_with_metrics(state, act, metrics, gen)
  np.testing.assert_array_equal(ts.step_type.numpy(), [1, 2, 1])
  keep = torch.tensor([True, False, True])
  # The others are untouched: exactly the plain step's rows.
  structs.tree_map(lambda a, b: torch.testing.assert_close(
      a[keep], b[keep], rtol=0, atol=0), new, plain)
  # The finished row holds a new episode.
  assert int(new.step_count[1]) == 0 and bool(new.task.goal_changed[1])
  assert abs(float(new.data.qpos[1, qa + 2]) - 0.16) < 1e-3
  assert pmetrics.summary(metrics)['episodes'] == 1
  # step() alone: the same merge, without metrics.
  new2, _ = benv.step(state, act, torch.Generator().manual_seed(8))
  _close(new2.data.qpos, new.data.qpos, 0, 0)
  first, fts = benv.reset(torch.Generator().manual_seed(1))
  assert first.data.qpos.shape == (_NB, penv.model.nq)


def test_metrics_update_matches_jax():
  rng = np.random.default_rng(51)
  jm = jmetrics.init(4, jnp.float64)
  pm = pmetrics.init(4, torch.float64)
  for _ in range(5):
    reward = rng.normal(size=4)
    done = rng.uniform(size=4) < 0.4
    succ = rng.integers(0, 2, size=4).astype(np.int32)
    jm = jmetrics.update(jm, jnp.asarray(reward), jnp.asarray(done),
                         jnp.asarray(succ))
    pm = pmetrics.update(pm, torch.as_tensor(reward), torch.as_tensor(done),
                         torch.as_tensor(succ))
  for f, w in _tree_np(jm).items():
    _close(getattr(pm, f), w, 1e-12, 1e-12, f)
  assert pmetrics.summary(pm) == pytest.approx(jmetrics.summary(jm))


# ---------------------------------------------------------------------------
# 9. A planner solve from reset's state
# ---------------------------------------------------------------------------


def test_solve_batch_accepts_the_environment_data(envs):
  """solve_batch on reset's Data (the environment model: contact budget
  64) gives the same actions and returns as the same start carried into a
  planning-model Data (budget 16), under injected noise."""
  penv = envs['penv']
  planner = pps.PredictiveSampling(
      envs['ptask'], pps.PredictiveSamplingConfig(
          horizon=2, num_samples=4, iterations=1, plan_substeps=3), **F64)
  state, _ = penv.reset(torch.Generator().manual_seed(11), (2,))
  npoint = {d: PT.num_contact_points(m) for d, m in
            (('env', penv.model), ('plan', planner.model))}
  assert state.data.contact.dist.shape[-1] == npoint['env'] > npoint['plan']
  carried = PT.make_data(planner.model, (2,)).replace(**{
      f: getattr(state.data, f) for f in (
          'time', 'qpos', 'qvel', 'qacc', 'ctrl', 'qfrc_applied',
          'xfrc_applied', 'mocap_pos', 'mocap_quat')})
  noise = 0.3 * torch.as_tensor(np.random.default_rng(61).normal(
      size=(2 * 3, 2, planner.nu)))
  planner._sample_noise = lambda gen, n: noise[:n]
  out = []
  for data in (state.data, carried):
    out.append(planner.solve_batch(data, state.task.goal,
                                   planner.init_state(streams=2),
                                   torch.Generator()))
  (a1, s1), (a2, s2) = out
  _close(a1, a2, 0, 1e-12)
  _close(s1.best_return, s2.best_return, 1e-12, 1e-12)
  assert bool(torch.isfinite(s1.best_return).all())
