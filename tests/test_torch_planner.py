"""Predictive-sampling planner of the PyTorch port against the JAX package.

Both planners run on the CPU in float64 from identical inputs: seeded
reorient states (hand joints in a band around 0, cube at the spawn
workspace centre with a seeded orientation, advanced a few control steps
by the port so the cube rests in contact), seeded goals, seeded
candidate actions.  The noise of `solve_batch` is injected: both
instances' `_sample_noise` return the same numpy noise, since JAX's
threefry streams and torch's generators differ.  The comparison runs
module by module (action spec, goal, reward, failure proxy) and then the
slice as a whole (`rollout_returns_flat`, `solve_batch`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation
from dexterity_tpu.core import types as JT
from dexterity_tpu.planners import predictive_sampling as jps
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.manipulation.goals import prop_orientation
from dexterity_tpu_torch.manipulation.shared import rewards as prewards
from dexterity_tpu_torch.physics import step as pstep
from dexterity_tpu_torch.planners import predictive_sampling as pps
from dexterity_tpu_torch.utils import specs as pspecs

_G, _N, _H = 2, 4, 2
_CFG = dict(horizon=_H, num_samples=_N, iterations=2, plan_substeps=3)


def _start_qpos(pm, rng, batch, band=0.3):
  qpos = np.repeat(pm.qpos0.numpy()[None], batch, 0)
  for j in range(pm.njnt):
    if pm.jnt_type[j] == int(PT.JointType.HINGE) and pm.jnt_limited[j]:
      lo, hi = pm.jnt_range[j].tolist()
      mid = min(max(0.0, lo), hi)
      qpos[:, pm.jnt_qposadr[j]] = np.clip(
          mid + band * (hi - lo) * rng.uniform(-0.5, 0.5, batch), lo, hi)
  free = [j for j in range(pm.njnt)
          if pm.jnt_type[j] == int(PT.JointType.FREE)][0]
  qa = pm.jnt_qposadr[free]
  qpos[:, qa:qa + 3] = (0.0, -0.13, 0.16)
  q = rng.normal(size=(batch, 4))
  qpos[:, qa + 3:qa + 7] = q / np.linalg.norm(q, axis=1, keepdims=True)
  return qpos


@pytest.fixture(scope='module')
def scene():
  jtask = manipulation.build_task('reorient', 'state_dense')
  ptask = pmanip.build_task('reorient', 'state_dense')
  jplanner = jps.PredictiveSampling(jtask, jps.PredictiveSamplingConfig(
      **_CFG))
  pplanner = pps.PredictiveSampling(ptask, pps.PredictiveSamplingConfig(
      **_CFG), device='cpu', dtype=torch.float64)
  pm = pplanner.model
  rng = np.random.default_rng(11)
  d = PT.make_data(pm, (_G,)).replace(
      qpos=torch.as_tensor(_start_qpos(pm, rng, _G)))
  mid = (pplanner._lo + pplanner._hi) / 2
  for _ in range(4):
    d = d.replace(ctrl=mid.expand(_G, -1).clone())
    d = pstep.step_n_b(pm, d, 3, refresh='none', midphase='per_call',
                       carry='minimal')
  state = {f: getattr(d, f).numpy() for f in ('qpos', 'qvel', 'qacc')}
  goals = rng.normal(size=(_G, 4))
  goals /= np.linalg.norm(goals, axis=1, keepdims=True)
  return dict(jtask=jtask, ptask=ptask, jp=jplanner, pp=pplanner,
              state=state, goals=goals, rng=rng)


def _pdata(pm, state):
  b = state['qpos'].shape[0]
  return PT.make_data(pm, (b,)).replace(
      **{k: torch.as_tensor(v) for k, v in state.items()})


def _jdata(jm, state):
  b = state['qpos'].shape[0]
  d = JT.make_data(jm)
  d = jax.tree_util.tree_map(
      lambda x: jnp.broadcast_to(x[None], (b,) + x.shape), d)
  return d.replace(**{k: jnp.asarray(v) for k, v in state.items()})


def _repeat(state, n):
  return {k: np.repeat(v, n, axis=0) for k, v in state.items()}


def test_action_spec_matches_jax(scene):
  jp, pp = scene['jp'], scene['pp']
  jspec = scene['jtask'].action_spec(jp.model)
  pspec = scene['ptask'].action_spec(pp.model)
  assert isinstance(pspec, pspecs.BoundedArray)
  assert pspec.shape == jspec.shape == (20,)
  assert pspec.name == jspec.name
  np.testing.assert_array_equal(pspec.minimum, jspec.minimum)
  np.testing.assert_array_equal(pspec.maximum, jspec.maximum)
  assert pp.nu == jp.nu == 20
  np.testing.assert_array_equal(pp._act_ids, jp._act_ids)
  assert (scene['ptask'].effector_slices(pp.model)
          == scene['jtask'].effector_slices(jp.model))
  np.testing.assert_array_equal(pp._lo.numpy(), np.asarray(jp._lo))
  np.testing.assert_array_equal(pp._hi.numpy(), np.asarray(jp._hi))
  init = pp.init_state()
  np.testing.assert_array_equal(init.nominal.numpy(),
                                np.asarray(jp.init_state().nominal))
  assert init.best_return.item() == -np.inf
  assert pp.init_state(streams=3).nominal.shape == (3, _H, 20)


def test_merge_specs_matches_jax():
  from dexterity_tpu.utils import specs as jspecs

  def make(mod, n, lo, name):
    return mod.BoundedArray(shape=(n,), dtype=np.float64, name=name,
                            minimum=np.full(n, lo), maximum=np.full(n, 1.0))

  for mod in (jspecs, pspecs):
    with pytest.raises(ValueError):
      mod.merge_specs([])
  a = jspecs.merge_specs([make(jspecs, 2, -1.0, 'a0\ta1'),
                          make(jspecs, 1, -2.0, None)])
  b = pspecs.merge_specs([make(pspecs, 2, -1.0, 'a0\ta1'),
                          make(pspecs, 1, -2.0, None)])
  assert (a.shape, a.name) == (b.shape, b.name)
  np.testing.assert_array_equal(a.minimum, b.minimum)


def test_goal_distance_and_current_state_match_jax(scene):
  """current_state reads (and normalises) the free joint's quaternion;
  goal_distance is the rotation angle, the same for q and -q."""
  jgen = scene['jtask'].goal_generator
  pgen = scene['ptask'].goal_generator
  jm, pm = scene['jp'].model, scene['pp'].model
  rng = np.random.default_rng(3)
  state = {'qpos': _start_qpos(pm, rng, 6)}
  qa = scene['pp'].task._prop_qadr
  state['qpos'][:, qa + 3:qa + 7] *= rng.uniform(0.5, 2.0, (6, 1))
  goals = rng.normal(size=(6, 4))
  goals /= np.linalg.norm(goals, axis=1, keepdims=True)
  goals[1] = -state['qpos'][1, qa + 3:qa + 7] / np.linalg.norm(
      state['qpos'][1, qa + 3:qa + 7])                   # -q of the cube
  jd, pd = _jdata(jm, state), _pdata(pm, state)
  jcur = jax.vmap(lambda d: jgen.current_state(jm, d))(jd)
  pcur = pgen.current_state(pm, pd)
  np.testing.assert_allclose(pcur.numpy(), np.asarray(jcur), rtol=1e-14,
                             atol=1e-15)
  jdist = jax.vmap(jgen.goal_distance)(jnp.asarray(goals), jcur)
  pdist = pgen.goal_distance(torch.as_tensor(goals), pcur)
  assert pdist.shape == (6, 1)
  np.testing.assert_allclose(pdist.numpy(), np.asarray(jdist), rtol=1e-12,
                             atol=1e-12)
  assert pdist[1, 0].item() < 1e-6
  # The sign of either quaternion does not change the distance.
  np.testing.assert_allclose(
      pgen.goal_distance(-torch.as_tensor(goals), pcur).numpy(),
      pdist.numpy(), atol=1e-12)
  np.testing.assert_allclose(
      pgen.goal_distance(torch.as_tensor(goals), -pcur).numpy(),
      pdist.numpy(), atol=1e-12)


def test_uniform_quaternion_and_next_goal():
  gen = torch.Generator().manual_seed(0)
  q = prop_orientation.uniform_quaternion(gen, (4096,), torch.float64)
  np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-12)
  # Uniform on the unit 3-sphere: w has density (2/pi) sqrt(1 - w^2), so
  # E|w| = 4 / (3 pi), and each sign is equally likely.
  assert abs(q[:, 0].abs().mean().item() - 4 / (3 * np.pi)) < 0.02
  assert abs((q[:, 0] > 0).double().mean().item() - 0.5) < 0.03
  again = prop_orientation.uniform_quaternion(
      torch.Generator().manual_seed(0), (4096,), torch.float64)
  torch.testing.assert_close(q, again, rtol=0, atol=0)
  ptask = pmanip.build_task('reorient', 'state_dense')
  pm = ptask.compile(device='cpu', dtype=torch.float64)
  d = PT.make_data(pm, (3,))
  goal, d2, ok = ptask.goal_generator.next_goal(pm, d, gen)
  assert goal.shape == (3, 4) and d2 is d and bool(ok.all())


def test_reward_and_rollout_failure_match_jax(scene):
  jtask, ptask = scene['jtask'], scene['ptask']
  jm, pm = scene['jp'].model, scene['pp'].model
  rng = np.random.default_rng(5)
  state = {'qpos': _start_qpos(pm, rng, 6),
           'ctrl': rng.uniform(-1, 1, (6, pm.nu))}
  qa = ptask._prop_qadr
  state['qpos'][:, qa + 2] = [0.16, 0.03, 0.05, 0.039, 0.041, -0.1]
  goals = scene['goals'][np.arange(6) % _G]
  goals[2] = state['qpos'][2, qa + 3:qa + 7]             # success bonus
  jd, pd = _jdata(jm, state), _pdata(pm, state)
  jgen, pgen = jtask.goal_generator, ptask.goal_generator

  def jreward(d, g):
    dist = jgen.goal_distance(g, jgen.current_state(jm, d))
    return (jtask.get_reward(jm, d, jps._reward_state(g, dist)),
            jtask.rollout_failure(jm, d))

  jr, jf = jax.vmap(jreward)(jd, jnp.asarray(goals))
  dist = pgen.goal_distance(torch.as_tensor(goals),
                            pgen.current_state(pm, pd))
  pr = ptask.get_reward(pm, pd, pps._RewardState(torch.as_tensor(goals),
                                                 dist))
  pf = ptask.rollout_failure(pm, pd)
  np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-12)
  np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
  np.testing.assert_array_equal(
      pf.numpy(), [False, True, False, True, False, True])
  assert pr[2].item() > 800.0
  np.testing.assert_array_equal(
      prewards.tolerance(torch.tensor([-0.1, 0.0, 0.05, 0.1, 0.2]), 0.0,
                         0.1).numpy(), [0, 1, 1, 1, 0])


@pytest.fixture(scope='module')
def flat_inputs(scene):
  """2 streams x 4 candidates: per-candidate data, goals, actions."""
  pp = scene['pp']
  m = _G * _N
  rng = np.random.default_rng(7)
  lo, hi = pp._lo.numpy(), pp._hi.numpy()
  acts = lo + (hi - lo) * rng.uniform(0.1, 0.9, (m, _H, pp.nu))
  acts[0, 0, 0] = hi[0] + 1.0                 # clipped by the rollout
  return (_repeat(scene['state'], _N),
          np.repeat(scene['goals'], _N, axis=0), acts)


# Two control steps of contact dynamics (6 planning substeps): the
# trajectories agree as in tests/test_torch_physics.py's step_n_b
# comparison (qpos to ~1e-6 relative), and the returns, smooth functions
# of the cube orientation, to the same relative order (measured 3.5e-11).
_RET_RTOL = 1e-6


def test_rollout_returns_flat_matches_jax(scene, flat_inputs):
  jp, pp = scene['jp'], scene['pp']
  state, goals, acts = flat_inputs
  ref = jax.jit(jp.rollout_returns_flat)(
      _jdata(jp.model, state), jnp.asarray(goals), jnp.asarray(acts))
  got = pp.rollout_returns_flat(_pdata(pp.model, state),
                                torch.as_tensor(goals), torch.as_tensor(acts))
  assert got.shape == (_G * _N,)
  assert np.isfinite(got.numpy()).all()
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=_RET_RTOL,
                             atol=1e-9)


def test_solve_batch_matches_jax_with_injected_noise(scene):
  """Two CEM iterations with the same noise on both sides: the same
  chosen plans, actions, shifted nominal and best returns."""
  jp, pp = scene['jp'], scene['pp']
  rng = np.random.default_rng(9)
  noise = 0.3 * rng.normal(size=(2, _N - 1, _H, pp.nu))
  calls = {'j': 0, 'p': 0}

  def jnoise(key, n):
    # Traced once per iteration (solve_batch's Python loop); every stream
    # gets the same noise.
    del key
    i = calls['j']
    calls['j'] += 1
    return jnp.asarray(noise[i][:n])

  def pnoise(gen, n):
    del gen
    i = calls['p']
    calls['p'] += 1
    return torch.as_tensor(np.tile(noise[i], (n // (_N - 1), 1, 1)))

  jp._sample_noise = jnoise
  pp._sample_noise = pnoise
  try:
    state = scene['state']
    nominal = np.asarray(jp.init_state().nominal)[None].repeat(_G, 0)
    nominal = nominal + 0.05 * rng.normal(size=nominal.shape)
    jst = jps.PlannerState(nominal=jnp.asarray(nominal),
                           best_return=jnp.full((_G,), -jnp.inf))
    ja, jnew = jax.jit(jp.solve_batch)(
        _jdata(jp.model, state), jnp.asarray(scene['goals']), jst,
        jax.random.split(jax.random.PRNGKey(0), _G))
    pst = pps.PlannerState(nominal=torch.as_tensor(nominal),
                           best_return=torch.full((_G,), -np.inf,
                                                  dtype=torch.float64))
    pa, pnew = pp.solve_batch(_pdata(pp.model, state),
                              torch.as_tensor(scene['goals']), pst,
                              torch.Generator().manual_seed(0))
  finally:
    del jp._sample_noise, pp._sample_noise
  assert calls == {'j': 2, 'p': 2}
  np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=1e-12,
                             atol=1e-12)
  np.testing.assert_allclose(pnew.nominal.numpy(), np.asarray(jnew.nominal),
                             rtol=1e-12, atol=1e-12)
  np.testing.assert_allclose(pnew.best_return.numpy(),
                             np.asarray(jnew.best_return), rtol=_RET_RTOL)
  # Receding horizon: the nominal repeats the chosen plan's last action.
  torch.testing.assert_close(pnew.nominal[:, -1], pnew.nominal[:, -2],
                             rtol=0, atol=0)
  assert pa.shape == (_G, pp.nu)


def test_sample_noise_is_spline_smoothed(scene):
  pp = scene['pp']
  gen = torch.Generator().manual_seed(1)
  cfg = pps.PredictiveSamplingConfig(horizon=10, num_knots=4)
  planner = pps.PredictiveSampling(scene['ptask'], cfg, device='cpu',
                                   dtype=torch.float64)
  z = planner._sample_noise(gen, 5)
  assert z.shape == (5, 10, pp.nu)
  # Linear between knots at t = 0, 3, 6, 9: constant second differences
  # inside each segment.
  d2 = z[:, 2:] - 2 * z[:, 1:-1] + z[:, :-2]
  inside = [0, 1, 3, 4, 6, 7]
  assert d2[:, inside].abs().max().item() < 1e-12
  white = pps.PredictiveSampling(
      scene['ptask'], pps.PredictiveSamplingConfig(horizon=3, num_knots=0),
      device='cpu', dtype=torch.float64)._sample_noise(gen, 2)
  assert white.shape == (2, 3, pp.nu)
  # batched_rollouts=False builds and solves (per-candidate rollouts).
  per_cand = pps.PredictiveSampling(
      scene['ptask'], pps.PredictiveSamplingConfig(
          batched_rollouts=False, **_CFG), device='cpu', dtype=torch.float64)
  one = {k: v[:1] for k, v in scene['state'].items()}
  data = PT.make_data(per_cand.model).replace(
      **{k: torch.as_tensor(v[0]) for k, v in one.items()})
  action, st = per_cand.solve(data, torch.as_tensor(scene['goals'][0]),
                              per_cand.init_state(), gen)
  assert action.shape == (pp.nu,) and st.nominal.shape == (_H, pp.nu)
  assert bool(torch.isfinite(action).all())
  assert bool(torch.isfinite(st.best_return))


@pytest.mark.parametrize('temperature', [0.0, 0.5])
def test_one_iteration_matches_jax(scene, temperature):
  """Both update rules (argmax with first-index ties; MPPI average) on
  injected noise and injected candidate returns."""
  import dataclasses
  jp, pp = scene['jp'], scene['pp']
  rng = np.random.default_rng(13)
  noise = 0.4 * rng.normal(size=(_N - 1, _H, pp.nu))
  returns = np.array([1.0, 3.0, 3.0, 2.0])           # a tie at the top
  nominal = np.asarray(jp.init_state().nominal) + 0.1
  saved = (jp.config, pp.config)
  jp.config = dataclasses.replace(jp.config, temperature=temperature)
  pp.config = dataclasses.replace(pp.config, temperature=temperature)
  jp._sample_noise = lambda key, n: jnp.asarray(noise)
  pp._sample_noise = lambda gen, n: torch.as_tensor(noise)
  jp.rollout_returns_batched = lambda d, g, c: jnp.asarray(returns)
  pp.rollout_returns_batched = lambda d, g, c: torch.as_tensor(returns)
  try:
    jseq, jret = jp._one_iteration(None, None, jnp.asarray(nominal),
                                   jax.random.PRNGKey(0), 0.7)
    pseq, pret = pp._one_iteration(None, None, torch.as_tensor(nominal),
                                   torch.Generator(), 0.7)
  finally:
    jp.config, pp.config = saved
    for planner in (jp, pp):
      del planner._sample_noise, planner.rollout_returns_batched
  np.testing.assert_allclose(pseq.numpy(), np.asarray(jseq), rtol=1e-12,
                             atol=1e-14)
  assert pret.item() == float(jret) == 3.0
  if temperature == 0.0:
    want = np.clip(nominal + 0.7 * noise[0], pp._lo.numpy(),
                   pp._hi.numpy())
    np.testing.assert_allclose(pseq.numpy(), want, atol=1e-14)
