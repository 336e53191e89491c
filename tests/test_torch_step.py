"""The port's per-environment step, forward pass and refresh kinematics
against the JAX package.

Both sides compute in float64 on the CPU from the seeded contact-rich
reorient states of tests/torch_scene.py (carried to JAX as numpy
arrays).  Module by module: the velocity kinematics and Jacobians, the
AoS bias forces (`rne`), the AoS narrow phase (`collide_all` and each
pair test of `_KERNELS`), the dense constraint rows (`assemble`) and the
solve from data.contact; then the path as a whole: `forward`, `step`,
`step_n` in each refresh mode, `step_n_b` with a refresh, a model with a
two-hinge body, and the per-candidate planner path (`rollout_return`,
`batched_rollouts=False`).  Also the NaN start-row rule of
`rollout_returns_flat`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation
from dexterity_tpu.core import spec as JS
from dexterity_tpu.core import types as JT
from dexterity_tpu.physics import constraint as jconstraint
from dexterity_tpu.physics import kinematics as jkin
from dexterity_tpu.physics import smooth as jsmooth
from dexterity_tpu.physics import step as jstep
from dexterity_tpu.physics.collision import primitives as jprim
from dexterity_tpu.planners import predictive_sampling as jps
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import spec as PS
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.physics import constraint as pconstraint
from dexterity_tpu_torch.physics import kinematics as pkin
from dexterity_tpu_torch.physics import linalg_cuda
from dexterity_tpu_torch.physics import smooth as psmooth
from dexterity_tpu_torch.physics import step as pstep
from dexterity_tpu_torch.physics.collision import narrowphase as pnarrow
from dexterity_tpu_torch.physics.collision import primitives as pprim
from dexterity_tpu_torch.physics.collision import soa as psoa
from dexterity_tpu_torch.planners import predictive_sampling as pps
from torch_scene import B, build_scene, jdata, models, pair_inputs, pdata
from torch_scene import to_np as _np


@pytest.fixture(scope='module')
def scene():
  return build_scene()


def _with_forces(scene, which):
  """The shared state plus seeded applied wrenches (xfrc_applied)."""
  pm = models(scene, which)[1]
  s = dict(scene['state'])
  s['xfrc_applied'] = np.random.default_rng(3).normal(size=(B, pm.nbody, 6))
  return s


@pytest.fixture(scope='module')
def positions(scene):
  """Each package's step.fwd_position (FK, CRB, narrow phase) of the
  shared state on the environment model."""
  jm, pm = models(scene, 'env')
  s = _with_forces(scene, 'env')
  jd = jax.jit(jax.vmap(lambda d: jstep.fwd_position(jm, d)))(jdata(jm, s))
  return jd, pstep.fwd_position(pm, pdata(pm, s))


def _close(got, want, rtol, atol, msg=''):
  np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                             err_msg=msg)


# ---------------------------------------------------------------------------
# Velocity kinematics, Jacobians, applied forces, the inertia solve
# ---------------------------------------------------------------------------

_BODY = 20


def _kin_case(name, jm, pm, jd, pd):
  """(JAX result, port result) of kinematics/smooth function `name`."""
  rng = np.random.default_rng(4)
  if name == 'fwd_velocity_kinematics':
    j = jax.vmap(lambda d: jkin.fwd_velocity_kinematics(jm, d))(jd)
    p = pkin.fwd_velocity_kinematics(pm, pd)
    return (j.cvel, j.ten_velocity), (p.cvel, p.ten_velocity)
  if name == 'point_velocity':
    cvel = rng.normal(size=(B, 6))
    point = rng.normal(size=(B, 3))
    j = jax.vmap(lambda c, x: jkin.point_velocity(None, c, x))(
        jnp.asarray(cvel), jnp.asarray(point))
    p = pkin.point_velocity(None, torch.as_tensor(cvel),
                            torch.as_tensor(point))
    return j, p
  if name == 'jac_point':
    j = jax.vmap(lambda d: jkin.jac_point(jm, d, _BODY, d.xipos[_BODY]))(jd)
    p = pkin.jac_point(pm, pd, _BODY, pd.xipos[:, _BODY])
    return j, p
  if name == 'site_jacobian':
    ids = list(range(pm.nsite))
    j = jax.vmap(lambda d: jkin.site_jacobian(jm, d, ids))(jd)
    return (j,), (pkin.site_jacobian(pm, pd, ids),)
  if name == 'geom_planes':
    xp, xq = jnp.swapaxes(jd.xpos, 1, 2), jnp.swapaxes(jd.xquat, 1, 2)
    j = jax.vmap(lambda a, b: jkin.geom_planes(jm, a, b))(xp, xq)
    p = pkin.geom_planes(pm, pd.xpos.permute(2, 1, 0),
                         pd.xquat.permute(2, 1, 0)).movedim(-1, 0)
    return (j,), (p,)
  if name == 'xfrc_accumulate':
    j = jax.vmap(lambda d: jsmooth.xfrc_accumulate(jm, d))(jd)
    return (j,), (psmooth.xfrc_accumulate(pm, pd),)
  assert name == 'solve_m'
  vec = rng.normal(size=(B, pm.nv))
  j = jax.vmap(jsmooth.solve_m)(jd, jnp.asarray(vec))
  return (j,), (psmooth.solve_m(pd, torch.as_tensor(vec)),)


@pytest.mark.parametrize('name', [
    'fwd_velocity_kinematics', 'point_velocity', 'jac_point',
    'site_jacobian', 'geom_planes', 'xfrc_accumulate', 'solve_m'])
def test_kinematics_and_smooth_helpers_match_jax(scene, positions, name):
  jm, pm = models(scene, 'env')
  jd, pd = positions
  want, got = _kin_case(name, jm, pm, jd, pd)
  assert len(want) == len(got)
  for w, g in zip(want, got):
    assert tuple(g.shape) == tuple(w.shape), name
    _close(g, w, 0, 1e-10, name)


def test_rne_matches_jax_and_rne_planes(scene, positions):
  """The AoS bias forces against JAX's and against the port's own plane
  form, which the hot substep runs."""
  jm, pm = models(scene, 'env')
  jd, pd = positions
  j = jax.jit(jax.vmap(lambda d: jsmooth.rne(jm, d)))(jd)
  p = psmooth.rne(pm, pd)
  _close(p.qfrc_bias, j.qfrc_bias, 0, 1e-9, 'qfrc_bias')
  _close(p.cvel, j.cvel, 0, 1e-9, 'cvel')
  planes = pstep._planes_b(pm, pd)
  _close(p.qfrc_bias, planes['qfrc_bias'].movedim(-1, 0), 0, 1e-9,
         'rne_planes')


# ---------------------------------------------------------------------------
# AoS narrow phase
# ---------------------------------------------------------------------------

_CONTACT_FIELDS = ('dist', 'pos', 'frame', 'pair', 'margin')


@pytest.mark.parametrize('which', ['env', 'plan'])
def test_collide_all_matches_jax(scene, positions, which):
  """Every Contact field from the AoS geom frames: the environment model
  (833 candidate pairs, midphase 64; the contacts of each package's
  step.fwd_position, which runs collide_all) and the planning model."""
  jm, pm = models(scene, which)
  s = scene['state']
  if which == 'env':
    j, p = positions
  else:
    j = jax.jit(jax.vmap(lambda d: jprim.collide_all(
        jm, jkin.fwd_position(jm, d))))(jdata(jm, s))
    p = pprim.collide_all(pm, pkin.fwd_position(pm, pdata(pm, s)))
  assert pm.npair == (833 if which == 'env' else 212)
  for f in _CONTACT_FIELDS:
    a, b = getattr(j.contact, f), getattr(p.contact, f)
    assert tuple(b.shape) == tuple(a.shape), f
    _close(b, a, 1e-9, 1e-12, f)
  assert bool((p.contact.dist < 0).any(-1).all())


def _pendulum(S, T):
  """Two links on hinges, no geoms: a model with no candidate pairs."""
  ms = S.ModelSpec(name='pend')
  b1 = ms.worldbody.add_body('link1', pos=np.array([0.0, 0.1, 0.5]))
  b1.add_joint('j1', type=T.JointType.HINGE, axis=np.array([0.0, 1.0, 0.0]))
  b1.inertial = S.InertialSpec(pos=np.zeros(3), quat=np.array([1.0, 0, 0, 0]),
                               mass=1.0, diaginertia=np.full(3, 0.01))
  return ms


def test_collide_planes_without_pairs_matches_jax():
  """A model with no candidate pairs: collide_planes gives one unused
  slot, and narrowphase.collision leaves data as it is."""
  jm = _pendulum(JS, JT).compile()
  pm = _pendulum(PS, PT).compile(device='cpu', dtype=torch.float64)
  assert pm.npair == jm.npair == 0
  gpos = tuple(torch.zeros(2, pm.ngeom, dtype=torch.float64)
               for _ in range(3))
  gmat = tuple(torch.zeros(2, pm.ngeom, dtype=torch.float64)
               for _ in range(9))
  got = pprim.collide_planes(pm, gpos, gmat, torch.float64)
  want = jprim.collide_planes(jm, tuple(jnp.zeros(pm.ngeom) for _ in gpos),
                              tuple(jnp.zeros(pm.ngeom) for _ in gmat),
                              jnp.zeros(()), jnp.float64)
  for f in _CONTACT_FIELDS:
    a, b = np.asarray(getattr(want, f)), _np(getattr(got, f))
    assert b.shape == (2,) + a.shape, f
    np.testing.assert_array_equal(b, np.broadcast_to(a, b.shape), err_msg=f)
  assert got.pair.dtype == torch.int64
  d = PT.make_data(pm, (2,))
  assert pnarrow.collision(pm, d) is d


@pytest.mark.parametrize('tpair', sorted(
    (int(a), int(b)) for a, b in jprim._KERNELS))
def test_aos_pair_tests_match_jax_and_soa(tpair):
  """Each AoS pair test at seeded random poses: against JAX's (vmapped)
  to 1e-10, and against the port's SoA kernel (the same active points,
  as tests/test_collision_soa.py compares the JAX pair)."""
  t1, t2 = JT.GeomType(tpair[0]), JT.GeomType(tpair[1])
  jfn, jk = jprim._KERNELS[(t1, t2)]
  key = (PT.GeomType(tpair[0]), PT.GeomType(tpair[1]))
  pfn, pk = pprim._KERNELS[key]
  sfn, sk = psoa.KERNELS[key]
  assert pk == jk == sk
  args = pair_inputs(t1, t2, np.random.RandomState(tpair[0] * 10 + tpair[1]))
  want = jax.jit(jax.vmap(jfn))(*map(jnp.asarray, args))
  got = pfn(*map(torch.as_tensor, args))
  for w, g in zip(want, got):
    assert tuple(g.shape) == tuple(w.shape)
    _close(g, w, 0, 1e-10)

  def v3(a):
    return tuple(torch.as_tensor(a[:, i]) for i in range(3))

  def m3(a):
    return tuple(torch.as_tensor(a[:, i, j]) for i in range(3)
                 for j in range(3))

  p1, m1, s1, p2, m2, s2 = args
  sd, sp, sn = sfn(v3(p1), m3(m1), v3(s1), v3(p2), m3(m2), v3(s2))
  sd = _np(sd).T                                   # (n, k)
  sp = np.stack([_np(c) for c in sp], -1).transpose(1, 0, 2)
  sn = np.stack([_np(c) for c in sn], -1).transpose(1, 0, 2)
  d, p, n = map(_np, got)
  assert (d < 0).any() or t1 == JT.GeomType.PLANE
  for i in range(d.shape[0]):
    act_a = np.where(d[i] < 0)[0]
    act_s = np.where(sd[i] < 0)[0]
    assert len(act_a) == len(act_s), i
    oa = act_a[np.argsort(d[i][act_a])]
    os_ = act_s[np.argsort(sd[i][act_s])]
    np.testing.assert_allclose(d[i][oa], sd[i][os_], atol=1e-10)
    np.testing.assert_allclose(p[i][oa], sp[i][os_], atol=1e-8)
    np.testing.assert_allclose(n[i][oa], sn[i][os_], atol=1e-8)


def test_tangent_frame_matches_jax():
  nrm = np.random.default_rng(6).normal(size=(64, 3))
  nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
  nrm[:4] = np.eye(3)[[0, 1, 2, 0]] * [[1], [1], [1], [-1]]
  _close(pprim._tangent_frame(torch.as_tensor(nrm)),
         jprim._tangent_frame(jnp.asarray(nrm)), 0, 1e-12)


# ---------------------------------------------------------------------------
# Constraint rows and solve from data.contact
# ---------------------------------------------------------------------------


def _carried(jm, pd, s):
  """JAX Data holding the port's derived fields (identical inputs)."""
  fields = ('qM', 'cdof', 'ten_length', 'ten_velocity', 'xipos',
            'xfrc_applied')
  jd = jdata(jm, s).replace(**{k: jnp.asarray(_np(getattr(pd, k)))
                               for k in fields})
  c = pd.contact
  return jd.replace(contact=JT.Contact(
      dist=jnp.asarray(_np(c.dist)), pos=jnp.asarray(_np(c.pos)),
      frame=jnp.asarray(_np(c.frame)),
      pair=jnp.asarray(_np(c.pair).astype(np.int32)),
      margin=jnp.asarray(_np(c.margin))))


@pytest.fixture(scope='module')
def carried(scene, positions):
  jm, pm = models(scene, 'env')
  pd = pstep.fwd_velocity(pm, positions[1])
  return _carried(jm, pd, _with_forces(scene, 'env')), pd


def test_assemble_matches_jax(scene, carried):
  """Every Rows field, on identical inputs (contacts from data.contact)."""
  jm, pm = models(scene, 'env')
  jd, pd = carried
  want = jax.jit(jax.vmap(lambda d: jconstraint.assemble(jm, d)))(jd)
  got = pconstraint.assemble(pm, pd)
  for f in ('J', 'aref', 'd', 'invweight', 'fl'):
    a, b = getattr(want, f), getattr(got, f)
    assert tuple(b.shape) == tuple(a.shape), f
    _close(b, a, 1e-9, 1e-9, f)
  static = jconstraint.assemble(jm, jax.tree_util.tree_map(lambda x: x[0],
                                                          jd))
  np.testing.assert_array_equal(got.kind, static.kind)
  np.testing.assert_array_equal(got.transmitted, static.transmitted)
  assert got.J.shape[-2] > 2 * 64                 # contact rows present


def test_solve_from_data_contact_matches_jax(scene, carried):
  """constraint.solve with contact_groups=None (the forward pass's form),
  exact Newton (K3's plain version here), on identical inputs."""
  jm, pm = models(scene, 'env')
  jd, pd = carried
  qfrc = np.random.default_rng(5).normal(size=(B, pm.nv))
  linalg_cuda.reset_launches()
  got = pconstraint.solve(pm, pd, torch.as_tensor(qfrc))
  want = jax.jit(jax.vmap(lambda d, q: jconstraint.solve(jm, d, q)))(
      jd, jnp.asarray(qfrc))
  for f in ('qacc', 'qfrc_constraint', 'qfrc_constraint_axis'):
    _close(getattr(got, f), getattr(want, f), 1e-6, 1e-6, f)
  assert sum(linalg_cuda.launches.values()) == 0   # CPU: plain versions


# ---------------------------------------------------------------------------
# forward, step, step_n, step_n_b
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def forward_ref(scene):
  """JAX's forward and step on the environment model (one program)."""
  jm, _ = models(scene, 'env')
  return jax.jit(jax.vmap(lambda d: (jstep.forward(jm, d),
                                     jstep.step(jm, d))))(
      jdata(jm, _with_forces(scene, 'env')))


def test_forward_matches_jax(scene, forward_ref):
  """forward on the environment model, at test_step_hot_b_matches_jax's
  tolerances for qacc."""
  jm, pm = models(scene, 'env')
  want = forward_ref[0]
  got = pstep.forward(pm, pdata(pm, _with_forces(scene, 'env')))
  for f in ('xpos', 'geom_xmat', 'site_xpos', 'cdof', 'qM', 'cvel',
            'qfrc_bias', 'qfrc_actuator', 'qfrc_passive'):
    _close(getattr(got, f), getattr(want, f), 1e-9, 1e-10, f)
  _close(got.qacc, want.qacc, 1e-4, 1e-3, 'qacc')
  _close(got.qfrc_constraint, want.qfrc_constraint, 1e-4, 1e-3)


def test_step_matches_jax(scene, forward_ref):
  """One environment-model step (forward + Euler damping solve), at
  test_step_hot_b_matches_jax's tolerances."""
  jm, pm = models(scene, 'env')
  want = forward_ref[1]
  got = pstep.step(pm, pdata(pm, _with_forces(scene, 'env')))
  _close(got.qpos, want.qpos, 1e-6, 1e-8, 'qpos')
  _close(got.qvel, want.qvel, 1e-5, 1e-6, 'qvel')
  _close(got.qacc, want.qacc, 1e-4, 1e-3, 'qacc')
  _close(got.time, want.time, 0, 1e-12, 'time')


_REFRESH = ('none', 'position', 'full')


def _check_refreshed(got, want, refresh, before):
  """test_step_n_b_matches_jax's tolerances; frames and contacts at the
  qpos tolerance, body velocities at the qvel tolerance.

  `want` is JAX's refresh='full' result: its three modes run the same
  substeps, and 'position' is 'full' less the narrow phase and the
  velocities, so one reference program serves each mode.  Under 'none'
  the derived fields keep their values from before the call."""
  _close(got.qpos, want.qpos, 1e-5, 1e-6, 'qpos')
  _close(got.qvel, want.qvel, 1e-4, 1e-4, 'qvel')
  _close(got.time, want.time, 0, 1e-12, 'time')
  frames = ('xpos', 'xquat', 'geom_xpos', 'geom_xmat', 'site_xpos', 'cdof')
  if refresh == 'none':
    for f in frames + ('cvel',):
      assert getattr(got, f) is getattr(before, f), f
    assert got.contact is before.contact
    return
  for f in frames:
    _close(getattr(got, f), getattr(want, f), 1e-5, 1e-6, f)
  if refresh == 'position':
    assert got.contact is before.contact and got.cvel is before.cvel
    return
  _close(got.contact.dist, want.contact.dist, 1e-5, 1e-6, 'dist')
  np.testing.assert_array_equal(_np(got.contact.pair),
                                np.asarray(want.contact.pair))
  _close(got.cvel, want.cvel, 1e-4, 1e-4, 'cvel')


@pytest.fixture(scope='module')
def step_n_ref(scene):
  """JAX's step_n(n=2, refresh='full') on the planning model."""
  jm, _ = models(scene, 'plan')
  return jax.jit(jax.vmap(lambda d: jstep.step_n(jm, d, 2, refresh='full')))(
      jdata(jm, scene['state']))


@pytest.mark.parametrize('refresh', _REFRESH)
def test_step_n_matches_jax(scene, step_n_ref, refresh):
  jm, pm = models(scene, 'plan')
  before = pdata(pm, scene['state'])
  got = pstep.step_n(pm, before, 2, refresh=refresh)
  _check_refreshed(got, step_n_ref, refresh, before)


@pytest.fixture(scope='module')
def step_n_b_ref(scene):
  """JAX's step_n_b as the planner runs it (per-call midphase, minimal
  carry), 3 substeps, refresh='full'."""
  jm, _ = models(scene, 'plan')
  return jax.jit(lambda d: jstep.step_n_b(
      jm, d, 3, refresh='full', midphase='per_call', carry='minimal'))(
          jdata(jm, scene['state']))


@pytest.mark.parametrize('refresh', ['position', 'full'])
def test_step_n_b_refresh_matches_jax(scene, step_n_b_ref, refresh):
  """The planner's step_n_b with a refresh after its substeps."""
  jm, pm = models(scene, 'plan')
  before = pdata(pm, scene['state'])
  got = pstep.step_n_b(pm, before, 3, refresh=refresh, midphase='per_call',
                       carry='minimal')
  _check_refreshed(got, step_n_b_ref, refresh, before)


def test_step_n_unbatched_equals_batched_row(scene):
  """step_n on one environment's Data (no batch axis) against row 0 of
  the batched call, on the planning model: 1e-12."""
  pm = scene['pplan']
  d = pdata(pm, scene['state'])
  batched = pstep.step_n(pm, d, 2, refresh='full')
  one = pstep.step_n(pm, PT.map_data(d, lambda x: x[0]), 2, refresh='full')
  assert one.qpos.shape == (pm.nq,) and one.time.shape == ()
  assert one.contact.dist.shape == batched.contact.dist.shape[1:]
  for f in ('time', 'qpos', 'qvel', 'qacc', 'xpos', 'cvel'):
    _close(getattr(one, f), getattr(batched, f)[0], 1e-12, 1e-12, f)
  _close(one.contact.dist, batched.contact.dist[0], 1e-12, 1e-12)


# Limits of an unbatched forward + step_n(2, 'full') against row 0 on the
# environment model, where the two differ by rounding (a batch of 4 and a
# batch of 1 reduce in a different order, and the exact Newton solve of
# the stiff contacts amplifies it).  Readings on this CPU in float64:
# forward qacc 3.9e-7; after the step qpos 6.9e-11, qvel 9.1e-9, cvel
# 7.1e-9, qacc 2.5e-6 (of 271), xpos 3.5e-13, contact.dist 4.2e-12.
_ENV_ROW_ATOL = {'qpos': 1e-8, 'qvel': 1e-6, 'cvel': 1e-6, 'qacc': 1e-4,
                 'xpos': 1e-10, 'geom_xpos': 1e-10}


def test_step_n_unbatched_env_model_within_rounding_of_row(scene):
  """forward and step_n(2, 'full') on one environment's Data (no batch
  axis) against row 0 of the batched calls on the environment model, the
  model GoalEnvironment.reset and .step run: within _ENV_ROW_ATOL."""
  pm = scene['penv']
  d = pdata(pm, scene['state'])
  fwd = pstep.forward(pm, d)
  batched = pstep.step_n(pm, fwd, 2, refresh='full')
  fwd_one = pstep.forward(pm, PT.map_data(d, lambda x: x[0]))
  one = pstep.step_n(pm, fwd_one, 2, refresh='full')
  assert one.qpos.shape == (pm.nq,) and one.time.shape == ()
  _close(fwd_one.qacc, fwd.qacc[0], 0, _ENV_ROW_ATOL['qacc'], 'forward qacc')
  _close(one.time, batched.time[0], 0, 0, 'time')
  for f, atol in _ENV_ROW_ATOL.items():
    _close(getattr(one, f), getattr(batched, f)[0], 0, atol, f)
  _close(one.contact.dist, batched.contact.dist[0], 0, 1e-10, 'dist')


def test_step_hot_matches_step_hot_b_row(scene):
  """step_hot (the per-environment plane-form substep) on one
  environment is step_hot_b's arithmetic on a batch of one."""
  pm = scene['penv']
  d = pdata(pm, scene['state'])
  one = pstep.step_hot(pm, PT.map_data(d, lambda x: x[1]))
  ref = pstep.step_hot_b(pm, PT.map_data(d, lambda x: x[1:2]))
  for f in ('qpos', 'qvel', 'qacc'):
    torch.testing.assert_close(getattr(one, f), getattr(ref, f)[0], rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# A body with two joints
# ---------------------------------------------------------------------------


def _two_hinge(S, T):
  """A two-hinge arm (one body), a free box and a floor plane."""
  ms = S.ModelSpec(name='two_hinge')
  ms.option.timestep = 0.005
  ms.worldbody.add_geom('floor', type=T.GeomType.PLANE,
                        size=np.array([1.0, 1.0, 0.1]))
  arm = ms.worldbody.add_body('arm', pos=np.array([0.0, 0.0, 0.3]))
  arm.add_joint('h1', type=T.JointType.HINGE, axis=np.array([0.0, 1.0, 0.0]),
                pos=np.array([0.0, 0.0, 0.05]), damping=0.1, armature=0.01)
  arm.add_joint('h2', type=T.JointType.HINGE, axis=np.array([1.0, 0.0, 0.3]),
                pos=np.array([0.01, 0.0, 0.0]), damping=0.05, armature=0.002)
  arm.add_geom('link', type=T.GeomType.CAPSULE, size=np.array([0.02, 0.1, 0]),
               pos=np.array([0.0, 0.0, -0.1]))
  box = ms.worldbody.add_body('box', pos=np.array([0.15, 0.02, 0.02]),
                              quat=np.array([0.9689124, 0.2474040, 0, 0]))
  box.add_joint('free', type=T.JointType.FREE)
  box.add_geom('g', type=T.GeomType.BOX, size=np.array([0.05, 0.04, 0.03]),
               mass=0.7)
  return ms


@pytest.fixture(scope='module')
def two_hinge():
  jm = _two_hinge(JS, JT).compile()
  pm = _two_hinge(PS, PT).compile(device='cpu', dtype=torch.float64)
  rng = np.random.default_rng(8)
  qpos = np.repeat(pm.qpos0.numpy()[None], 3, 0)
  qpos[:, :2] += rng.uniform(-0.5, 0.5, (3, 2))
  s = dict(qpos=qpos, qvel=rng.normal(size=(3, pm.nv)))
  return jm, pm, s


def test_two_hinge_model_matches_jax(two_hinge):
  """The port compiles a body with two joints (the general FK), and its
  fwd_position, rne and step match JAX to 1e-10."""
  jm, pm, s = two_hinge
  from dexterity_tpu_torch.physics import tree
  assert not tree.tree_tables(pm).single_jointed
  assert pm.body_jntnum[1] == 2 and pm.npair > 0
  for f in ('dof_invweight0', 'body_invweight0'):
    _close(getattr(pm, f), getattr(jm, f), 1e-10, 1e-10, f)
  jd, pd = jdata(jm, s), pdata(pm, s)
  jpos = jax.jit(jax.vmap(lambda d: jkin.fwd_position(jm, d)))(jd)
  ppos = pkin.fwd_position(pm, pd)
  for f in ('xpos', 'xquat', 'xipos', 'ximat', 'geom_xpos', 'geom_xmat',
            'cdof'):
    _close(getattr(ppos, f), getattr(jpos, f), 0, 1e-10, f)
  jrne = jax.jit(jax.vmap(lambda d: jsmooth.rne(jm, d)))(jpos)
  prne = psmooth.rne(pm, ppos)
  _close(prne.qfrc_bias, jrne.qfrc_bias, 0, 1e-10, 'qfrc_bias')
  _close(prne.cvel, jrne.cvel, 0, 1e-10, 'cvel')
  jstp = jax.jit(jax.vmap(lambda d: jstep.step(jm, d)))(jd)
  pstp = pstep.step(pm, pd)
  assert bool((pstp.contact.dist < 0).any())
  for f in ('qpos', 'qvel', 'qacc'):
    _close(getattr(pstp, f), getattr(jstp, f), 0, 1e-10, f)


# ---------------------------------------------------------------------------
# The per-candidate planner path, and the NaN start row
# ---------------------------------------------------------------------------

_N, _H = 4, 2
_CFG = dict(horizon=_H, num_samples=_N, iterations=1, plan_substeps=3)


@pytest.fixture(scope='module')
def planners(scene):
  jtask = manipulation.build_task('reorient', 'state_dense')
  ptask = pmanip.build_task('reorient', 'state_dense')
  jp = jps.PredictiveSampling(jtask, jps.PredictiveSamplingConfig(
      batched_rollouts=False, **_CFG))
  pp = pps.PredictiveSampling(ptask, pps.PredictiveSamplingConfig(
      batched_rollouts=False, **_CFG), device='cpu', dtype=torch.float64)
  # Two environments of the shared state (a planning-model state).
  state = {k: scene['state'][k][:2] for k in ('qpos', 'qvel', 'qacc')}
  goals = np.random.default_rng(12).normal(size=(2, 4))
  goals /= np.linalg.norm(goals, axis=1, keepdims=True)
  return dict(jp=jp, pp=pp, state=state, goals=goals)


def _one_env(state, i):
  return {k: v[i:i + 1] for k, v in state.items()}


def test_rollout_return_matches_jax(planners):
  """4 candidates from one environment, each through the per-env step_n
  (full carry, midphase every substep)."""
  jp, pp = planners['jp'], planners['pp']
  s = _one_env(planners['state'], 0)
  goal = planners['goals'][0]
  lo, hi = pp._lo.numpy(), pp._hi.numpy()
  acts = lo + (hi - lo) * np.random.default_rng(7).uniform(
      0.1, 0.9, (_N, _H, pp.nu))
  want = jax.jit(jax.vmap(lambda a: jp.rollout_return(
      jax.tree_util.tree_map(lambda x: x[0], jdata(jp.model, s)),
      jnp.asarray(goal), a)))(jnp.asarray(acts))
  bdata, goals = pp._broadcast(PT.map_data(pdata(pp.model, s),
                                           lambda x: x[0]),
                               torch.as_tensor(goal), _N)
  got = pp.rollout_return(bdata, goals, torch.as_tensor(acts))
  assert got.shape == (_N,)
  _close(got, want, 1e-6, 1e-9)
  # One candidate without a batch axis: the same return.
  one = pp.rollout_return(PT.map_data(bdata, lambda x: x[1]), goals[1],
                          torch.as_tensor(acts[1]))
  assert one.shape == ()
  _close(one, got[1], 1e-12, 1e-12)


def test_one_iteration_per_candidate_matches_jax(planners):
  """_one_iteration with batched_rollouts=False under injected noise and
  injected per-candidate returns (a fixed linear score of each candidate
  sequence), as test_one_iteration_matches_jax does for the batched
  path: the same candidates, plan and best return."""
  jp, pp = planners['jp'], planners['pp']
  rng = np.random.default_rng(13)
  noise = 0.4 * rng.normal(size=(_N - 1, _H, pp.nu))
  weight = rng.normal(size=(_H, pp.nu))
  nominal = np.asarray(jp.init_state().nominal) + 0.1
  s = _one_env(planners['state'], 1)
  goal = planners['goals'][1]
  seen = {}

  def pscore(d, g, a):
    seen['batch'] = (tuple(d.qpos.shape), tuple(g.shape), tuple(a.shape))
    return (a * torch.as_tensor(weight)).sum((-2, -1))

  jp._sample_noise = lambda key, n: jnp.asarray(noise)
  pp._sample_noise = lambda gen, n: torch.as_tensor(noise)
  jp.rollout_return = lambda d, g, a: jnp.sum(a * jnp.asarray(weight))
  pp.rollout_return = pscore
  try:
    jseq, jret = jp._one_iteration(
        jax.tree_util.tree_map(lambda x: x[0], jdata(jp.model, s)),
        jnp.asarray(goal), jnp.asarray(nominal), jax.random.PRNGKey(0), 0.7)
    pseq, pret = pp._one_iteration(
        PT.map_data(pdata(pp.model, s), lambda x: x[0]),
        torch.as_tensor(goal), torch.as_tensor(nominal), torch.Generator(),
        0.7)
  finally:
    for planner in (jp, pp):
      del planner._sample_noise, planner.rollout_return
  # The candidates went to rollout_return as one leading axis.
  assert seen['batch'] == ((_N, pp.model.nq), (_N, 4), (_N, _H, pp.nu))
  _close(pseq, jseq, 1e-12, 1e-14)
  _close(pret, jret, 1e-12, 1e-12)


def test_per_candidate_solve_builds_and_solves(planners):
  pp = planners['pp']
  s = _one_env(planners['state'], 0)
  action, st = pp.solve(PT.map_data(pdata(pp.model, s), lambda x: x[0]),
                        torch.as_tensor(planners['goals'][0]),
                        pp.init_state(), torch.Generator().manual_seed(0))
  assert action.shape == (pp.nu,)
  assert bool(torch.isfinite(action).all()) and bool(
      torch.isfinite(st.best_return))


@pytest.fixture(scope='module')
def jax_flat(planners):
  """JAX's rollout_returns_flat, compiled once for both NaN tests."""
  return jax.jit(planners['jp'].rollout_returns_flat)


@pytest.fixture(scope='module')
def nan_inputs(planners):
  """2 environments x 4 candidates, the first environment's start qpos
  NaN."""
  pp = planners['pp']
  state = {k: np.repeat(v, _N, axis=0) for k, v in planners['state'].items()}
  state['qpos'][:_N] = np.nan
  goals = np.repeat(planners['goals'], _N, axis=0)
  lo, hi = pp._lo.numpy(), pp._hi.numpy()
  acts = lo + (hi - lo) * np.random.default_rng(14).uniform(
      0.1, 0.9, (2 * _N, _H, pp.nu))
  return state, goals, acts


def test_nan_start_row_returns_zero_in_both(planners, nan_inputs, jax_flat):
  """rollout_returns_flat: a row whose start qpos is NaN is dead from the
  start and returns 0 in both packages; the other rows match."""
  jp, pp = planners['jp'], planners['pp']
  state, goals, acts = nan_inputs
  want = np.asarray(jax_flat(jdata(jp.model, state), jnp.asarray(goals),
                             jnp.asarray(acts)))
  got = _np(pp.rollout_returns_flat(pdata(pp.model, state),
                                    torch.as_tensor(goals),
                                    torch.as_tensor(acts)))
  np.testing.assert_array_equal(want[:_N], 0.0)
  np.testing.assert_array_equal(got[:_N], 0.0)
  assert np.isfinite(got[_N:]).all()
  np.testing.assert_allclose(got[_N:], want[_N:], rtol=1e-6, atol=1e-9)


def test_solve_batch_nan_stream_gives_reference_best_return(planners,
                                                            jax_flat):
  """A stream whose start is NaN: solve_batch gives the reference's
  best_return (0: every candidate scores 0), not NaN.  The reference's
  solve_batch runs eagerly around the compiled rollout_returns_flat."""
  jp, pp = planners['jp'], planners['pp']
  state = {k: v.copy() for k, v in planners['state'].items()}
  state['qpos'][0] = np.nan
  goals = planners['goals']
  noise = 0.3 * np.random.default_rng(15).normal(size=(_N - 1, _H, pp.nu))
  jp._sample_noise = lambda key, n: jnp.asarray(noise[:n])
  jp.rollout_returns_flat = jax_flat
  pp._sample_noise = lambda gen, n: torch.as_tensor(
      np.tile(noise, (n // (_N - 1), 1, 1)))
  try:
    nominal = np.asarray(jp.init_state().nominal)[None].repeat(2, 0)
    _, jnew = jp.solve_batch(
        jdata(jp.model, state), jnp.asarray(goals),
        jps.PlannerState(nominal=jnp.asarray(nominal),
                         best_return=jnp.full((2,), -jnp.inf)),
        jax.random.split(jax.random.PRNGKey(0), 2))
    _, pnew = pp.solve_batch(
        pdata(pp.model, state), torch.as_tensor(goals),
        pps.PlannerState(nominal=torch.as_tensor(nominal),
                         best_return=torch.full((2,), -np.inf,
                                                dtype=torch.float64)),
        torch.Generator().manual_seed(0))
  finally:
    del jp._sample_noise, jp.rollout_returns_flat, pp._sample_noise
  want = np.asarray(jnew.best_return)
  assert want[0] == 0.0
  np.testing.assert_array_equal(_np(pnew.best_return)[0], want[0])
  np.testing.assert_allclose(_np(pnew.best_return)[1], want[1], rtol=1e-6)
