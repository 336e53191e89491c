"""Batched contact physics of the PyTorch port against the JAX package.

Both sides compute from identical float64 inputs on the CPU: the seeded
contact-rich reorient states of tests/torch_scene.py.
Each module on the path is compared — tree planes, inertia/bias planes,
midphase, narrow phase, constraint.solve — and then the slice as a whole:
step_hot_b on the environment model and step_n_b on the planning model
(n=3, per-call midphase, minimal carry), at the tolerances of
tests/test_hot_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu.core import types as JT
from dexterity_tpu.physics import constraint as jconstraint
from dexterity_tpu.physics import kinematics as jkin
from dexterity_tpu.physics import math as jmath
from dexterity_tpu.physics import smooth as jsmooth
from dexterity_tpu.physics import step as jstep
from dexterity_tpu.physics.collision import primitives as jprim
from dexterity_tpu.physics.collision import soa as jsoa
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.physics import constraint as pconstraint
from dexterity_tpu_torch.physics import kinematics as pkin
from dexterity_tpu_torch.physics import linalg_cuda
from dexterity_tpu_torch.physics import math as pmath
from dexterity_tpu_torch.physics import smooth as psmooth
from dexterity_tpu_torch.physics import step as pstep
from dexterity_tpu_torch.physics.collision import primitives as pprim
from dexterity_tpu_torch.physics.collision import soa as psoa

from torch_scene import B as _B
from torch_scene import build_scene
from torch_scene import jdata as _jdata
from torch_scene import models as _models
from torch_scene import pair_inputs
from torch_scene import pdata as _pdata
from torch_scene import to_np as _np


@pytest.fixture(scope='module')
def scene():
  return build_scene()


def _planes(scene, which='env'):
  """Both sides' batch-minor tree planes on the same state."""
  jm, pm = _models(scene, which)
  s = scene['state']
  qpos = s['qpos'].T
  mp = np.zeros((pm.nmocap, 3, _B))
  mq = np.zeros((pm.nmocap, 4, _B))
  mq[:, 0] = 1.0
  jp = jstep._precompute_planes(jm, jnp.asarray(qpos),
                                jnp.asarray(s['qvel'].T), jnp.asarray(mp),
                                jnp.asarray(mq))
  pp = pstep._precompute_planes(pm, torch.as_tensor(qpos),
                                torch.as_tensor(s['qvel'].T),
                                torch.as_tensor(mp), torch.as_tensor(mq))
  return jp, pp


def test_contact_rich_state(scene):
  """The shared state really has penetrating contacts in every rollout."""
  _, pp = _planes(scene, 'plan')
  pm = scene['pplan']
  groups = pprim.collide_group_planes(
      pm, tuple(p.T for p in pp['gpos']), tuple(p.T for p in pp['gmat']),
      torch.float64)
  score = torch.cat([g['dist'] - g['margin'] for g in groups], -1)
  assert bool(((score < 0).sum(-1) >= 1).all())


@pytest.mark.parametrize('key,atol', [
    ('xpos_p', 1e-12), ('xquat_p', 1e-12), ('cdof6', 1e-12),
    ('gpos', 1e-12), ('gmat', 1e-12), ('ten_length', 1e-12)])
def test_tree_planes_match_jax(scene, key, atol):
  jp, pp = _planes(scene)
  a, b = jp[key], pp[key]
  if isinstance(a, tuple):
    a, b = jnp.stack(a), torch.stack(b)
  np.testing.assert_allclose(_np(b), _np(a), atol=atol)


@pytest.mark.parametrize('key,rtol,atol', [
    ('qm', 1e-9, 1e-12), ('qfrc_bias', 1e-9, 1e-10), ('xipos3', 0, 1e-12),
    ('ten_velocity', 1e-9, 1e-12)])
def test_inertia_bias_planes_match_jax(scene, key, rtol, atol):
  jp, pp = _planes(scene)
  np.testing.assert_allclose(_np(pp[key]), _np(jp[key]), rtol=rtol,
                             atol=atol)


def test_xfrc_planes_match_jax(scene):
  jm, pm = _models(scene, 'env')
  jp, pp = _planes(scene)
  xfrc = np.random.default_rng(3).normal(size=(pm.nbody, 6, _B))
  a = jsmooth.xfrc_planes(jm, jp['xipos3'], jp['cdof6'], jnp.asarray(xfrc))
  b = psmooth.xfrc_planes(pm, pp['xipos3'], pp['cdof6'],
                          torch.as_tensor(xfrc))
  np.testing.assert_allclose(_np(b), _np(a), rtol=1e-9, atol=1e-10)


def _major_planes(jp, pp):
  jg = tuple(jnp.moveaxis(p, -1, 0) for p in jp['gpos'] + jp['gmat'])
  pg = tuple(p.movedim(-1, 0) for p in pp['gpos'] + pp['gmat'])
  return jg, pg


@pytest.mark.parametrize('which', ['plan', 'env'])
def test_midphase_selinfo_matches_jax(scene, which):
  jm, pm = _models(scene, which)
  jp, pp = _planes(scene, which)
  jg, pg = _major_planes(jp, pp)
  jsel = jax.jit(jax.vmap(lambda gp, gm: jprim.midphase_selinfo(
      jm, gp, gm, jnp.float64)))(jg[:3], jg[3:])
  psel = pprim.midphase_selinfo(pm, pg[:3], pg[3:], torch.float64)
  assert len(jsel) == len(psel)
  assert any(si is not None for si in psel)
  for a, b in zip(jsel, psel):
    assert (a is None) == (b is None)
    if a is None:
      continue
    oh = np.asarray(a['oh'])                       # (B, m, n) one-hot
    np.testing.assert_array_equal(oh.argmax(-1), _np(b['sel']))
    np.testing.assert_array_equal(_np(b['stat']), np.asarray(a['stat']))


_GROUP_KEYS = ('dist', 'pos', 'frame', 'pair', 'margin')


@pytest.mark.parametrize('which,hoisted', [
    ('plan', False), ('plan', True), ('env', False)])
def test_collide_group_planes_matches_jax(scene, which, hoisted):
  jm, pm = _models(scene, which)
  jp, pp = _planes(scene, which)
  jg, pg = _major_planes(jp, pp)

  def jfn(gp, gm):
    si = (jprim.midphase_selinfo(jm, gp, gm, jnp.float64) if hoisted
          else None)
    return jprim.collide_group_planes(jm, gp, gm, jnp.zeros((), jnp.float64),
                                      jnp.float64, selinfo=si)

  jout = jax.jit(jax.vmap(jfn))(jg[:3], jg[3:])
  si = (pprim.midphase_selinfo(pm, pg[:3], pg[3:], torch.float64)
        if hoisted else None)
  pout = pprim.collide_group_planes(pm, pg[:3], pg[3:], torch.float64,
                                    selinfo=si)
  assert len(jout) == len(pout)
  for a, b in zip(jout, pout):
    for key in _GROUP_KEYS:
      x, y = a[key], b[key]
      if isinstance(x, tuple):
        x, y = jnp.stack(x), torch.stack(y)
      np.testing.assert_allclose(_np(y), _np(x), rtol=1e-9, atol=1e-12,
                                 err_msg=key)


@pytest.mark.parametrize('which', ['plan', 'env'])
def test_constraint_solve_matches_jax(scene, which):
  """constraint.solve on identical inputs: the planning model runs the
  modified-Newton path (K1 + K2), the environment model exact Newton
  (K3)."""
  jm, pm = _models(scene, which)
  s = scene['state']
  pre = pstep._planes_b(pm, _pdata(pm, s))
  pdata = _pdata(pm, s).replace(
      qM=pre['qm'].movedim(-1, 0),
      cdof=pre['cdof6'].movedim(-1, 0).transpose(-1, -2),
      ten_length=pre['ten_length'].movedim(-1, 0),
      ten_velocity=pre['ten_velocity'].movedim(-1, 0))
  qfrc = torch.as_tensor(np.random.default_rng(5).normal(size=(_B, pm.nv)))
  gp = tuple(p.movedim(-1, 0) for p in pre['gpos'])
  gm = tuple(p.movedim(-1, 0) for p in pre['gmat'])
  groups = pprim.collide_group_planes(pm, gp, gm, torch.float64)
  linalg_cuda.reset_launches()
  got = pconstraint.solve(pm, pdata, qfrc, contact_groups=groups)

  jdata = _jdata(jm, s).replace(
      **{k: jnp.asarray(_np(getattr(pdata, k)))
         for k in ('qM', 'cdof', 'ten_length', 'ten_velocity')})
  jgroups = [{k: (tuple(jnp.asarray(_np(c)) for c in v)
                  if isinstance(v, tuple) else jnp.asarray(_np(v)))
              for k, v in g.items()} for g in groups]
  ref = jax.jit(jax.vmap(lambda d, q, gr: jconstraint.solve(
      jm, d, q, contact_groups=gr)))(jdata, jnp.asarray(_np(qfrc)), jgroups)
  np.testing.assert_allclose(_np(got.qacc), np.asarray(ref.qacc),
                             rtol=1e-6, atol=1e-6)
  np.testing.assert_allclose(_np(got.qfrc_constraint),
                             np.asarray(ref.qfrc_constraint), rtol=1e-6,
                             atol=1e-6)
  np.testing.assert_allclose(_np(got.qfrc_constraint_axis),
                             np.asarray(ref.qfrc_constraint_axis),
                             rtol=1e-6, atol=1e-6)
  assert sum(linalg_cuda.launches.values()) == 0   # CPU: plain versions


def test_step_hot_b_matches_jax(scene):
  """One environment-model substep (exact Newton, Euler damping solve)."""
  jm, pm = _models(scene, 'env')
  s = scene['state']
  ref = jax.jit(lambda d: jstep.step_hot_b(jm, d))(_jdata(jm, s))
  got = pstep.step_hot_b(pm, _pdata(pm, s))
  np.testing.assert_allclose(_np(got.qpos), np.asarray(ref.qpos),
                             rtol=1e-6, atol=1e-8)
  np.testing.assert_allclose(_np(got.qvel), np.asarray(ref.qvel),
                             rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(_np(got.qacc), np.asarray(ref.qacc),
                             rtol=1e-4, atol=1e-3)


def test_step_n_b_matches_jax(scene):
  """One planning control step: n=3 substeps, per-call midphase, minimal
  carry — the shape of the planner's rollouts."""
  jm, pm = _models(scene, 'plan')
  s = scene['state']
  kw = dict(refresh='none', midphase='per_call', carry='minimal')
  ref = jax.jit(lambda d: jstep.step_n_b(jm, d, 3, **kw))(_jdata(jm, s))
  got = pstep.step_n_b(pm, _pdata(pm, s), 3, **kw)
  np.testing.assert_allclose(_np(got.qpos), np.asarray(ref.qpos),
                             rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(_np(got.qvel), np.asarray(ref.qvel),
                             rtol=1e-4, atol=1e-4)
  np.testing.assert_allclose(_np(got.time), np.asarray(ref.time), atol=1e-12)


def test_step_n_b_per_call_equals_per_substep_for_one_substep(scene):
  pm = scene['pplan']
  d = _pdata(pm, scene['state'])
  a = pstep.step_n_b(pm, d, 1, refresh='none', midphase='per_substep')
  c = pstep.step_n_b(pm, d, 1, refresh='none', midphase='per_call')
  torch.testing.assert_close(c.qpos, a.qpos, rtol=0, atol=0)
  torch.testing.assert_close(c.qvel, a.qvel, rtol=0, atol=0)


def test_step_n_b_minimal_carry_keeps_other_fields(scene):
  pm = scene['pplan']
  d = _pdata(pm, scene['state'])
  out = pstep.step_n_b(pm, d, 2, refresh='none', carry='minimal')
  full = pstep.step_n_b(pm, d, 2, refresh='none', carry='full')
  torch.testing.assert_close(out.qpos, full.qpos, rtol=0, atol=0)
  assert out.qfrc_actuator is d.qfrc_actuator
  assert not torch.equal(full.qfrc_actuator, d.qfrc_actuator)
  # refresh='position': the same state, with the frames of the new qpos.
  pos = pstep.step_n_b(pm, d, 2, refresh='position', carry='minimal')
  torch.testing.assert_close(pos.qpos, out.qpos, rtol=0, atol=0)
  frames = pkin.fwd_position(pm, out)
  for f in ('xpos', 'xquat', 'xipos', 'ximat', 'site_xpos', 'site_xmat',
            'geom_xpos', 'geom_xmat', 'cdof', 'ten_length'):
    torch.testing.assert_close(getattr(pos, f), getattr(frames, f), rtol=0,
                               atol=0, msg=f)
  assert not torch.equal(pos.xpos, d.xpos)


def test_float32_step_tracks_float64(scene):
  """The card's working type: one planning control step in float32 stays
  close to float64 on the same inputs."""
  pm = scene['pplan']
  pm32 = pm.to(dtype=torch.float32)
  s = scene['state']
  kw = dict(refresh='none', midphase='per_call', carry='minimal')
  a = pstep.step_n_b(pm, _pdata(pm, s), 3, **kw)
  b = pstep.step_n_b(pm32, _pdata(pm32, {k: v.astype(np.float32)
                                         for k, v in s.items()}), 3, **kw)
  assert torch.isfinite(b.qpos).all() and torch.isfinite(b.qvel).all()
  np.testing.assert_allclose(_np(b.qpos), _np(a.qpos), atol=1e-3)


def test_fwd_position_matches_jax(scene):
  """The AoS kinematics the compiler's inverse weights use."""
  jm, pm = _models(scene, 'env')
  s = scene['state']
  ref = jax.vmap(lambda d: jkin.fwd_position(jm, d))(_jdata(jm, s))
  got = pkin.fwd_position(pm, _pdata(pm, s))
  for f in ('xpos', 'xquat', 'xipos', 'ximat', 'geom_xpos', 'geom_xmat',
            'site_xpos', 'cdof', 'ten_length'):
    np.testing.assert_allclose(_np(getattr(got, f)),
                               np.asarray(getattr(ref, f)), atol=1e-12,
                               err_msg=f)
  qm = psmooth.crb(pm, got).qM
  ref_qm = jax.vmap(lambda d: jsmooth.crb(jm, d))(ref).qM
  np.testing.assert_allclose(_np(qm), np.asarray(ref_qm), rtol=1e-9,
                             atol=1e-12)


@pytest.mark.parametrize('tpair', sorted(
    (int(a), int(b)) for a, b in jsoa.KERNELS))
def test_soa_pair_kernels_match_jax(tpair):
  """Every SoA narrow-phase kernel (box_box included) on random poses:
  the same slots, distances, points and normals as the JAX kernel."""
  t1, t2 = JT.GeomType(tpair[0]), JT.GeomType(tpair[1])
  jfn, jk = jsoa.KERNELS[(t1, t2)]
  pfn, pk = psoa.KERNELS[(PT.GeomType(tpair[0]), PT.GeomType(tpair[1]))]
  assert pk == jk
  p1, m1, s1, p2, m2, s2 = pair_inputs(t1, t2, np.random.RandomState(
      tpair[0] * 10 + tpair[1]))
  jd, jp, jn = jax.jit(jfn)(
      jsoa.vec3(jnp.asarray(p1)), jsoa.mat3(jnp.asarray(m1)),
      jsoa.vec3(jnp.asarray(s1)), jsoa.vec3(jnp.asarray(p2)),
      jsoa.mat3(jnp.asarray(m2)), jsoa.vec3(jnp.asarray(s2)))

  def v3(a):
    return tuple(torch.as_tensor(a[:, i]) for i in range(3))

  def m3(a):
    return tuple(torch.as_tensor(a[:, i, j]) for i in range(3)
                 for j in range(3))

  pd, pp, pn = pfn(v3(p1), m3(m1), v3(s1), v3(p2), m3(m2), v3(s2))
  assert tuple(pd.shape) == tuple(jd.shape) == (jk, 64)
  np.testing.assert_allclose(_np(pd), np.asarray(jd), rtol=1e-9, atol=1e-10)
  active = np.asarray(jd) < 0
  assert active.any() or t1 == JT.GeomType.PLANE
  for a, b in zip(jp + jn, pp + pn):
    np.testing.assert_allclose(_np(b)[active], np.asarray(a)[active],
                               atol=1e-9)


def _math_cases(rng):
  """(name, args) with AoS (8, ...) inputs; plane forms take tuples."""
  q = rng.normal(size=(8, 4))
  q /= np.linalg.norm(q, axis=-1, keepdims=True)
  q2 = rng.normal(size=(8, 4))
  q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
  v = rng.normal(size=(8, 3))
  m = np.stack([np.linalg.qr(a)[0] for a in rng.normal(size=(8, 3, 3))])
  m *= np.sign(np.linalg.det(m))[:, None, None]
  axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
  return dict([
      ('quat_normalize', (3.0 * q,)), ('quat_mul', (q, q2)),
      ('quat_conj', (q,)), ('quat_inv', (q,)), ('quat_rotate', (q, v)),
      ('quat_rotate_inv', (q, v)), ('quat_to_mat', (q,)),
      ('mat_to_quat', (m,)), ('axis_angle_to_quat', (axis, v[:, 0])),
      ('quat_to_axis_angle', (q,)), ('quat_integrate', (q, v, 0.01)),
      ('quat_sub', (q, q2)), ('pose_mul', (v, q, v[::-1], q2)),
      ('transform_point', (v, q, v[::-1])),
      ('inertia_world', (1.0, np.abs(v), m)), ('l2_normalize', (v,)),
      ('quat_mul_p', (tuple(q.T), tuple(q2.T))),
      ('quat_rotate_p', (tuple(q.T), tuple(v.T))),
      ('quat_to_mat_p', (tuple(q.T),)),
      ('quat_normalize_p', (tuple(2.0 * q.T),)),
      ('cross_p', (tuple(v.T), tuple(v[::-1].T)))])


@pytest.mark.parametrize('name', sorted(_math_cases(np.random.default_rng(0))))
def test_math_helpers_match_jax(name):
  """The AoS and plane helpers of physics/math.py on random inputs."""
  args = _math_cases(np.random.default_rng(7))[name]

  def conv(a, f):
    if isinstance(a, tuple):
      return tuple(f(np.ascontiguousarray(x)) for x in a)
    return f(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a

  ref = getattr(jmath, name)(*(conv(a, jnp.asarray) for a in args))
  got = getattr(pmath, name)(*(conv(a, torch.as_tensor) for a in args))
  if not isinstance(ref, tuple):
    ref, got = (ref,), (got,)
  assert len(ref) == len(got), name
  for r, g in zip(ref, got):
    np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-12,
                               atol=1e-12, err_msg=name)
