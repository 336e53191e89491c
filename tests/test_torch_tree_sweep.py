"""Fused tree sweep of the PyTorch port (dexterity_tpu_torch.physics.
tree_cuda, kernels K5/K6) against the JAX package's tree_pallas.

On the CPU `build_tree_sweep`'s fn runs the plain version, which is held
to `tree_pallas._reference_sweep` (the Pallas kernels' math as one XLA
program) on the reorient environment and planning models at B = 4, and to
JAX's `step._precompute_planes`.  The CUDA kernels read the packed tables
built here; their structure is checked against the masks the plane
functions use.  The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation
from dexterity_tpu.physics import step as jstep
from dexterity_tpu.physics import tree_pallas
from dexterity_tpu.planners import common as jcommon
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.physics import kinematics as pkin
from dexterity_tpu_torch.physics import smooth as psmooth
from dexterity_tpu_torch.physics import step as pstep
from dexterity_tpu_torch.physics import tree_cuda
from dexterity_tpu_torch.planners import common as pcommon

_PLAN = dict(solver_iterations=4, ls_iterations=6, solver_refactor_every=2,
             plan_substeps=3, plan_midphase_cap=16, plan_contact_top_k=16,
             plan_implicit_damping=True, plan_self_collision=False)
_B = 4
_KEYS = ('xpos', 'xquat', 'cdof', 'gpos', 'gmat', 'xipos', 'ten_length',
         'ten_velocity', 'qm', 'qfrc_bias')


@pytest.fixture(scope='module')
def models():
  jtask = manipulation.build_task('reorient', 'state_dense')
  ptask = pmanip.build_task('reorient', 'state_dense')
  jplan, _ = jcommon.reduced_planning_model(jtask, **_PLAN)
  pplan, _ = pcommon.reduced_planning_model(
      ptask, device='cpu', dtype=torch.float64, **_PLAN)
  return dict(env=(jtask.compile(), ptask.compile(device='cpu',
                                                  dtype=torch.float64)),
              plan=(jplan, pplan))


def _inputs(pm, seed):
  """Seeded batch-minor inputs: qpos around qpos0 with a random cube
  orientation, random qvel, mocap rows component-major."""
  rng = np.random.default_rng(seed)
  qpos = pm.qpos0.numpy()[:, None] + 0.3 * rng.normal(size=(pm.nq, _B))
  free = [j for j in range(pm.njnt)
          if pm.jnt_type[j] == int(PT.JointType.FREE)][0]
  qa = pm.jnt_qposadr[free]
  q = rng.normal(size=(4, _B))
  qpos[qa + 3:qa + 7] = 1.3 * q / np.linalg.norm(q, axis=0)  # not unit
  qvel = rng.normal(size=(pm.nv, _B))
  mp = rng.normal(size=(3 * pm.nmocap, _B))
  mq = rng.normal(size=(4, pm.nmocap, _B))
  mq = (mq / np.linalg.norm(mq, axis=0)).reshape(4 * pm.nmocap, _B)
  return qpos, qvel, mp, mq


def _port(pm, ins):
  fn = tree_cuda.build_tree_sweep(pm, B=_B)
  return fn(*(torch.as_tensor(x) for x in ins))


def test_supports_matches_jax(models):
  jm, pm = models['env']
  assert tree_cuda.supports(pm) == tree_pallas.supports(jm) is True
  ball = tuple(int(PT.JointType.BALL) if t == int(PT.JointType.HINGE)
               else t for t in pm.jnt_type)
  assert tree_cuda.supports(pm.replace(jnt_type=ball)) == \
      tree_pallas.supports(jm.replace(jnt_type=ball)) is False
  with pytest.raises(ValueError):
    tree_cuda.build_tree_sweep(pm.replace(jnt_type=ball))


# The reference sweep computes in float32 whatever its inputs: _ConstStore
# rounds every model table to float32 and its one-hot dots return float32.
# The port computes in float64, so the two agree to float32 rounding
# (6e-8) accumulated over the tree depth and the CRB/RNE sums, times each
# output's scale: measured up to 8e-7, limit 2e-6.
_REF_RTOL = 2e-6


@pytest.mark.parametrize('which', ['env', 'plan'])
def test_sweep_matches_reference_sweep(models, which):
  jm, pm = models[which]
  ins = _inputs(pm, 0)
  ref = tree_pallas._reference_sweep(jm, *(jnp.asarray(x) for x in ins))
  got = _port(pm, ins)
  assert sorted(got) == sorted(ref) == sorted(_KEYS)
  for key in _KEYS:
    a, b = np.asarray(ref[key]), got[key].numpy()
    assert a.shape == b.shape, key
    scale = max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(b, a, rtol=0, atol=_REF_RTOL * scale,
                               err_msg=key)


def test_mocap_rows_are_component_major(models):
  """Row c·nmocap + m is component c of mocap body m: the mocap body's
  world pose follows the rows as the kernel's convention reads them."""
  _, pm = models['plan']
  ins = _inputs(pm, 1)
  out = _port(pm, ins)
  body = pm.body_mocapid.index(0)
  nb = pm.nbody
  for c in range(3):
    np.testing.assert_allclose(out['xpos'][c * nb + body].numpy(),
                               ins[2][c * pm.nmocap], atol=1e-12)
  for c in range(4):
    np.testing.assert_allclose(out['xquat'][c * nb + body].numpy(),
                               ins[3][c * pm.nmocap], atol=1e-12)


@pytest.mark.parametrize('which', ['env', 'plan'])
def test_plain_matches_jax_precompute_planes(models, which):
  """The plain version against JAX's production plane pipeline, in
  float64 on both sides."""
  jm, pm = models[which]
  qpos, qvel, mp, mq = _inputs(pm, 2)
  nm = pm.nmocap
  jp = jstep._precompute_planes(
      jm, jnp.asarray(qpos), jnp.asarray(qvel),
      jnp.asarray(mp.reshape(3, nm, _B).transpose(1, 0, 2)),
      jnp.asarray(mq.reshape(4, nm, _B).transpose(1, 0, 2)))
  got = _port(pm, (qpos, qvel, mp, mq))
  want = dict(
      xpos=jp['xpos_p'], xquat=jp['xquat_p'], cdof=jp['cdof6'],
      gpos=jnp.stack(jp['gpos']), gmat=jnp.stack(jp['gmat']),
      xipos=jp['xipos3'], ten_length=jp['ten_length'],
      ten_velocity=jp['ten_velocity'], qm=jp['qm'],
      qfrc_bias=jp['qfrc_bias'])
  for key in _KEYS:
    a = np.asarray(want[key]).reshape(got[key].shape)
    np.testing.assert_allclose(got[key].numpy(), a, rtol=1e-9, atol=1e-12,
                               err_msg=key)


@pytest.fixture(scope='module')
def juggle_models():
  jtask = manipulation.build_task('juggle', 'state_sparse')
  ptask = pmanip.build_task('juggle', 'state_sparse')
  return jtask.compile(), ptask.compile(device='cpu', dtype=torch.float64)


def test_juggle_mocap_rows_are_component_major(juggle_models):
  """Juggle welds its two hands to two mocap bodies (nmocap = 2), where
  the mocap row conventions part.  The sweep supports the model (as the
  JAX package's does), and with rows c·nmocap + m given component-major:
  the plain version equals JAX's `_reference_sweep` fed the same rows (to
  float32 rounding, as above; reading 9.8e-7 of scale), each mocap body's
  world pose is its own rows, and the plain version equals JAX's
  `_precompute_planes` fed (nmocap, c, B) planes (1e-9)."""
  jm, pm = juggle_models
  assert pm.nmocap == 2
  assert tree_cuda.supports(pm) == tree_pallas.supports(jm) is True
  ins = _inputs(pm, 3)
  got = _port(pm, ins)
  ref = tree_pallas._reference_sweep(jm, *(jnp.asarray(x) for x in ins))
  for key in _KEYS:
    a, b = np.asarray(ref[key]), got[key].numpy()
    assert a.shape == b.shape, key
    scale = max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(b, a, rtol=0, atol=_REF_RTOL * scale,
                               err_msg=key)
  nb, nm = pm.nbody, pm.nmocap
  for m in range(nm):
    body = pm.body_mocapid.index(m)
    for c in range(3):
      np.testing.assert_allclose(got['xpos'][c * nb + body].numpy(),
                                 ins[2][c * nm + m], atol=1e-12)
    for c in range(4):
      np.testing.assert_allclose(got['xquat'][c * nb + body].numpy(),
                                 ins[3][c * nm + m], atol=1e-12)
  qpos, qvel, mp, mq = ins
  jp = jstep._precompute_planes(
      jm, jnp.asarray(qpos), jnp.asarray(qvel),
      jnp.asarray(mp.reshape(3, nm, _B).transpose(1, 0, 2)),
      jnp.asarray(mq.reshape(4, nm, _B).transpose(1, 0, 2)))
  for key, want in (('xpos', jp['xpos_p']), ('xquat', jp['xquat_p']),
                    ('cdof', jp['cdof6']), ('qm', jp['qm']),
                    ('qfrc_bias', jp['qfrc_bias'])):
    a = np.asarray(want).reshape(got[key].shape)
    np.testing.assert_allclose(got[key].numpy(), a, rtol=1e-9, atol=1e-12,
                               err_msg=key)
  # A mocap-major reading of the same rows (tests/test_tree_pallas.py's
  # reshape) would put the wrong numbers on a mocap body at nmocap = 2.
  mocap_major = ins[2].reshape(nm, 3, _B)[1]
  body = pm.body_mocapid.index(1)
  assert not np.allclose(got['xpos'][np.arange(3) * nb + body].numpy(),
                         mocap_major)


def _segments(ti, tf):
  """The packed tables split at the header's offsets: name -> array."""
  ni, nf = len(tree_cuda._INT_SEGS), len(tree_cuda._FLOAT_SEGS)
  iends = list(ti[1:ni]) + [len(ti)]
  fends = list(ti[ni + 1:ni + nf]) + [len(tf)]
  out = {k: ti[ti[i]:iends[i]] for i, k in enumerate(tree_cuda._INT_SEGS)}
  out.update({k: tf[ti[ni + i]:fends[i]]
              for i, k in enumerate(tree_cuda._FLOAT_SEGS)})
  return out


def _csr_rows(ptr, idx, n):
  """A CSR list as a dense 0/1 mask of n columns."""
  out = np.zeros((len(ptr) - 1, n))
  for r in range(len(ptr) - 1):
    out[r, idx[ptr[r]:ptr[r + 1]]] = 1.0
  return out


def test_tables_match_the_plane_masks(models):
  """K6's gather tables are the plane functions' masks: the subtree CSR is
  the subtree mask, the ancestor-dof CSR the ancestor mask, the qm kinds
  the CRB pattern, its strict transpose and the diagonal; the table header
  points at segments of the stated sizes."""
  _, pm = models['plan']
  ti, tf = tree_cuda.tables_np(pm)
  seg = _segments(ti, tf)
  nb, nv = pm.nbody, pm.nv
  np.testing.assert_array_equal(
      _csr_rows(seg['body_sub_ptr'], seg['body_sub'], nb),
      psmooth._subtree_mask_np(pm))
  np.testing.assert_array_equal(
      _csr_rows(seg['body_ancdof_ptr'], seg['body_ancdof'], nv),
      pkin.ancestor_mask(pm))
  up = psmooth._dof_upper_mask_np(pm)
  eye = np.eye(nv)
  kind = seg['qm_kind'].reshape(nv, nv)
  names = tree_cuda._QM_KINDS
  np.testing.assert_array_equal(kind == names.index('upper'),
                                up * (1 - eye))
  np.testing.assert_array_equal(kind == names.index('mirrored'),
                                up.T * (1 - eye))
  np.testing.assert_array_equal(kind == names.index('diagonal'), eye)
  np.testing.assert_array_equal(kind == names.index('zero'),
                                (up + up.T) == 0)
  sizes = dict(body_pos=3 * nb, body_quat=4 * nb, gravity=3,
               ten_qsel=pm.ntendon * pm.nq, ten_moment=pm.ntendon * nv,
               geom_quat=4 * pm.ngeom, dof_armature=nv, dof_keep=nv,
               geom_body=pm.ngeom, dof_body=nv, body_parent=nb,
               body_sub_ptr=nb + 1, body_ancdof_ptr=nb + 1,
               body_sub=int(psmooth._subtree_mask_np(pm).sum()),
               body_ancdof=int(pkin.ancestor_mask(pm).sum()),
               qm_kind=nv * nv)
  for name, size in sizes.items():
    assert len(seg[name]) == size, name
  np.testing.assert_array_equal(seg['geom_body'], pm.geom_bodyid)
  np.testing.assert_array_equal(seg['dof_body'], pm.dof_bodyid)


def _depths(pm):
  depth = np.zeros(pm.nbody, np.int64)
  for b in range(1, pm.nbody):
    depth[b] = depth[pm.body_parentid[b]] + 1
  return depth


@pytest.mark.parametrize('which', ['env', 'plan'])
def test_level_tables(models, which):
  """K5's level table: every body once, the world alone at level 0, each
  body's parent on the level just above it, tree depth + 1 levels (10 for
  the reorient hand)."""
  _, pm = models[which]
  seg = _segments(*tree_cuda.tables_np(pm))
  ptr, body = seg['level_ptr'], seg['level_body']
  np.testing.assert_array_equal(np.sort(body), np.arange(pm.nbody))
  assert list(ptr[:2]) == [0, 1] and body[0] == 0
  assert ptr[-1] == pm.nbody and (np.diff(ptr) > 0).all()
  level = np.zeros(pm.nbody, np.int64)
  for lvl in range(len(ptr) - 1):
    level[body[ptr[lvl]:ptr[lvl + 1]]] = lvl
  for b in range(1, pm.nbody):
    assert level[b] == level[pm.body_parentid[b]] + 1, b
  assert len(ptr) - 1 == _depths(pm).max() + 1 == 10


def test_table_header_and_sizes(models):
  """The header has one offset per entry of _INT_SEGS and _FLOAT_SEGS,
  in order; the float buffer's size is the one K5 copies (its segment
  sizes follow from the model's dimensions), and K5's copy of the int
  buffer through dof_body, at its bound, stays inside the buffer."""
  for which in ('env', 'plan'):
    _, pm = models[which]
    ti, tf = tree_cuda.tables_np(pm)
    ni, nf = len(tree_cuda._INT_SEGS), len(tree_cuda._FLOAT_SEGS)
    head = ni + nf
    assert ti[0] == head and ti[ni] == 0
    assert (np.diff(ti[:ni]) >= 0).all() and (np.diff(ti[ni:head]) >= 0).all()
    nb, nv, ng, nt, nq = pm.nbody, pm.nv, pm.ngeom, pm.ntendon, pm.nq
    assert len(tf) == 24 * nb + 8 * nv + 7 * ng + 3 + nt * (nq + nv)
    end = ti[tree_cuda._INT_SEGS.index('dof_body') + 1]
    bound = head + 6 * nb + 3 * nv + ng + 1
    assert end <= bound <= len(ti)


def _qmul(q, r):
  return np.stack([
      q[0] * r[0] - q[1] * r[1] - q[2] * r[2] - q[3] * r[3],
      q[0] * r[1] + q[1] * r[0] + q[2] * r[3] - q[3] * r[2],
      q[0] * r[2] - q[1] * r[3] + q[2] * r[0] + q[3] * r[1],
      q[0] * r[3] + q[1] * r[2] - q[2] * r[1] + q[3] * r[0]])


def _rotate(q, v):
  t = 2 * np.cross(q[1:], v, axis=0)
  return v + q[0] * t + np.cross(q[1:], t, axis=0)


def _level_fk(pm, ti, tf, qpos, mpos, mquat):
  """K5's phases 2 and 3 in numpy, reading only the packed tables: every
  body's local pose from its joint or mocap rows, then x = parent o local
  in place, level by level.  Returns (xpos (3, nbody, B), xquat (4,
  nbody, B))."""
  seg = _segments(ti, tf)
  nb, nm = pm.nbody, pm.nmocap
  b_ = qpos.shape[-1]
  pos = np.zeros((3, nb, b_))
  quat = np.zeros((4, nb, b_))
  quat[0] = 1.0
  jtypes = {int(PT.JointType.FREE): 'free', int(PT.JointType.HINGE): 'hinge',
            int(PT.JointType.SLIDE): 'slide'}
  mp, mq = mpos.reshape(3, nm, b_), mquat.reshape(4, nm, b_)
  for b in range(1, nb):
    m, a = seg['body_mocap'][b], seg['body_qadr'][b]
    kind = jtypes.get(int(seg['body_jtype'][b]))
    if m >= 0:
      pos[:, b], quat[:, b] = mp[:, m], mq[:, m]
      continue
    if kind == 'free':
      raw = qpos[a + 3:a + 7]
      pos[:, b] = qpos[a:a + 3]
      quat[:, b] = raw / np.sqrt(np.maximum((raw * raw).sum(0), 1e-24))
      continue
    dq = np.zeros((4, b_))
    dq[0] = 1.0
    dp = np.zeros((3, b_))
    ax = seg['body_jaxis'][3 * b:3 * b + 3, None]
    if kind == 'hinge':
      jp = seg['body_jpos'][3 * b:3 * b + 3, None] * np.ones(b_)
      half = 0.5 * qpos[a]
      dq = np.concatenate([np.cos(half)[None], ax * np.sin(half)])
      dp = jp - _rotate(dq, jp)
    elif kind == 'slide':
      dp = ax * qpos[a]
    bq = seg['body_quat'][4 * b:4 * b + 4, None] * np.ones(b_)
    pos[:, b] = seg['body_pos'][3 * b:3 * b + 3, None] + _rotate(bq, dp)
    quat[:, b] = _qmul(bq, dq)
  ptr, body = seg['level_ptr'], seg['level_body']
  parent = seg['body_parent']
  for lvl in range(1, len(ptr) - 1):
    for b in body[ptr[lvl]:ptr[lvl + 1]]:
      p = parent[b]
      pos[:, b] = pos[:, p] + _rotate(quat[:, p], pos[:, b])
      quat[:, b] = _qmul(quat[:, p], quat[:, b])
  return pos, quat


@pytest.mark.parametrize('which', ['env', 'plan'])
def test_level_composition_gives_fk_plain(models, which):
  """The local poses composed level by level from the packed tables, as
  K5 composes them, give fk_plain's xpos and xquat in float64 (only the
  order of the compositions differs: fk_plain jumps pointers)."""
  _, pm = models[which]
  ins = _inputs(pm, 5)
  want = tree_cuda.fk_plain(pm, *(torch.as_tensor(x) for x in ins))
  pos, quat = _level_fk(pm, *tree_cuda.tables_np(pm), ins[0], ins[2],
                        ins[3])
  np.testing.assert_allclose(pos.reshape(3 * pm.nbody, -1),
                             want['xpos'].numpy(), rtol=0, atol=1e-12)
  np.testing.assert_allclose(quat.reshape(4 * pm.nbody, -1),
                             want['xquat'].numpy(), rtol=0, atol=1e-12)


def _gather_dyn(pm, ti, tf, cdof, body10, qvel):
  """K6's phases in numpy, reading only the packed tables as the
  kernel does (rows batch-minor, every sum a gather over a CSR list)."""
  seg = _segments(ti, tf)
  nb, nv = pm.nbody, pm.nv
  cd = cdof.reshape(6, nv, -1)
  b10 = body10.reshape(10, nb, -1)
  sp, si = seg['body_sub_ptr'], seg['body_sub']
  ap, ai = seg['body_ancdof_ptr'], seg['body_ancdof']
  db = seg['dof_body']
  sub = lambda b: si[sp[b]:sp[b + 1]]
  anc = lambda b: ai[ap[b]:ap[b + 1]]
  t = lambda x: torch.as_tensor(np.ascontiguousarray(x))
  comp = np.stack([b10[:, sub(b)].sum(1) for b in range(nb)], 1)
  cvel = np.stack([(cd[:, anc(b)] * qvel[anc(b)]).sum(1)
                   for b in range(nb)], 1)
  f = psmooth._spatial_inertia_apply(t(comp[:, db]), t(cd)).numpy()
  ref = cvel[:, db] * seg['dof_keep'][:, None]
  tau = psmooth._motion_cross_planes(t(ref), t(cd)).numpy() * qvel
  grav = np.concatenate([np.zeros(3), -seg['gravity']])[:, None]
  cacc = np.stack([grav + tau[:, anc(b)].sum(1) for b in range(nb)], 1)
  iv = psmooth._spatial_inertia_apply(t(b10), t(cvel))
  fb = (psmooth._spatial_inertia_apply(t(b10), t(cacc))
        + psmooth._force_cross_planes(t(cvel), iv)).numpy()
  kind = seg['qm_kind'].reshape(nv, nv)
  qm = np.zeros((nv, nv, cd.shape[-1]))
  for v in range(nv):
    for w in range(nv):
      if kind[v, w]:
        lo, hi = min(v, w), max(v, w)
        qm[v, w] = (cd[:, lo] * f[:, hi]).sum(0)
        if kind[v, w] == tree_cuda._QM_KINDS.index('diagonal'):
          qm[v, w] += seg['dof_armature'][v]
  qfrc = np.stack([(cd[:, v] * fb[:, sub(db[v])].sum(1)).sum(0)
                   for v in range(nv)])
  return dict(qm=qm.reshape(nv * nv, -1), qfrc_bias=qfrc)


@pytest.mark.parametrize('which', ['env', 'plan'])
def test_gather_tables_give_dyn_plain(models, which):
  """The packed tables, read as K6 reads them, give dyn_plain's qm and
  qfrc_bias in float64 (only the order of the sums differs)."""
  _, pm = models[which]
  ins = [torch.as_tensor(x) for x in _inputs(pm, 4)]
  fk = tree_cuda.fk_plain(pm, *ins)
  want = tree_cuda.dyn_plain(pm, fk['cdof'], fk['body10'], ins[1])
  got = _gather_dyn(pm, *tree_cuda.tables_np(pm), fk['cdof'].numpy(),
                    fk['body10'].numpy(), ins[1].numpy())
  for key in ('qm', 'qfrc_bias'):
    scale = max(want[key].abs().max().item(), 1.0)
    np.testing.assert_allclose(got[key], want[key].numpy(), rtol=0,
                               atol=1e-12 * scale, err_msg=key)


def test_kernel_size_checks_come_before_the_card(models):
  """The wrappers raise on a dtype the kernels do not take and on a model
  whose shared memory does not fit, before any build (meta tensors)."""
  _, pm = models['plan']
  with pytest.raises(TypeError):
    tree_cuda._check_fits(pm, torch.empty(1, device='meta',
                                          dtype=torch.float16))
  big = pm.replace(nv=4000)
  with pytest.raises(ValueError, match='shared memory'):
    tree_cuda._check_fits(big, torch.empty(1, device='meta',
                                           dtype=torch.float64))
  tree_cuda._check_fits(pm, torch.empty(1, device='meta',
                                        dtype=torch.float64))


def test_cpu_inputs_use_the_plain_version(models):
  _, pm = models['plan']
  tree_cuda.reset_launches()
  fn = tree_cuda.build_tree_sweep(pm)
  ins = [torch.as_tensor(x) for x in _inputs(pm, 3)]
  out = fn(*ins)
  ref = tree_cuda.tree_sweep_plain(pm, *ins)
  for key in _KEYS:
    torch.testing.assert_close(out[key], ref[key], rtol=0, atol=0)
  fk = tree_cuda.tree_fk(pm, *ins)
  dyn = tree_cuda.tree_dyn(pm, fk['cdof'], fk['body10'], ins[1])
  assert tree_cuda.launches == {'tree_sweep_fk': 0, 'tree_sweep_dyn': 0}
  for key in _KEYS:
    torch.testing.assert_close({**fk, **dyn}[key], ref[key], rtol=0,
                               atol=0)
  # The port's own production planes, on the same inputs.
  nm = pm.nmocap
  pre = pstep._precompute_planes(
      pm, ins[0], ins[1], ins[2].reshape(3, nm, _B).transpose(0, 1),
      ins[3].reshape(4, nm, _B).transpose(0, 1))
  for key, pkey in (('xpos', 'xpos_p'), ('cdof', 'cdof6'), ('qm', 'qm'),
                    ('qfrc_bias', 'qfrc_bias'), ('xipos', 'xipos3')):
    torch.testing.assert_close(ref[key], pre[pkey].reshape(ref[key].shape),
                               rtol=0, atol=0)
  with pytest.raises(ValueError):
    tree_cuda.build_tree_sweep(pm, B=_B + 1)(*ins)
  with pytest.raises(ValueError):
    fn(ins[0][:-1], *ins[1:])
