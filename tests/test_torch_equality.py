"""The port's equality-constraint rows on juggle's model against the JAX
package (float64 on the CPU).

Juggle welds each MPL hand's free root to a mocap body and couples the
hands' joints with 8 TENDON and 1 JOINT polynomial equalities per hand
(neq = 20, nv = 62).  The states are juggle's after `reset` (two
environments), the second with its left mocap body moved off its weld,
and seeded joint velocities so that every row's velocity and J̇q̇ terms
are live.  Held to JAX: `constraint.assemble` row by row (J, aref, d,
invweight, kind, transmitted), the CONNECT/WELD J̇q̇ alone, the qpos
tangent map, and `step_n(5)` batched and unbatched against JAX's
vmap(step_n).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.core import types as JT
from dexterity_tpu.physics import constraint as jcon
from dexterity_tpu.physics import step as jstep
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.physics import constraint as pcon
from dexterity_tpu_torch.physics import step as pstep
from torch_scene import jdata
from torch_scene import to_np as _np

F64 = dict(device='cpu', dtype=torch.float64)
_STATE = ('qpos', 'qvel', 'ctrl', 'mocap_pos', 'mocap_quat', 'xfrc_applied',
          'qacc', 'time')


def _tree_np(x):
  if hasattr(x, '__dataclass_fields__'):
    return {k: _tree_np(getattr(x, k)) for k in x.__dataclass_fields__}
  return np.asarray(x)


def _err(got, want):
  return float(np.max(np.abs(_np(got) - np.asarray(want))))


@pytest.fixture(scope='module')
def juggle():
  """Both models, and two reset states of the port's environment, the
  second with its left mocap body moved 2.3 cm off the weld, as numpy:
  `resting` as they are, `fields` with seeded joint velocities added."""
  jtask = jmanip.build_task('juggle', 'state_sparse')
  jm = jtask.compile()
  penv = pmanip.load('juggle', 'state_sparse', **F64)
  state, _ = penv.reset(torch.Generator().manual_seed(0), (2,))
  d = state.data
  rng = np.random.default_rng(5)
  mocap = d.mocap_pos.clone()
  mocap[1, 0] += torch.tensor([0.01, -0.02, 0.005], dtype=torch.float64)
  qvel = d.qvel + torch.as_tensor(0.3 * rng.normal(size=d.qvel.shape))
  d = d.replace(mocap_pos=mocap)
  resting = {f: _np(getattr(d, f)) for f in _STATE}
  fields = dict(resting, qvel=_np(qvel))
  return dict(jm=jm, pm=penv.model, fields=fields, resting=resting)


@pytest.fixture(scope='module')
def forwarded(juggle):
  """JAX's fwd_position + fwd_velocity of both states (the input of
  assemble), and the same Data carried to the port."""
  jm = juggle['jm']
  jd = jax.jit(jax.vmap(lambda d: jstep.fwd_velocity(
      jm, jstep.fwd_position(jm, d))))(jdata(jm, juggle['fields']))
  return jd, PT.data_from_numpy(_tree_np(jd), **F64)


def test_juggle_model_has_the_equalities():
  pm = pmanip.build_task('juggle', 'state_sparse').compile(**F64)
  assert (pm.nv, pm.neq, pm.nmocap) == (62, 20, 2)
  # Per hand: 8 TENDON, 1 JOINT, then the WELD of add_mocap.
  hand = [int(PT.EqType.TENDON)] * 8 + [int(PT.EqType.JOINT),
                                         int(PT.EqType.WELD)]
  assert list(pm.eq_type) == hand * 2
  tabs = pcon._eq_tables(pm)
  assert len(tabs['order']) == 18 + 12
  np.testing.assert_array_equal(np.sort(tabs['order']), np.arange(30))
  np.testing.assert_array_equal(
      tabs['trans'], ([True] * 9 + [False] * 6) * 2)


def test_assemble_matches_jax_row_by_row(juggle, forwarded):
  """Every row of `assemble` (equalities first, then frictionloss,
  limits, contacts) for the batch of two and for each environment alone.
  Readings: J 5.6e-17, aref 5.7e-14 (of 1.1e3), d 0, invweight 6.8e-13
  (of 1.5e3; relative 7.1e-16); limits 1e-10 (invweight relative)."""
  jm, pm = juggle['jm'], juggle['pm']
  jd, pd = forwarded
  want = jax.vmap(lambda d: jcon.assemble(jm, d))(jd)
  assert want.J.shape[-2] > 30
  for rows, sel in ((pcon.assemble(pm, pd), slice(None)),
                    (pcon.assemble(pm, PT.map_data(pd, lambda x: x[1])), 1)):
    for f in ('J', 'aref', 'd', 'fl'):
      w = np.asarray(getattr(want, f))[sel]
      got = getattr(rows, f)
      assert tuple(got.shape) == w.shape, f
      assert _err(got, w) <= 1e-10, (f, _err(got, w))
    iw = np.asarray(want.invweight)[sel]
    np.testing.assert_allclose(_np(rows.invweight), iw, rtol=1e-10, atol=0)
    # Static per-row tables (vmap stacks them per environment).
    np.testing.assert_array_equal(rows.kind, np.asarray(want.kind)[0])
    np.testing.assert_array_equal(rows.transmitted,
                                  np.asarray(want.transmitted)[0])
  # The equality rows are live: residuals of the moved weld, velocities.
  eq = slice(0, 30)
  assert np.abs(np.asarray(want.aref)[1, eq]).max() > 1.0
  assert (np.asarray(want.d)[:, eq] > 0).all()


def test_weld_jdot_qvel_matches_jax(juggle, forwarded):
  """J̇q̇ of the two WELDs (12 rows) by torch.func.jvp through the port's
  frames against jax.jvp through JAX's.  Reading 2.8e-14 of 86; limit
  1e-12."""
  jm, pm = juggle['jm'], juggle['pm']
  jd, pd = forwarded
  cw = [(ei, JT.EqType(jm.eq_type[ei])) for ei in range(jm.neq)
        if jm.eq_type[ei] in (int(JT.EqType.CONNECT), int(JT.EqType.WELD))]
  assert len(cw) == 2
  want = jax.vmap(lambda d: jcon._cw_jdot_qvel(jm, d, cw, jnp.float64))(jd)
  pcw = [(ei, PT.EqType(int(t))) for ei, t in cw]
  got = pcon._cw_jdot_qvel(pm, pd, pcw, torch.float64)
  assert got.shape == (2, 12)
  assert np.abs(np.asarray(want)).max() > 1e-3
  assert _err(got, want) <= 1e-12
  one = pcon._cw_jdot_qvel(pm, PT.map_data(pd, lambda x: x[0]), pcw,
                           torch.float64)
  assert _err(one, np.asarray(want)[0]) <= 1e-12


def test_qpos_tangent_matches_jax(juggle):
  """The tangent map of qpos (free joints: position rates and the
  quaternion rate), batched and alone.  Exact up to rounding: 1e-15."""
  jm, pm = juggle['jm'], juggle['pm']
  f = juggle['fields']
  want = jax.vmap(lambda q, v: jcon._qpos_tangent(jm, q, v, jnp.float64))(
      jnp.asarray(f['qpos']), jnp.asarray(f['qvel']))
  got = pcon._qpos_tangent(pm, torch.as_tensor(f['qpos']),
                           torch.as_tensor(f['qvel']), torch.float64)
  assert _err(got, want) <= 1e-15
  one = pcon._qpos_tangent(pm, torch.as_tensor(f['qpos'][1]),
                           torch.as_tensor(f['qvel'][1]), torch.float64)
  assert _err(one, np.asarray(want)[1]) <= 1e-15


def test_step_n_matches_jax_with_equalities(juggle):
  """step_n(5) of both resting states (refresh 'full'), batched and each
  alone, against JAX's step_n(5) of each environment.  Readings: qpos
  6.2e-11, qvel 3.0e-9, xpos 1.6e-11 (batched rows); qpos 5.7e-11, qvel
  1.3e-9 (alone); limits qpos 1e-8, qvel 1e-6, xpos 1e-8.  JAX's
  vmap(step_n) is not the reference here: on the moved-weld state it
  differs from JAX's own step_n by 8.2e-8 in qpos and 3.4e-6 in qvel
  after the second substep (a different line-search step under vmap's
  rounding), and the port follows JAX's step_n."""
  jm, pm = juggle['jm'], juggle['pm']
  f = juggle['resting']
  jd = jdata(jm, f)
  step5 = jax.jit(lambda d: jstep.step_n(jm, d, 5))
  pd = PT.make_data(pm, (2,))
  pd = pd.replace(**{k: torch.as_tensor(v) for k, v in f.items()})
  got = pstep.step_n(pm, pd, 5)
  for i in (0, 1):
    want = step5(jax.tree_util.tree_map(lambda x, i=i: x[i], jd))
    assert _err(got.qpos[i], want.qpos) <= 1e-8
    assert _err(got.qvel[i], want.qvel) <= 1e-6
    assert _err(got.xpos[i], want.xpos) <= 1e-8
    one = pstep.step_n(pm, PT.map_data(pd, lambda x, i=i: x[i]), 5)
    assert _err(one.qpos, want.qpos) <= 1e-8
    assert _err(one.qvel, want.qvel) <= 1e-6
  assert np.isfinite(_np(got.qpos)).all()
  # The moved mocap body pulls its hand: the two environments part.
  assert _err(got.qpos[1], _np(got.qpos[0])) > 1e-3
