"""The port's hands against the JAX package (float64 on the CPU).

The three new assets are byte-equal copies; joint names, groups,
projections and coupled-joint ids equal the JAX hands'; the joint-angle
samplers, handed JAX's own unit draws, pick what JAX's picks (the
collision-free sampler also with a try moved into self-collision, so the
pick is not the first try).
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.core import types as JT
from dexterity_tpu.models import hands as jhands
from dexterity_tpu.physics import step as jstep
from dexterity_tpu.utils import collisions as jcoll
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.models import hands as phands
from dexterity_tpu_torch.physics import step as pstep
from dexterity_tpu_torch.utils import collisions as pcoll

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(device='cpu', dtype=torch.float64)
_TRIES = 100      # reach's _MAX_INIT_SAMPLES


def _both(kind):
  if kind == 'adroit':
    return jhands.AdroitHand(), phands.AdroitHand()
  if kind == 'shadow':
    return jhands.ShadowHandSeriesE(), phands.ShadowHandSeriesE()
  side = kind.split('_')[1].upper()
  return (jhands.MPLHand(side=jhands.HandSide[side], name=kind),
          phands.MPLHand(side=phands.HandSide[side], name=kind))


@pytest.mark.parametrize('asset', ['adroit_hand.json', 'mpl_left.json',
                                   'mpl_right.json'])
def test_asset_copy_is_byte_equal(asset):
  name = os.path.join('models', 'assets', asset)
  assert filecmp.cmp(os.path.join(_ROOT, 'dexterity_tpu', name),
                     os.path.join(_ROOT, 'dexterity_tpu_torch', name),
                     shallow=False)


@pytest.mark.parametrize('kind', ['adroit', 'mpl_left', 'mpl_right',
                                  'shadow'])
def test_hand_tables_match_jax(kind):
  """Names, groups, projections (exact: the same numpy arithmetic),
  ranges, coupled joints, fingertip sites and counts."""
  jh, ph = _both(kind)
  assert ph.name == jh.name and ph.asset == jh.asset
  assert ph.joint_names == jh.joint_names
  assert ph.actuator_names == jh.actuator_names
  assert ph.fingertip_site_names == jh.fingertip_site_names
  assert [(g.name, g.joint_names) for g in ph.joint_groups] == [
      (g.name, g.joint_names) for g in jh.joint_groups]
  np.testing.assert_array_equal(ph.position_to_control,
                                jh.position_to_control)
  np.testing.assert_array_equal(ph.control_to_position,
                                jh.control_to_position)
  np.testing.assert_array_equal(ph.joint_ranges, jh.joint_ranges)
  assert ph.coupled_joint_ids == jh.coupled_joint_ids
  assert (ph.num_joints, ph.num_actuators, ph.underactuated) == (
      jh.num_joints, jh.num_actuators, jh.underactuated)
  for name in ('adroit', 'shadow', 'mpl_left'):
    assert phands._group_key(name + '_x') == jhands._group_key(name + '_x')
  # The projections over batch axes, numpy and torch, against JAX's
  # per-vector matmul.
  rng = np.random.default_rng(3)
  q = rng.normal(size=(2, 3, ph.num_joints))
  c = rng.normal(size=(2, 3, ph.num_actuators))
  want_c = np.stack([[jh.joint_positions_to_control(x) for x in row]
                     for row in q])
  want_q = np.stack([[jh.control_to_joint_positions(x) for x in row]
                     for row in c])
  np.testing.assert_allclose(ph.joint_positions_to_control(q), want_c,
                             atol=1e-12)
  np.testing.assert_allclose(
      ph.joint_positions_to_control(torch.as_tensor(q)).numpy(), want_c,
      atol=1e-12)
  np.testing.assert_allclose(
      ph.control_to_joint_positions(torch.as_tensor(c)).numpy(), want_q,
      atol=1e-12)
  if kind == 'shadow':
    assert ph.coupled_joint_names == jh.coupled_joint_names


@pytest.mark.parametrize('kind', ['adroit', 'mpl_left', 'shadow'])
def test_sample_joint_angles_matches_jax_given_its_draws(kind):
  """JAX's sampler against the port's on the unit draws of the same keys
  (jax.random.uniform with bounds 0 and 1 gives the unit floats JAX
  scales), at three range fractions; the coupled joints agree.  The same
  arithmetic, up to XLA's fused multiply-add: readings 5.6e-17, limit
  1e-15."""
  jh, ph = _both(kind)
  for frac in (1.0, 0.5, 0.1):
    for seed in range(3):
      key = jax.random.PRNGKey(seed)
      want = np.asarray(jh.sample_joint_angles(key, frac))
      u = np.asarray(jax.random.uniform(key, (jh.num_joints,), jnp.float64))
      got = ph.sample_joint_angles(torch.tensor(u), frac)
      np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
      for ids in ph.coupled_joint_ids:
        assert len(set(got.numpy()[list(ids)].tolist())) == 1
  # A batch of draws gives each row's sample.
  u = torch.rand(4, ph.num_joints, dtype=torch.float64,
                 generator=torch.Generator().manual_seed(0))
  batch = ph.sample_joint_angles(u, 0.5)
  np.testing.assert_array_equal(batch[2].numpy(),
                                ph.sample_joint_angles(u[2], 0.5).numpy())
  with pytest.raises(ValueError, match='range_fraction'):
    ph.sample_joint_angles(u, 1.5)


@pytest.fixture(scope='module')
def reach_models():
  jtask = jmanip.build_task('reach', 'state_dense')
  ptask = pmanip.build_task('reach', 'state_dense')
  jm, pm = jtask.compile(), ptask.compile(**F64)
  jb = jtask._binding.resolve(jm)
  pb = ptask._binding.resolve(pm)
  jd = jstep.fwd_position(jm, JT.make_data(jm))
  verdict = jax.jit(jax.vmap(lambda q: jcoll.has_collision(
      jstep.fwd_position(jm, jd.replace(qpos=jd.qpos.at[
          np.asarray(jb.qpos_adr)].set(q))), jcoll.self_mask(
              jm, jb.prefix))))
  return dict(jtask=jtask, ptask=ptask, jm=jm, pm=pm, jb=jb, pb=pb, jd=jd,
              verdict=verdict)


def _jax_tries(key, nj, tries=_TRIES):
  """The unit draws of every try of JAX's collision-free sampler
  (hands.py:205-209: key, sub = split(key); uniform(sub))."""
  out = []
  for _ in range(tries):
    key, sub = jax.random.split(key)
    out.append(np.asarray(jax.random.uniform(sub, (nj,), jnp.float64)))
  return np.stack(out)


def test_collision_free_sampler_matches_jax(reach_models):
  """JAX's lax.while_loop sampler on three keys against the port's batch
  over the same draws (one batch of 3 and each alone); then JAX's draws of
  a key whose first try is free, with a colliding try moved into slot 0:
  the port picks the first try JAX's own collision check (fwd_position,
  has_collision) finds free."""
  r = reach_models
  jh, ph = r['jtask'].hand, r['ptask'].hand
  nj = ph.num_joints
  frac = 0.5
  keys = [jax.random.PRNGKey(s) for s in (0, 1, 2)]
  draws = np.stack([_jax_tries(k, nj) for k in keys])
  lo = jh.joint_ranges[:, 0] * frac
  hi = jh.joint_ranges[:, 1] * frac
  verdicts = np.stack([np.asarray(r['verdict'](jnp.asarray(np.stack(
      [np.asarray(jh.postprocess_sampled_joint_angles(
          jnp.maximum(lo, u * (hi - lo) + lo))) for u in d]))))
      for d in draws])                                     # (3, T) colliding
  assert verdicts[:, 1:].any()   # JAX's draws of these keys do collide
  pd0 = pstep.fwd_position(r['pm'], PT.make_data(r['pm']))
  pd = PT.map_data(pd0, lambda x: x.expand((3,) + x.shape).clone())
  got, ok = ph.sample_collision_free_joint_angles(
      r['pm'], pd, r['pb'], torch.as_tensor(draws), frac)
  assert ok.all()
  for i, key in enumerate(keys):
    want, wok = jh.sample_collision_free_joint_angles(
        r['jm'], r['jd'], r['jb'], key, range_fraction=frac,
        max_tries=_TRIES)
    assert bool(wok)
    np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0,
                               atol=1e-15)
    one, ok1 = ph.sample_collision_free_joint_angles(
        r['pm'], pd0, r['pb'], torch.as_tensor(draws[i]), frac)
    assert bool(ok1) and one.shape == (nj,)
    np.testing.assert_array_equal(one.numpy(), got[i].numpy())
  # A free first try replaced by a colliding one.
  i = int(np.argmin(verdicts[:, 0]))
  assert not verdicts[i, 0]
  moved = draws[i].copy()
  bad = np.argwhere(verdicts)[0]
  moved[0] = draws[bad[0], bad[1]]                     # a colliding draw
  vmoved = verdicts[i].copy()
  vmoved[0] = True
  want_pick = int(np.argmax(~vmoved))
  assert want_pick > 0
  got, ok = ph.sample_collision_free_joint_angles(
      r['pm'], pd0, r['pb'], torch.as_tensor(moved), frac)
  assert bool(ok)
  np.testing.assert_array_equal(
      got.numpy(), ph.sample_joint_angles(torch.as_tensor(moved[want_pick]),
                                          frac).numpy())
  # Every try colliding keeps the last, with ok False.
  allbad = np.repeat(moved[:1], 4, 0)
  got, ok = ph.sample_collision_free_joint_angles(
      r['pm'], pd0, r['pb'], torch.as_tensor(allbad), frac)
  assert not bool(ok)
  np.testing.assert_array_equal(
      got.numpy(), ph.sample_joint_angles(torch.as_tensor(allbad[-1]),
                                          frac).numpy())


def test_first_free_chunked_is_first_free_over_all_tries():
  """The pick equals the first free try over all tries (the last when none
  is free) for every row budget; each round evaluates only the searching
  environments, as many tries of each as the budget allows (at least
  one), so the tries per round grow as environments drop out."""
  free = torch.tensor([[False, False, True, False, True],
                       [True, False, False, False, False],
                       [False, False, False, False, False],
                       [False, False, False, False, True]])
  want_pick = [2, 0, 4, 4]
  seen = []

  def evaluate(rows, t0, t1):
    seen.append((t0, t1, rows.tolist()))
    vals = torch.arange(t0, t1, dtype=torch.float64)[None, :, None] + (
        10.0 * rows[:, None, None])
    return free[rows, t0:t1], vals
  for budget in (1, 4, 8, 12, 20, 28):
    seen.clear()
    val, ok, pick = phands.first_free_chunked(evaluate, 5, (2, 2), 'cpu',
                                              row_budget=budget)
    assert val.shape == (2, 2, 1)
    np.testing.assert_array_equal(pick.flatten().numpy(), want_pick)
    np.testing.assert_array_equal(ok.flatten().numpy(),
                                  [True, True, False, True])
    np.testing.assert_array_equal(
        val.flatten().numpy(), np.asarray(want_pick) + 10.0 * np.arange(4))
    assert seen[0][::2] == (0, [0, 1, 2, 3])
    # Consecutive rounds, each within the budget (or one try when the
    # searching environments alone exceed it).
    assert [s[0] for s in seen[1:]] == [s[1] for s in seen[:-1]]
    for t0, t1, rows in seen:
      assert t1 - t0 == min(max(1, budget // len(rows)), 5 - t0)
    if budget <= 4:
      assert seen[1] == (1, 2, [0, 2, 3])
  # Budget 8: two tries of four, then two of three, then the last of two.
  seen.clear()
  phands.first_free_chunked(evaluate, 5, (4,), 'cpu', row_budget=8)
  assert seen == [(0, 2, [0, 1, 2, 3]), (2, 4, [0, 2, 3]), (4, 5, [2, 3])]


def test_mpl_hands_in_juggle_bind_and_sample():
  """The two MPL hands of the juggle model: bindings resolve under their
  prefixes and a collision-free sample within half range exists."""
  ptask = pmanip.build_task('juggle', 'state_sparse')
  pm = ptask.compile(**F64)
  d = pstep.fwd_position(pm, PT.make_data(pm))
  for hand, b in zip(ptask.hands, ptask._bindings):
    assert len(b.qpos_adr) == hand.num_joints == 22
    assert len(b.act_ids) == hand.num_actuators == 13
    draws = torch.rand(8, hand.num_joints, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(1))
    q, ok = hand.sample_collision_free_joint_angles(pm, d, b, draws, 0.5)
    assert bool(ok)
    qpos = d.qpos.clone()
    qpos[b.qpos_adr] = q
    d2 = pstep.fwd_position(pm, d.replace(qpos=qpos))
    assert not bool(pcoll.has_collision(d2, pcoll.self_mask(pm, b.prefix)))
