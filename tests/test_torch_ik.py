"""The port's DLS mapper and fingertip IK solver against the JAX package.

Both sides run in float64 on the CPU from the same numpy inputs, and the
solves from the same initial configurations: JAX's threefry draws are
handed to the port's `_initial_configurations`.  Limits are stated beside
each check (float64 on this CPU): the Jacobians are the same products, to
1e-12 of their max-abs; joint velocities are one Cholesky or SVD solve
(cond up to ~1e5 with λ = 1e-5), to 1e-10 of their max-abs; an attempt
integrates up to 8 such steps, final qpos to 1e-8 and errors to 1e-9, with
equal step counts (the loop's exits are decisions on those errors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu.controllers import dls as jdls
from dexterity_tpu.controllers import mapper as jmapper
from dexterity_tpu.core.types import ObjType as JObj
from dexterity_tpu.inverse_kinematics import ik_solver as jik
from dexterity_tpu.models import hands as jhands
from dexterity_tpu_torch.controllers import dls as pdls
from dexterity_tpu_torch.controllers import mapper as pmapper
from dexterity_tpu_torch.core.types import ObjType as PObj
from dexterity_tpu_torch.inverse_kinematics import ik_solver as pik
from dexterity_tpu_torch.models import hands as phands

_TOL = 1e-3
_MAX_STEPS = 8


@pytest.fixture(scope='module')
def solvers():
  js = jik.IKSolver(jhands.AdroitHand())
  ps = pik.IKSolver(phands.AdroitHand(), device='cpu', dtype=torch.float64)
  return js, ps


def _fk_tips(ps, q):
  return ps._tips(ps._fk(torch.as_tensor(q))).numpy()


def _rel(got, want):
  want = np.asarray(want)
  return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# Mapper and DLS parameters
# ---------------------------------------------------------------------------


_BAD = [
    dict(object_types=['SITE'], object_names=['nonexistent_site'],
         regularization_weight=1e-5),
    dict(object_types=['SITE'], object_names=['S_fftip'],
         regularization_weight=-1.0),
    dict(object_types=['SITE', 'SITE'], object_names=['S_fftip'],
         regularization_weight=0.0),
    dict(object_types=['BODY'], object_names=['S_fftip'],
         regularization_weight=0.0),
]


@pytest.mark.parametrize('case', range(len(_BAD)))
def test_dls_parameters_reject_what_jax_rejects(solvers, case):
  """The cases of tests/test_ik.py (an unknown site, a negative weight),
  misaligned lists and a name of another type: ValueError with JAX's
  message."""
  js, ps = solvers
  kw = dict(_BAD[case])
  types = kw.pop('object_types')
  with pytest.raises(ValueError) as jerr:
    jdls.DampedLeastSquaresParameters(
        model=js.model, object_types=[JObj[t] for t in types], **kw)
  with pytest.raises(ValueError) as perr:
    pdls.DampedLeastSquaresParameters(
        model=ps.model, object_types=[PObj[t] for t in types], **kw)
  assert str(perr.value) == str(jerr.value)


def test_mapper_object_ids_and_unsupported_type(solvers):
  js, ps = solvers
  names = ['S_fftip', ps.model.geom_names[3], ps.model.body_names[2]]
  p = pmapper.Parameters(ps.model, [PObj.SITE, PObj.GEOM, PObj.BODY], names)
  assert p.object_ids() == tuple(
      jmapper.Parameters(js.model, [JObj.SITE, JObj.GEOM, JObj.BODY],
                             names).object_ids())
  with pytest.raises(ValueError, match='not supported'):
    pmapper.Parameters(ps.model, [7], ['S_fftip'])
  with pytest.raises(TypeError):
    pmapper.CartesianVelocitytoJointVelocityMapper()


# ---------------------------------------------------------------------------
# Jacobians and joint velocities
# ---------------------------------------------------------------------------


def _states(js, seed, rows):
  rng = np.random.RandomState(seed)
  return rng.uniform(js._lo, js._hi, (rows, len(js._lo)))


def _mappers(js, ps, types, names, lam):
  jm = jdls.DampedLeastSquaresMapper(jdls.DampedLeastSquaresParameters(
      model=js.model, object_types=[JObj[t] for t in types],
      object_names=names, regularization_weight=lam))
  pm = pdls.DampedLeastSquaresMapper(pdls.DampedLeastSquaresParameters(
      model=ps.model, object_types=[PObj[t] for t in types],
      object_names=names, regularization_weight=lam))
  return jm, pm


@pytest.mark.parametrize('kind', ['SITE', 'GEOM', 'BODY'])
def test_stacked_jacobian_matches_jax(solvers, kind):
  """A site, a geom and a body on the middle finger, and a fingertip
  site, over a batch of 4 states (JAX: vmap): 1e-12 of max-abs."""
  js, ps = solvers
  name = {'SITE': 'S_mftip', 'GEOM': js.model.geom_names[-4],
          'BODY': js.model.body_names[-8]}[kind]
  jm, pm = _mappers(js, ps, [kind, 'SITE'], [name, 'S_thtip'], 0.0)
  q = _states(js, 1, 4)
  want = jax.jit(jax.vmap(lambda x: jm.stacked_jacobian(js._fk(x))))(
      jnp.asarray(q))
  got = pm.stacked_jacobian(ps._fk(torch.as_tensor(q)))
  assert got.shape == (4, 6, ps.model.nv)
  assert _rel(got, want) < 1e-12


@pytest.mark.parametrize('lam', [1e-5, 0.0])
def test_joint_velocities_match_jax(solvers, lam):
  """λ = 1e-5 (the Cholesky solve) on the five fingertips; λ = 0 (the
  minimum-norm least squares) on the five fingertips and on a
  rank-deficient J: the index fingertip and the world body, so J has
  three zero rows and a zero column for every joint off that finger.
  1e-10 of max-abs."""
  js, ps = solvers
  q = _states(js, 2, 5)
  rng = np.random.RandomState(3)
  cases = [(['SITE'] * 5, list(js.hand.fingertip_site_names))]
  if lam == 0.0:
    cases.append((['SITE', 'BODY'], ['S_fftip', js.model.body_names[0]]))
  for types, names in cases:
    jm, pm = _mappers(js, ps, types, names, lam)
    v = rng.randn(5, 3 * len(names))
    want = jax.jit(jax.vmap(
        lambda x, t: jm.compute_joint_velocities(js._fk(x), t)))(
            jnp.asarray(q), jnp.asarray(v))
    data = ps._fk(torch.as_tensor(q))
    got = pm.compute_joint_velocities(data, torch.as_tensor(v))
    assert got.shape == (5, ps.model.nv)
    assert _rel(got, want) < 1e-10, names
    if len(names) == 2:
      jac = pm.stacked_jacobian(data)
      assert bool((jac[:, 3:] == 0).all())
      assert int((jac.abs().amax(dim=(0, 1)) == 0).sum()) > 0
      # Unbatched data gives the same row.
      one = pm.compute_joint_velocities(ps._fk(torch.as_tensor(q[0])),
                                        torch.as_tensor(v[0]))
      assert _rel(one, got[0]) < 1e-12


# ---------------------------------------------------------------------------
# The attempt loop over rows
# ---------------------------------------------------------------------------


def _jax_attempts(js):
  """jax.vmap(solver._attempt), also returning each row's final step count
  and stalled flag (the loop's carry, which `_attempt` drops)."""
  def attempt(q0, targets):
    seen, real = [], jax.lax.while_loop

    def spy(cond, body, carry):
      out = real(cond, body, carry)
      seen.append(out)
      return out

    jax.lax.while_loop = spy
    try:
      qpos, err = js._attempt(q0, targets, _TOL, _MAX_STEPS)
    finally:
      jax.lax.while_loop = real
    return qpos, err, seen[0][4], seen[0][3]
  return jax.jit(jax.vmap(attempt))


def _exit_rows(js, ps):
  """Four rows, one for each exit of the loop: (converge) a start near
  the target configuration; (clip) a target configuration with joints at
  their limits, started inside; (stall) every fingertip 2 m overhead;
  (max_steps) a random start, far from its target."""
  rng = np.random.RandomState(0)
  q = rng.uniform(js._lo * 0.8, js._hi * 0.8)
  mid = (js._lo + js._hi) / 2
  r = np.random.RandomState(10)
  q_lim = np.clip(r.uniform(js._lo, js._hi)
                  + (r.rand(len(mid)) < 0.3) * (js._hi - js._lo),
                  js._lo, js._hi)
  q0 = np.stack([np.clip(q + 0.05 * rng.randn(len(q)), js._lo, js._hi),
                 0.8 * q_lim + 0.2 * mid, mid,
                 rng.uniform(js._lo, js._hi)])
  targets = np.stack([_fk_tips(ps, q), _fk_tips(ps, q_lim),
                      np.tile([0.0, 0.0, 2.0], (5, 1)), _fk_tips(ps, q)])
  return q0, targets.reshape(4, -1)


def test_attempt_rows_match_jax_at_every_exit(solvers):
  js, ps = solvers
  q0, targets = _exit_rows(js, ps)
  jq, jerr, jsteps, jstalled = _jax_attempts(js)(jnp.asarray(q0),
                                                 jnp.asarray(targets))
  pq, perr, psteps = ps._attempt(torch.as_tensor(q0),
                                 torch.as_tensor(targets), _TOL, _MAX_STEPS)
  np.testing.assert_array_equal(psteps.numpy(), np.asarray(jsteps))
  assert np.abs(pq.numpy() - np.asarray(jq)).max() < 1e-8
  assert np.abs(perr.numpy() - np.asarray(jerr)).max() < 1e-9
  # Each row leaves by its own exit.
  ok = (perr <= _TOL).all(-1).numpy()
  steps, stalled = psteps.numpy(), np.asarray(jstalled)
  at_limit = ((pq.numpy() == js._lo) | (pq.numpy() == js._hi)).any(-1)
  assert ok[0] and not at_limit[0] and steps[0] < _MAX_STEPS
  assert ok[1] and at_limit[1] and steps[1] < _MAX_STEPS
  assert not ok[2] and stalled[2] and steps[2] < _MAX_STEPS
  assert not ok[3] and not stalled[3] and steps[3] == _MAX_STEPS


def test_attempt_keeps_a_finished_row_bit_for_bit(solvers):
  """A row that has left the loop is not touched by the iterations the
  other rows still run: alone or beside a row that runs to max_steps, it
  ends the same to the bit."""
  _, ps = solvers
  js = solvers[0]
  q0, targets = _exit_rows(js, ps)
  both = ps._attempt(torch.as_tensor(q0[[0, 3]]),
                     torch.as_tensor(targets[[0, 3]]), _TOL, _MAX_STEPS)
  alone = ps._attempt(torch.as_tensor(q0[:1]), torch.as_tensor(targets[:1]),
                      _TOL, _MAX_STEPS)
  assert int(both[2][0]) < int(both[2][1])
  for a, b in zip(both, alone):
    assert torch.equal(a[:1], b)


# ---------------------------------------------------------------------------
# solve and solve_batch
# ---------------------------------------------------------------------------


def _jax_inits(js, key, attempts):
  """JAX's initial configurations of one solve (ik_solver.py:120-122)."""
  inits = jax.random.uniform(key, (attempts, len(js._lo)), jnp.float64,
                             js._lo, js._hi)
  return np.asarray(inits.at[0].set(js._nullspace_reference))


def _chosen(ps, inits, targets, qpos):
  """The attempt whose result the solve returned."""
  q, _, _ = ps._attempt(torch.as_tensor(inits),
                        torch.as_tensor(targets).reshape(1, -1)
                        .expand(len(inits), -1), _TOL, 100)
  return int(np.abs(q.numpy() - np.asarray(qpos)).max(-1).argmin())


def test_solve_batch_matches_jax_with_the_fallback(solvers, monkeypatch):
  """2 sets x 6 attempts, the second 2 m overhead (no attempt succeeds, so
  the least-max-error fallback picks): equal chosen attempt and success,
  qpos to 1e-8."""
  js, ps = solvers
  rng = np.random.RandomState(4)
  q = rng.uniform(js._lo * 0.8, js._hi * 0.8)
  targets = np.stack([_fk_tips(ps, q), np.tile([0.0, 0.0, 2.0], (5, 1))])
  key = jax.random.PRNGKey(5)
  jq, jok = jax.jit(lambda t: js.solve_batch(t, key=key, num_attempts=6))(
      jnp.asarray(targets))
  inits = np.stack([_jax_inits(js, k, 6) for k in jax.random.split(key, 2)])
  # Set i's draws; `solve` of the second set alone gets its own.
  monkeypatch.setattr(ps, '_initial_configurations',
                      lambda n, a, gen: torch.tensor(inits[-n:]))
  pq, pok = ps.solve_batch(torch.as_tensor(targets), num_attempts=6)
  np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
  assert pok.tolist() == [True, False]
  assert np.abs(pq.numpy() - np.asarray(jq)).max() < 1e-8
  for i in range(2):
    assert (_chosen(ps, inits[i], targets[i], pq[i])
            == _chosen(ps, inits[i], targets[i], jq[i]))
  one_q, one_ok = ps.solve(torch.as_tensor(targets[1]), num_attempts=6,
                           early_stop=True,
                           stop_on_first_successful_attempt=True)
  assert not bool(one_ok) and one_q.shape == (24,)
  assert np.abs(one_q.numpy() - pq[1].numpy()).max() < 1e-12


def test_shadow_hand_solve_matches_jax(monkeypatch):
  """One ShadowHandSeriesE solve, 4 attempts, from JAX's draws."""
  js = jik.IKSolver(jhands.ShadowHandSeriesE())
  ps = pik.IKSolver(phands.ShadowHandSeriesE(), device='cpu',
                    dtype=torch.float64)
  rng = np.random.RandomState(6)
  q = rng.uniform(js._lo * 0.8, js._hi * 0.8)
  targets = _fk_tips(ps, q)
  key = jax.random.PRNGKey(7)
  jq, jok = jax.jit(lambda t: js.solve(t, num_attempts=4, key=key))(
      jnp.asarray(targets))
  inits = _jax_inits(js, key, 4)[None]
  monkeypatch.setattr(ps, '_initial_configurations',
                      lambda n, a, gen: torch.tensor(inits))
  pq, pok = ps.solve(torch.as_tensor(targets), num_attempts=4)
  assert bool(pok) == bool(jok)
  assert np.abs(pq.numpy() - np.asarray(jq)).max() < 1e-8


# ---------------------------------------------------------------------------
# tests/test_ik.py's cases on the port alone
# ---------------------------------------------------------------------------


def test_feasible_targets_solved(solvers):
  """Five FK targets, 10 attempts each, in one solve_batch: at least 4
  solved, each solution's FK within 1.5 tol and its joints in range."""
  _, ps = solvers
  targets = []
  for seed in range(5):
    rng = np.random.RandomState(seed)
    targets.append(_fk_tips(ps, rng.uniform(ps._lo * 0.8, ps._hi * 0.8)))
  targets = np.stack(targets)
  qpos, ok = ps.solve_batch(torch.as_tensor(targets), num_attempts=10,
                            gen=torch.Generator().manual_seed(0))
  assert int(ok.sum()) >= 4
  for i in np.flatnonzero(ok.numpy()):
    err = np.linalg.norm(_fk_tips(ps, qpos[i].numpy()) - targets[i], axis=1)
    assert np.all(err <= _TOL * 1.5), err
    assert np.all(qpos[i].numpy() >= ps._lo - 1e-9)
    assert np.all(qpos[i].numpy() <= ps._hi + 1e-9)


def test_infeasible_target_fails(solvers):
  _, ps = solvers
  targets = np.tile(np.array([0.0, 0.0, 2.0]), (5, 1))
  _, ok = ps.solve(torch.as_tensor(targets), num_attempts=3)
  assert not bool(ok)


def test_initial_configurations(solvers):
  """Uniform in the joint ranges, attempt 0 at the midpoint; one
  generator seed gives one draw."""
  _, ps = solvers
  a = ps._initial_configurations(3, 5, torch.Generator().manual_seed(1))
  b = ps._initial_configurations(3, 5, torch.Generator().manual_seed(1))
  assert a.shape == (3, 5, 24) and a.dtype == torch.float64
  assert torch.equal(a, b)
  mid = torch.as_tensor(ps._nullspace_reference)
  assert torch.equal(a[:, 0], mid.expand(3, -1))
  assert bool((a >= torch.as_tensor(ps._lo)).all())
  assert bool((a <= torch.as_tensor(ps._hi)).all())
