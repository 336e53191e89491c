"""Gradient planners of the PyTorch port (iLQR, SQP) against the JAX
package, on the reach task.

Both sides compute in float64 on the CPU from identical inputs.  Reach's
start states and goals come from the port's GoalEnvironment.reset
(seeded CPU generator), carried to JAX as numpy arrays.  `ILQR.solve`
and `SQP.solve` are held against JAX's jitted solve, vmapped over the
goals; the rest holds the port to its own contract: batching, the alpha
= 0 fallback, `extra_cost_fn`, `warm_start`.  The linearization is
tests/test_torch_ilqr_linearization.py's, reorient's solve
tests/test_torch_ilqr_reorient.py's and the forward-mode tangent through
the physics step tests/test_torch_step_tangent.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.planners import ilqr as jilqr
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.planners import ilqr as pilqr
from torch_planners import CFG, G, TOL, check_solve, inputs, jax_solve
from torch_planners import one_thread, planners, rel, state_fields
from torch_planners import to_np, to_port
from torch_scene import F64


@pytest.fixture(scope='module')
def reach(one_thread):
  env = pmanip.load('reach', 'state_dense', **F64)
  state, _ = env.reset(torch.Generator().manual_seed(3), (G,))
  return dict(fields=state_fields(state.data),
              goals=state.task.goal.numpy())


def test_ilqr_solve_matches_jax(reach):
  """ILQR.solve (H = 2, 2 iterations, 3 line-search steps) for 2 goals
  against JAX's jitted vmap(solve): action, next plan and cost."""
  jp, pp = planners('reach', 'state_dense', CFG)
  jd, jg, pd, pg = inputs(jp, pp, reach)
  st = pp.init_state(streams=G)
  out = pp.solve(pd, pg, st)
  jout = jax_solve(jp, jd, jg, jnp.asarray(to_np(st.us)))
  check_solve(pp, out, jout)


def test_sqp_solve_matches_jax(reach):
  """SQP.solve (H = 2, 1 iteration, 3 line-search steps, 2 QP
  iterations) for 2 goals against JAX's jitted vmap(solve)."""
  cfg = dict(CFG, iterations=1, qp_iterations=2)
  jp, pp = planners('reach', 'state_dense', cfg, sqp=True)
  jd, jg, pd, pg = inputs(jp, pp, reach)
  st = pp.init_state(streams=G)
  out = pp.solve(pd, pg, st)
  jout = jax_solve(jp, jd, jg, jnp.asarray(to_np(st.us)))
  check_solve(pp, out, jout)


def test_init_state_warm_start_and_trajectory_cost_match_jax(reach):
  """init_state is the mid-range plan; warm_start of a shorter plan
  repeats its last action; trajectory_cost against JAX's."""
  jp, pp = planners('reach', 'state_dense', dict(CFG, horizon=3))
  jd, jg, pd, pg = inputs(jp, pp, reach)
  st = pp.init_state(streams=G)
  assert st.us.shape == (G, 3, pp.nu) and bool(torch.isinf(st.cost).all())
  np.testing.assert_array_equal(to_np(st.us[0]), np.asarray(jp.init_state().us))
  rng = np.random.default_rng(7)
  lo, hi = to_np(pp._lo), to_np(pp._hi)
  plan = lo + (hi - lo) * rng.uniform(size=(G, 2, pp.nu))
  warm = pp.warm_start(torch.as_tensor(plan))
  assert warm.us.shape == (G, 3, pp.nu)
  np.testing.assert_array_equal(to_np(warm.us[:, :2]), plan)
  np.testing.assert_array_equal(to_np(warm.us[:, 2]), plan[:, 1])
  np.testing.assert_array_equal(
      to_np(pp.warm_start(torch.as_tensor(plan[0])).us),
      np.asarray(jp.warm_start(jnp.asarray(plan[0])).us))
  got = pp.trajectory_cost(pd, pg, pp._pack(pd), warm.us)
  want = jax.jit(jax.vmap(lambda d, g, u: jp.trajectory_cost(
      d, g, jp._pack(d), u)))(jd, jg, jnp.asarray(to_np(warm.us)))
  assert got.shape == (G,)
  assert rel(got, want) < TOL


def test_goals_in_one_batch_equal_single_goal_solves(reach):
  """G = 2 goals in one batch give what two single-goal solves give."""
  pp = planners('reach', 'state_dense', CFG)[1]
  pd = to_port(pp.model, reach['fields'])
  pg = torch.as_tensor(reach['goals'])
  act, st = pp.solve(pd, pg, pp.init_state(streams=G))
  for i in range(G):
    one = PT.map_data(pd, lambda x: x[i:i + 1])
    a1, s1 = pp.solve(one, pg[i:i + 1], pp.init_state(streams=1))
    np.testing.assert_allclose(to_np(a1[0]), to_np(act[i]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_np(s1.us[0]), to_np(st.us[i]), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(to_np(s1.cost[0]), to_np(st.cost[i]), rtol=1e-12)


def test_alpha_zero_replays_the_plan_on_nan_gains(reach, monkeypatch):
  """A backward pass that gives NaN gains leaves only the alpha = 0
  candidate finite: the solve keeps the nominal plan exactly (a
  selection, not 0 x NaN) and reports its cost."""
  pp = planners('reach', 'state_dense', dict(CFG, iterations=1))[1]
  pd = to_port(pp.model, reach['fields'])
  pg = torch.as_tensor(reach['goals'])
  st = pp.init_state(streams=G)
  real = pp._backward_pass

  def nan_gains(*args):
    ks, kks = real(*args)
    return torch.full_like(ks, float('nan')), torch.full_like(kks,
                                                              float('nan'))

  monkeypatch.setattr(pp, '_backward_pass', nan_gains)
  act, out = pp.solve(pd, pg, st)
  assert torch.equal(act, st.us[:, 0])
  assert torch.equal(out.us[:, :-1], st.us[:, 1:])
  nominal = pp.trajectory_cost(pd, pg, pp._pack(pd), st.us)
  np.testing.assert_allclose(to_np(out.cost), to_np(nominal), rtol=1e-12)


def test_batched_extra_cost_fn_enters_the_cost(reach):
  """A batched extra_cost_fn (model, data (M, ...), goals) -> (M,) adds to
  every stage cost: here 0.5 + |qpos_0| per row, held against JAX's
  per-goal extra_cost_fn on trajectory_cost."""
  jtask = jmanip.build_task('reach', 'state_dense')
  ptask = pmanip.build_task('reach', 'state_dense')
  cfg = dict(CFG)
  seen = []

  def pextra(model, data, goals):
    seen.append(data.qpos.shape[0])
    return 0.5 + data.qpos[:, 0].abs()

  jp = jilqr.ILQR(jtask, jilqr.ILQRConfig(**cfg), extra_cost_fn=(
      lambda model, data, goal: 0.5 + jnp.abs(data.qpos[0])))
  pp = pilqr.ILQR(ptask, pilqr.ILQRConfig(**cfg), extra_cost_fn=pextra,
                  **F64)
  plain = pilqr.ILQR(ptask, pilqr.ILQRConfig(**cfg), **F64)
  jd, jg, pd, pg = inputs(jp, pp, reach)
  us = pp.init_state(streams=G).us
  got = pp.trajectory_cost(pd, pg, pp._pack(pd), us)
  assert seen == [G, G]
  base = plain.trajectory_cost(pd, pg, plain._pack(pd), us)
  assert bool((got - base >= 1.0 - 1e-12).all())
  want = jax.jit(jax.vmap(lambda d, g, u: jp.trajectory_cost(
      d, g, jp._pack(d), u)))(jd, jg, jnp.asarray(to_np(us)))
  assert rel(got, want) < TOL
