"""The port's iLQR solve on the reorient task against the JAX package
(a file of its own: JAX's reorient solve compiles in about two minutes
on the CPU, and `--dist loadfile` spreads files).

Both sides compute in float64 on the CPU from two states of the seeded
contact-rich reorient scene of tests/torch_scene.py and two seeded goal
quaternions, carried to JAX as numpy arrays.
"""

import jax.numpy as jnp
import pytest

from torch_planners import G, REORIENT_CFG, check_solve, inputs, jax_solve
from torch_planners import one_thread, planners, reorient_case, to_np


@pytest.fixture(scope='module')
def reorient(one_thread):
  return reorient_case()


def test_ilqr_solve_matches_jax_on_reorient(reorient):
  """ILQR.solve (H = 2, 1 iteration, 2 line-search steps) for 2 goals
  from the mid-range plan against JAX's jitted vmap(solve): action, next
  plan and cost."""
  jp, pp = planners('reorient', 'state_dense', REORIENT_CFG)
  jd, jg, pd, pg = inputs(jp, pp, reorient)
  st = pp.init_state(streams=G)
  out = pp.solve(pd, pg, st)
  check_solve(pp, out, jax_solve(jp, jd, jg, jnp.asarray(to_np(st.us))))
