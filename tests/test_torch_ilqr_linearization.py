"""The port's iLQR linearization (fx, fu, cx, cu from forward-mode
tangents through the physics) against `jax.jacfwd` of JAX's `ILQR._f` /
`_cost`, on reach (refactor every 4: K1's and K2's rules; every 1: K3's)
and reorient (nx = 61, nu = 20), float64 on the CPU, held as
tests/torch_planners.py's check_linearization says.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu_torch import manipulation as pmanip
from torch_planners import CFG, G, REORIENT_CFG, check_linearization
from torch_planners import inputs, jax_linearize, one_thread, planners
from torch_planners import reorient_case, state_fields, to_np
from torch_scene import F64


@pytest.fixture(scope='module')
def reach(one_thread):
  env = pmanip.load('reach', 'state_dense', **F64)
  state, _ = env.reset(torch.Generator().manual_seed(3), (G,))
  return dict(fields=state_fields(state.data),
              goals=state.task.goal.numpy())


@pytest.mark.parametrize('refactor', [4, 1])
def test_linearization_matches_jax(reach, refactor):
  """fx, fu, cx, cu of the port's forward-mode rows against jax.jacfwd at
  the same pre-step states and controls (a seeded plan's rollout), held
  as check_linearization says.  Refactor 4 carries the tangents through
  K1's and K2's rules, refactor 1 through K3's."""
  jp, pp = planners('reach', 'state_dense',
                    dict(CFG, solver_refactor_every=refactor))
  jd, jg, pd, pg = inputs(jp, pp, reach)
  rng = np.random.default_rng(5)
  lo, hi = to_np(pp._lo), to_np(pp._hi)
  us = torch.as_tensor(lo + (hi - lo) * rng.uniform(size=(G, 2, pp.nu)))
  xs = pp._rollout(pd, pp._pack(pd), us)
  want = jax_linearize(jp, jd, jg, jnp.asarray(to_np(xs)), jnp.asarray(
      to_np(us)))
  check_linearization(pp, pd, pg, xs, us, want)


def test_linearization_matches_jax_on_reorient(one_thread):
  """fx, fu, cx, cu at a seeded plan's rollout from two states of the
  contact-rich reorient scene (nx = 61, nu = 20) against jax.jacfwd of
  JAX's _f / _cost, held as check_linearization says (refactor every 4:
  K1's and K2's rules carry the tangents)."""
  case = reorient_case()
  jp, pp = planners('reorient', 'state_dense', REORIENT_CFG)
  assert (pp.nx, pp.nu) == (61, 20)
  jd, jg, pd, pg = inputs(jp, pp, case)
  lo, hi = to_np(pp._lo), to_np(pp._hi)
  us = torch.as_tensor(lo + (hi - lo) * case['rng'].uniform(
      size=(G, 2, pp.nu)))
  xs = pp._rollout(pd, pp._pack(pd), us)
  want = jax_linearize(jp, jd, jg, jnp.asarray(to_np(xs)),
                       jnp.asarray(to_np(us)))
  check_linearization(pp, pd, pg, xs, us, want)
