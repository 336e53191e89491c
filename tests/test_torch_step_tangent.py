"""The forward-mode tangent through the port's physics step against the
JAX package (the fault this slice repaired: the port's tangent through
the refactor Newton took dH, JAX's rule drops it).

Float64 on the CPU, from the seeded contact-rich reorient scene of
tests/torch_scene.py on the planning model at the iLQR defaults (refactor
every 4): the port's `torch.autograd.forward_ad` JVP of `step_n` against
`jax.jvp` of JAX's `step_n`, for a qpos and a ctrl tangent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.physics import step as jstep
from dexterity_tpu.planners import common as jcommon
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.physics import step as pstep
from dexterity_tpu_torch.planners import common as pcommon
from torch_scene import F64, PLAN, build_scene, jdata, pdata


def _np(x):
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
  want = _np(want)
  return float(np.max(np.abs(_np(got) - want)) / np.max(np.abs(want)))


@pytest.fixture(scope='module')
def scene():
  return build_scene()


def test_step_n_tangent_matches_jax(scene):
  """forward_ad JVP of the port's step_n against jax.jvp of JAX's step_n
  on the contact-rich reorient scene (planning model at the iLQR
  defaults: refactor every 4, 3 substeps), for a unit tangent on
  qpos[:, 0] and one on ctrl[:, 3].  K1's rule drops dH and the refactor
  Hessian is detached, as the JAX package stops its gradient: the exact
  derivative of the plain loop (what the port took before) gives qvel's
  tangent 64.4 against JAX's 127.5 here."""
  jtask = jmanip.build_task('reorient', 'state_dense')
  ptask = pmanip.build_task('reorient', 'state_dense')
  plan = dict(PLAN, solver_refactor_every=4)
  jm, _ = jcommon.reduced_planning_model(jtask, **plan)
  pm, n = pcommon.reduced_planning_model(ptask, **F64, **plan)
  state = scene['state']
  jd = jdata(jm, state)

  def jvp_one(d, tq, tc):
    f = lambda q, c: jstep.step_n(jm, d.replace(qpos=q, ctrl=c), n,
                                  refresh=jtask.plan_refresh)
    _, t = jax.jvp(f, (d.qpos, d.ctrl), (tq, tc))
    return t.qpos, t.qvel

  jvp = jax.jit(jax.vmap(jvp_one))
  for field, col in (('qpos', 0), ('ctrl', 3)):
    tq = np.zeros_like(state['qpos'])
    tc = np.zeros_like(state['ctrl'])
    (tq if field == 'qpos' else tc)[:, col] = 1.0
    jq, jv = jvp(jd, jnp.asarray(tq), jnp.asarray(tc))
    d = pdata(pm, state)
    with forward_ad.dual_level():
      d = d.replace(qpos=forward_ad.make_dual(d.qpos, torch.as_tensor(tq)),
                    ctrl=forward_ad.make_dual(d.ctrl, torch.as_tensor(tc)))
      out = pstep.step_n(pm, d, n, refresh=ptask.plan_refresh)
      pq = forward_ad.unpack_dual(out.qpos).tangent
      pv = forward_ad.unpack_dual(out.qvel).tangent
    assert pv is not None and float(np.abs(_np(jv)).max()) > 1.0, field
    assert _rel(pq, jq) < 1e-9, field
    assert _rel(pv, jv) < 1e-9, (field, _rel(pv, jv))
