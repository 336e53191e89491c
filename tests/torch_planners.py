"""Shared inputs and holds of the gradient-planner tests
(tests/test_torch_ilqr*.py): both packages' planners on one task, one
state carried to both as numpy arrays, the linearization and solve
holds, and one torch thread per test module.

The port's float64 physics on the CPU spreads its larger batches (the
linearization rows) over every core; with several test workers on one
machine those threads oversubscribe it, so these modules run torch on
one thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.core import types as JT
from dexterity_tpu.planners import ilqr as jilqr
from dexterity_tpu.planners import sqp as jsqp
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.planners import ilqr as pilqr
from dexterity_tpu_torch.planners import sqp as psqp
from torch_scene import F64, build_scene


@pytest.fixture(scope='module')
def one_thread():
  """torch on one thread for the module, restored after it."""
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)


G = 2
# Reach's solve: H = 2, 2 iterations, 3 line-search steps.
CFG = dict(horizon=2, iterations=2, line_search_steps=3, plan_substeps=3)
# Reorient's: H = 2, 1 iteration, 2 line-search steps.
REORIENT_CFG = dict(horizon=2, iterations=1, line_search_steps=2,
                    plan_substeps=3)
# Float64 on both sides; the physics agree to ~1e-12 and the solve's
# comparisons (argmin, active set) see the same ordering.
TOL = 1e-8


def to_np(x):
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel(got, want):
  want = to_np(want)
  return float(np.max(np.abs(to_np(got) - want)) / max(np.max(np.abs(want)),
                                                     1e-12))


def state_fields(data):
  """Every tensor field of a port Data but the contacts, as numpy."""
  return {f.name: getattr(data, f.name).numpy()
          for f in dataclasses.fields(data) if f.name != 'contact'}


def to_port(pm, fields):
  b = fields['qpos'].shape[0]
  return PT.make_data(pm, (b,)).replace(
      **{k: torch.as_tensor(v) for k, v in fields.items()})


def to_jax(jm, fields):
  b = fields['qpos'].shape[0]
  d = jax.tree_util.tree_map(
      lambda x: jnp.broadcast_to(x[None], (b,) + x.shape), JT.make_data(jm))
  return d.replace(**{k: jnp.asarray(v) for k, v in fields.items()})


def planners(domain, variant, cfg, sqp=False):
  jtask = jmanip.build_task(domain, variant)
  ptask = pmanip.build_task(domain, variant)
  if sqp:
    return (jsqp.SQP(jtask, jsqp.SQPConfig(**cfg)),
            psqp.SQP(ptask, psqp.SQPConfig(**cfg), **F64))
  return (jilqr.ILQR(jtask, jilqr.ILQRConfig(**cfg)),
          pilqr.ILQR(ptask, pilqr.ILQRConfig(**cfg), **F64))


def inputs(jp, pp, case):
  """JAX's and the port's Data and goals from a case's numpy fields and
  goals."""
  return (to_jax(jp.model, case['fields']), jnp.asarray(case['goals']),
          to_port(pp.model, case['fields']),
          torch.as_tensor(case['goals']))


def reorient_case():
  """Two states of tests/torch_scene.py's contact-rich reorient scene and
  two seeded goal quaternions."""
  state = build_scene()['state']
  rng = np.random.default_rng(6)
  goals = rng.normal(size=(G, 4))
  goals /= np.linalg.norm(goals, axis=1, keepdims=True)
  return dict(fields={k: v[:G] for k, v in state.items()}, goals=goals,
              rng=rng)


# ---------------------------------------------------------------------------
# Linearization
# ---------------------------------------------------------------------------


def jax_linearize(jp, jd, goals, xs, us):
  """jax.jacfwd of JAX's _f / _cost per (goal, t), as ILQR.solve takes it
  (ilqr.py:184-200)."""
  nx = jp.nx

  def one(d, goal, x, u):
    def f_c(z):
      return (jp._f(d, z[:nx], z[nx:]), jp._cost(d, goal, z[:nx], z[nx:]))
    fz, cz = jax.jacfwd(f_c)(jnp.concatenate([x, u]))
    return fz[:, :nx], fz[:, nx:], cz[:nx], cz[nx:]

  per_t = jax.vmap(one, in_axes=(None, None, 0, 0))
  return jax.jit(jax.vmap(per_t))(jd, goals, xs, us)


# Relative changes of xs that show a block's rounding-level sensitivity.
NUDGES = (4e-15, -4e-15, 1e-14, -1e-14)


def check_linearization(pp, pd, pg, xs, us, want):
  """Holds the port's (fx, fu, cx, cu) at (xs, us) to JAX's `want`, per
  (goal, t) block, relative to each Jacobian's max-abs; returns the
  errors and the blocks found sensitive.

  The reference's linearization is not continuous at the rounding level:
  once a Newton iteration has converged, whether its line search takes a
  step (`cmin < c0`) is decided by the last bits of the costs, and the
  tangent keeps or drops that step's correction.  A block is `sensitive`
  when the port's own Jacobian moves by more than 1e-9 of its max-abs
  under a relative change of xs in NUDGES (it moves by 1e-4 in some
  such blocks on reach); JAX rounds differently and may decide the other
  way there.  Every other block agrees to TOL, and at least one block
  is not sensitive; a sensitive block agrees to 1e-2, which bounds one
  correction (up to 5.3e-4 of the max-abs on reorient, float64)."""
  got = pp._linearize(pd, pg, xs, us)
  g, h = us.shape[:2]
  sensitive = np.zeros((g, h), bool)
  for nudge in NUDGES:
    for a, b in zip(got, pp._linearize(pd, pg, xs * (1 + nudge), us)):
      scale = float(a.abs().max())
      sensitive |= to_np((a - b).abs().flatten(2).amax(-1)) > 1e-9 * scale
  assert not sensitive.all(), sensitive
  errs = {}
  for name, a, b in zip(('fx', 'fu', 'cx', 'cu'), got, want):
    assert a.shape == b.shape, name
    scale = float(np.abs(to_np(b)).max())
    assert scale > 0, name
    err = np.abs(to_np(a) - to_np(b)).reshape(g, h, -1).max(-1) / scale
    assert (err[~sensitive] < TOL).all(), (name, err, sensitive)
    assert (err < 1e-2).all(), (name, err)
    errs[name] = err
  return errs, sensitive


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------


def jax_solve(jp, jd, jg, us):
  solve = jax.jit(jax.vmap(lambda d, g, u: jp.solve(
      d, g, jilqr.ILQRState(us=u, cost=jnp.asarray(jnp.inf)))))
  return solve(jd, jg, us)


def check_solve(pp, out, jout):
  (act, st), (jact, jst) = out, jout
  assert act.shape == (G, pp.nu)
  assert bool(torch.isfinite(st.cost).all())
  assert rel(act, jact) < TOL
  assert rel(st.us, jst.us) < TOL
  assert rel(st.cost, jst.cost) < TOL
  assert bool((st.us[:, -1] == st.us[:, -2]).all())
