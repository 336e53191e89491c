"""The iLQR linearization in float32 against float64, in the JAX package
and in the port, at the same pre-step states and controls on reorient's
planning model.

The reference's Jacobian is not continuous at float32's rounding: a
Newton iteration whose line search is decided by the last bits of its
costs keeps or drops a correction in the tangent, so a float32
linearization can part from the float64 one by more than the Jacobian's
own size.  This module is the witness the card's hold (chip_smoke.py
`_lin_hold`) rests on: at eight states along a rollout from reorient's
reset, JAX's float32 linearization parts from the float64 one by more
than 0.1 of max-abs, the port's float32 parts no further than ten times
that, and where JAX's float32 resolves a block to 1e-3 the port's does
too.  The float64 side is the port's, which tests/test_torch_ilqr_*.py
hold to JAX's float64 at 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.planners import ilqr as jilqr
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.planners import ilqr as pilqr
from torch_planners import jax_linearize, one_thread, state_fields, to_jax
from torch_planners import to_np

CFG = dict(horizon=8, plan_substeps=3)
# A block is resolved in float32 when every Jacobian in it parts from
# float64 by at most this share of the float64 block's max-abs.
RESOLVED = 1e-3


def block_errs(got, ref):
  """The largest relative error over (fx, fu) per (goal, t) block."""
  out = 0
  for a, b in zip(got[:2], ref[:2]):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    g, h = b.shape[:2]
    err = np.abs(a - b).reshape(g, h, -1).max(-1)
    out = np.maximum(out, err / np.abs(b).reshape(g, h, -1).max(-1))
  return out


def test_float32_parts_from_float64_as_in_the_reference(one_thread):
  env = pmanip.load('reorient', 'state_dense', device='cpu',
                    dtype=torch.float64)
  state, _ = env.reset(torch.Generator().manual_seed(6), (8,))
  # Every input rounded to float32 once: both precisions start from the
  # same numbers.
  r32 = lambda x: x.float() if x.is_floating_point() else x
  d32 = PT.map_data(state.data, lambda x: r32(x[:1]))
  d64 = PT.map_data(d32, lambda x: x.double() if x.is_floating_point() else x)
  g32 = r32(state.task.goal[:1])
  p64, p32 = (pilqr.ILQR(env.task, pilqr.ILQRConfig(**CFG), device='cpu',
                         dtype=dt) for dt in (torch.float64, torch.float32))
  us32 = r32(p64.init_state(streams=1).us)
  xs32 = r32(p64._rollout(d64, p64._pack(d64), us32.double()))
  ref = [to_np(a) for a in p64._linearize(d64, g32.double(), xs32.double(),
                                          us32.double())]
  port32 = p32._linearize(d32, g32, xs32, us32)

  with jax.enable_x64(False):
    jp = jilqr.ILQR(jmanip.build_task('reorient', 'state_dense'),
                    jilqr.ILQRConfig(**CFG))
    assert jp.dtype == jnp.float32
    jax32 = jax_linearize(jp, to_jax(jp.model, state_fields(d32)),
                          jnp.asarray(to_np(g32)), jnp.asarray(to_np(xs32)),
                          jnp.asarray(to_np(us32)))
    jax32 = [np.asarray(a) for a in jax32]

  err_jax = block_errs(jax32, ref)
  err_port = block_errs([to_np(a) for a in port32], ref)
  assert np.isfinite(err_port).all()
  assert err_jax.max() > 0.1, err_jax
  assert err_port.max() <= 10 * err_jax.max(), (err_port, err_jax)
  resolved = err_jax <= RESOLVED
  assert resolved.any(), err_jax
  assert (err_port[resolved] <= RESOLVED).all(), (err_port, err_jax)
