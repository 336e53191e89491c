"""The seeded contact-rich reorient scene shared by the port's physics
tests (tests/test_torch_physics.py, tests/test_torch_step.py).

A batch of reorient states (seeded hand pose, cube at the spawn-workspace
centre with a seeded orientation) is advanced a few control steps by the
port itself until the cube rests in contact; both packages then compute
from these float64 states, carried to JAX as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dexterity_tpu import manipulation
from dexterity_tpu.core import types as JT
from dexterity_tpu.planners import common as jcommon
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.physics import step as pstep
from dexterity_tpu_torch.planners import common as pcommon

PLAN = dict(solver_iterations=4, ls_iterations=6, solver_refactor_every=2,
            plan_substeps=3, plan_midphase_cap=16, plan_contact_top_k=16,
            plan_implicit_damping=True, plan_self_collision=False)
B = 4
F64 = dict(device='cpu', dtype=torch.float64)


def start_state(pm, rng, batch, band=0.3):
  """Seeded reorient start: hand hinge joints within a band of their
  ranges around 0, cube at the spawn-workspace centre, random quaternion."""
  qpos = np.repeat(pm.qpos0.numpy()[None], batch, 0)
  for j in range(pm.njnt):
    if pm.jnt_type[j] == int(PT.JointType.HINGE) and pm.jnt_limited[j]:
      lo, hi = pm.jnt_range[j].tolist()
      mid = min(max(0.0, lo), hi)
      a = pm.jnt_qposadr[j]
      qpos[:, a] = np.clip(mid + band * (hi - lo) * rng.uniform(
          -0.5, 0.5, batch), lo, hi)
  free = [j for j in range(pm.njnt)
          if pm.jnt_type[j] == int(PT.JointType.FREE)][0]
  qa = pm.jnt_qposadr[free]
  qpos[:, qa:qa + 3] = (0.0, -0.13, 0.16)
  q = rng.normal(size=(batch, 4))
  qpos[:, qa + 3:qa + 7] = q / np.linalg.norm(q, axis=1, keepdims=True)
  return qpos


def ctrl(pm, rng, batch, band=0.3):
  lo = pm.actuator_ctrlrange[:, 0].numpy()
  hi = pm.actuator_ctrlrange[:, 1].numpy()
  return lo + (hi - lo) * (0.5 + band * (rng.uniform(size=(batch,
                                                             pm.nu)) - 0.5))


def build_scene():
  """Both packages' environment and planning models and the shared
  state (time, qpos, qvel, qacc, ctrl as numpy arrays)."""
  jtask = manipulation.build_task('reorient', 'state_dense')
  ptask = pmanip.build_task('reorient', 'state_dense')
  jenv, penv = jtask.compile(), ptask.compile(**F64)
  jplan, _ = jcommon.reduced_planning_model(jtask, **PLAN)
  pplan, n = pcommon.reduced_planning_model(ptask, **F64, **PLAN)
  rng = np.random.default_rng(1)
  d = PT.make_data(pplan, (B,)).replace(
      qpos=torch.as_tensor(start_state(pplan, rng, B)))
  for _ in range(8):
    d = d.replace(ctrl=torch.as_tensor(ctrl(pplan, rng, B)))
    d = pstep.step_n_b(pplan, d, n, refresh='none', midphase='per_call',
                       carry='minimal')
  state = {f: getattr(d, f).numpy() for f in ('time', 'qpos', 'qvel', 'qacc')}
  state['ctrl'] = ctrl(pplan, rng, B)
  return dict(jenv=jenv, penv=penv, jplan=jplan, pplan=pplan, state=state)


def pdata(pm, state):
  b = state['qpos'].shape[0]
  return PT.make_data(pm, (b,)).replace(
      **{k: torch.as_tensor(v) for k, v in state.items()})


def jdata(jm, state):
  b = state['qpos'].shape[0]
  d = JT.make_data(jm)
  d = jax.tree_util.tree_map(
      lambda x: jnp.broadcast_to(x[None], (b,) + x.shape), d)
  return d.replace(**{k: jnp.asarray(v) for k, v in state.items()})


def models(scene, which):
  return scene['j' + which], scene['p' + which]


def to_np(x):
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pair_inputs(t1, t2, rng, n=64):
  """Random poses and sizes for n pairs of geom types (t1, t2), as
  tests/test_collision_soa.py draws them: (p1, m1, s1, p2, m2, s2)."""
  def pose():
    q = rng.randn(4)
    w, x, y, z = q / np.linalg.norm(q)
    mat = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return rng.uniform(-0.05, 0.05, 3), mat

  def size(t):
    if t == JT.GeomType.PLANE:
      return np.array([1.0, 1.0, 0.1])
    if t == JT.GeomType.SPHERE:
      return np.array([rng.uniform(0.02, 0.06), 0, 0])
    if t == JT.GeomType.CAPSULE:
      return np.array([rng.uniform(0.01, 0.03), rng.uniform(0.02, 0.05), 0])
    return rng.uniform(0.02, 0.06, 3)

  cols = [[] for _ in range(6)]
  for _ in range(n):
    p1, m1 = (np.zeros(3), np.eye(3)) if t1 == JT.GeomType.PLANE else pose()
    p2, m2 = pose()
    for c, v in zip(cols, (p1, m1, size(t1), p2, m2, size(t2))):
      c.append(v)
  return [np.asarray(c) for c in cols]
