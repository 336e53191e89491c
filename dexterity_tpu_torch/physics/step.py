"""Forward dynamics and the physics step (port of
dexterity_tpu/physics/step.py).

`forward(model, data)` recomputes every derived quantity from (qpos, qvel,
ctrl, mocap); `step` is forward plus Euler integration.  Both run the AoS
pipeline: FK, CRB, the narrow phase into data.contact, RNE, the
constraint solve from data.contact.

`step_hot_b` runs one substep for a batch-leading Data on the hot path:
the tree sweeps (FK, frames, inertias, CRB, RNE) run on batch-minor
planes (c, n, B), as in the JAX package; collision, actuation, the
constraint solve and the integration then run batch-leading.  `step_n_b`
runs n substeps as a Python loop (the JAX package's lax.scan) and then
refreshes the derived quantities the caller asks for.

The per-environment functions (`forward`, `step`, `step_hot`, `step_n`,
`fwd_*`) take a Data with any leading batch shape, none for one
environment; they run on it flattened to one batch axis.
"""

from __future__ import annotations

import functools
import math

import torch

from dexterity_tpu_torch.core import types
from dexterity_tpu_torch.core.types import Data, Model
from dexterity_tpu_torch.physics import constraint as constraint_mod
from dexterity_tpu_torch.physics import kinematics, smooth
from dexterity_tpu_torch.physics.collision import narrowphase, primitives
from dexterity_tpu_torch.utils import profiling


def _one_batch_axis(fn):
  """fn(model, data, ...) on data flattened to one leading batch axis
  (an axis of 1 for a lone environment), the result restored to data's
  batch shape."""
  @functools.wraps(fn)
  def wrapped(model: Model, data: Data, *args, **kwargs) -> Data:
    bshape = data.qpos.shape[:-1]
    nb = len(bshape)
    if nb == 1:
      return fn(model, data, *args, **kwargs)
    flat = (math.prod(bshape),)
    out = fn(model, types.map_data(
        data, lambda x: x.reshape(flat + x.shape[nb:])), *args, **kwargs)
    return types.map_data(out, lambda x: x.reshape(bshape + x.shape[1:]))
  return wrapped


@_one_batch_axis
def fwd_position(model: Model, data: Data) -> Data:
  """Frames, dof axes and tendon lengths, the joint-space inertia, and the
  narrow phase into data.contact."""
  data = kinematics.fwd_position(model, data)
  data = smooth.crb(model, data)
  return narrowphase.collision(model, data)


@_one_batch_axis
def fwd_velocity(model: Model, data: Data) -> Data:
  """Body and tendon velocities, actuator and passive forces, the bias
  force."""
  data = kinematics.fwd_velocity_kinematics(model, data)
  data = smooth.actuation(model, data)
  data = smooth.passive(model, data)
  return smooth.rne(model, data)


@_one_batch_axis
def fwd_acceleration(model: Model, data: Data) -> Data:
  """The constraint solve on the smooth force (contacts from
  data.contact); qacc_smooth is not computed, as in the JAX package."""
  qfrc_smooth = (data.qfrc_passive + data.qfrc_actuator + data.qfrc_applied
                 + smooth.xfrc_accumulate(model, data) - data.qfrc_bias)
  return constraint_mod.solve(model, data, qfrc_smooth)


@_one_batch_axis
def forward(model: Model, data: Data) -> Data:
  data = fwd_position(model, data)
  data = fwd_velocity(model, data)
  return fwd_acceleration(model, data)


@_one_batch_axis
def step(model: Model, data: Data) -> Data:
  """forward, then semi-implicit Euler."""
  return smooth.euler(model, forward(model, data))


def _precompute_planes(model: Model, qpos, qvel, mocap_pos, mocap_quat):
  """Tree-sweep plane products for one substep (FK/frames/CRB/RNE).

  With qpos (nq,) all outputs are per-env planes; with qpos (nq, B)
  (qvel and mocap batch-minor the same way) every output gains a
  trailing B."""
  with profiling.trace_annotation('physics.planes'):
    dtype = qpos.dtype
    xpos_p, xquat_p, cdof6 = kinematics.body_poses_planes(
        model, qpos, mocap_pos, mocap_quat)
    gpos, gmat = kinematics.frame_planes(
        xpos_p, xquat_p, model.index('geom_bodyid', model.geom_bodyid),
        model.geom_pos, model.geom_quat, dtype)
    body10, xipos3 = smooth.inertia_origin_planes(model, xpos_p, xquat_p)
    qm = smooth.crb_planes(model, body10, cdof6)
    qfrc_bias, _ = smooth.rne_planes(model, body10, cdof6, qvel)
    if model.ntendon:
      dof_qposadr = model.index('dof_qposadr', kinematics._dof_qposadr(model))
      tm = model.tendon_moment.to(dtype)
      ten_length = torch.tensordot(tm, qpos[dof_qposadr], 1)
      ten_velocity = torch.tensordot(tm, qvel, 1)
    else:
      bshape = qpos.shape[1:]
      ten_length = qpos.new_zeros((0,) + bshape)
      ten_velocity = qpos.new_zeros((0,) + bshape)
  return dict(xpos_p=xpos_p, xquat_p=xquat_p, cdof6=cdof6,
              gpos=gpos, gmat=gmat, xipos3=xipos3, qm=qm,
              qfrc_bias=qfrc_bias, ten_length=ten_length,
              ten_velocity=ten_velocity)


def _major(p: torch.Tensor) -> torch.Tensor:
  """A batch-minor plane (..., B) as batch-leading (B, ...)."""
  return p.movedim(-1, 0)


def _batch_minor(x: torch.Tensor) -> torch.Tensor:
  return x.movedim(0, -1)


def _finish_step(model: Model, data: Data, pre: dict,
                 selinfo=None) -> Data:
  """Collision, actuation, constraint solve and integration for a Data
  with one leading batch axis, given the batch-minor planes of
  _precompute_planes."""
  dtype = data.qpos.dtype
  gpos = tuple(_major(p) for p in pre['gpos'])
  gmat = tuple(_major(p) for p in pre['gmat'])
  contact_groups = primitives.collide_group_planes(
      model, gpos, gmat, dtype, selinfo=selinfo)

  updates = dict(
      qM=_major(pre['qm']), cdof=_major(pre['cdof6']).transpose(-1, -2),
      ten_length=_major(pre['ten_length']),
      ten_velocity=_major(pre['ten_velocity']),
      qfrc_bias=_major(pre['qfrc_bias']))
  if model.neq:
    # CONNECT/WELD rows read batch-leading body poses.
    updates.update(xpos=_major(pre['xpos_p']).transpose(-1, -2),
                   xquat=_major(pre['xquat_p']).transpose(-1, -2))
  data = data.replace(**updates)
  with profiling.trace_annotation('physics.smooth'):
    data = smooth.actuation(model, data)
    data = smooth.passive(model, data)
    xfrc = smooth.xfrc_planes(model, pre['xipos3'], pre['cdof6'],
                              _batch_minor(data.xfrc_applied))
  qfrc_smooth = (data.qfrc_passive + data.qfrc_actuator + data.qfrc_applied
                 + _major(xfrc) - data.qfrc_bias)
  data = constraint_mod.solve(model, data, qfrc_smooth,
                              contact_groups=contact_groups)
  with profiling.trace_annotation('physics.integrate'):
    return smooth.euler_from_smooth(model, data, qfrc_smooth)


def _planes_b(model: Model, data: Data) -> dict:
  return _precompute_planes(
      model, _batch_minor(data.qpos), _batch_minor(data.qvel),
      _batch_minor(data.mocap_pos), _batch_minor(data.mocap_quat))


def step_hot_b(model: Model, data: Data, selinfo=None) -> Data:
  """One physics substep for a Data with one leading batch axis on every
  field.  Derived fields other than the integrator state and the
  dynamics outputs are left stale."""
  return _finish_step(model, data, _planes_b(model, data), selinfo=selinfo)


@_one_batch_axis
def step_hot(model: Model, data: Data) -> Data:
  """One physics substep through the plane-form pipeline (step_hot_b):
  `step`'s semantics up to float reassociation, with no AoS frames or
  contacts materialised; derived fields other than the integrator state
  and the dynamics outputs are left stale."""
  return step_hot_b(model, data)


# Integrator state plus the per-dof/per-actuator dynamics outputs a caller
# may read after the control step.
_STEP_CARRY = ('time', 'qpos', 'qvel', 'qacc', 'qacc_smooth', 'qfrc_bias',
               'qfrc_passive', 'qfrc_actuator', 'qfrc_constraint',
               'qfrc_constraint_axis', 'actuator_length',
               'actuator_velocity', 'actuator_force')

# Planner-rollout carry: rewards read qpos/qvel and the Newton warm start
# reads qacc; the other fields keep their pre-rollout values.
_STEP_CARRY_MIN = ('time', 'qpos', 'qvel', 'qacc')


@_one_batch_axis
def step_n(model: Model, data: Data, n: int, refresh: str = 'full') -> Data:
  """n physics substeps (one control step) with the full carry and a
  midphase selection every substep, then the refresh of step_n_b."""
  return step_n_b(model, data, n, refresh=refresh)


def step_n_b(model: Model, data: Data, n: int, refresh: str = 'full',
             midphase: str = 'per_substep', carry: str = 'full') -> Data:
  """n substeps of step_hot_b (one control step) for a Data with one
  leading batch axis.

  midphase='per_call' selects the midphase candidate slots once, from the
  first substep's geom frames (primitives.midphase_selinfo), and every
  substep of this call reuses the selection; 'per_substep' selects anew
  each substep.

  carry='minimal' carries only (time, qpos, qvel, qacc) from substep to
  substep; the other fields keep their values from before the call.
  carry='full' also carries the dynamics outputs.

  refresh, once after the substeps (MuJoCo's mj_step1 order), so that
  observables and rewards read quantities of the new qpos:
    'full'      frames (kinematics.fwd_position), the narrow phase into
                data.contact, body and tendon velocities;
    'position'  frames only;
    'none'      the integrator state as it is.
  qM is not refreshed.
  """
  if refresh not in ('none', 'position', 'full'):
    raise ValueError(f'refresh={refresh!r}')
  if midphase not in ('per_call', 'per_substep'):
    raise ValueError(f'midphase={midphase!r}')
  if carry not in ('minimal', 'full'):
    raise ValueError(f'carry={carry!r}')
  with profiling.trace_annotation('physics.step_n'):
    fields = _STEP_CARRY_MIN if carry == 'minimal' else _STEP_CARRY
    base = data

    def advance(d_new):
      return base.replace(**{f: getattr(d_new, f) for f in fields})

    selinfo = None
    cur = data
    start = 0
    if midphase == 'per_call' and model.npair and n:
      # The first substep's tree sweep doubles as the selection build.
      pre0 = _planes_b(model, data)
      gpos = tuple(_major(p) for p in pre0['gpos'])
      gmat = tuple(_major(p) for p in pre0['gmat'])
      selinfo = primitives.midphase_selinfo(model, gpos, gmat, data.qpos.dtype)
      if all(si is None for si in selinfo):
        selinfo = None
      else:
        cur = advance(_finish_step(model, data, pre0, selinfo=selinfo))
        start = 1
    for _ in range(start, n):
      cur = advance(step_hot_b(model, cur, selinfo=selinfo))
    if refresh == 'none':
      return cur
    with profiling.trace_annotation('physics.refresh'):
      cur = kinematics.fwd_position(model, cur)
      if refresh == 'position':
        return cur
      cur = narrowphase.collision(model, cur)
      return kinematics.fwd_velocity_kinematics(model, cur)
