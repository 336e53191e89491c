"""Soft-constraint assembly and convex Newton solver, batch-leading
(port of dexterity_tpu/physics/constraint.py).

Every function takes a batch-leading Data (B, ...); the JAX package runs
the same arithmetic per environment under vmap.  Row types (static layout,
inactive rows masked by zero weight):
  equality (JOINT / TENDON / CONNECT / WELD)  — bilateral
  dof frictionloss                            — Huber (force in [-fl, fl])
  joint limits (2 rows per limited joint)     — unilateral
  tendon limits (2 rows per limited tendon)   — unilateral
  contacts: top-K deepest candidate points, pyramidal cone
            (2*(condim-1) rows per point, or 1 when condim == 1)

Parametrization (MuJoCo's): impedance d(r) from the solimp spline,
aref = -B (J qvel) - K d(r) r with B = 2/(dmax tc), K = d/(dmax² tc² dr²),
R = (1-d)/d * invweight, D = 1/R.

Solver: Newton on qacc with the Hessian M + Jᵀ D_active J, solved through
the Cholesky kernels of linalg_cuda, and an exact line search over a fixed
set of step sizes.  With solver_refactor_every = k > 1 the Hessian is
factored every k-th iteration (K1, which also emits the packed factor) and
the iterations between re-solve against that stale factor (K2).  With
k = 1 every iteration factors and solves (K3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dexterity_tpu_torch.core import types as T
from dexterity_tpu_torch.core.types import Data, EqType, JointType, Model
from dexterity_tpu_torch.physics import kinematics, linalg_cuda
from dexterity_tpu_torch.physics import math as tmath
from dexterity_tpu_torch.physics.collision import primitives
from dexterity_tpu_torch.utils import profiling

# Row-type codes used for cost shaping.
_BILATERAL = 0
_FRICTIONLOSS = 1
_UNILATERAL = 2


def impedance(solimp: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
  """MuJoCo solimp spline d(r)."""
  d0, dmax, width, mid, power = solimp.unbind(-1)
  x = torch.clamp(torch.abs(r) / torch.clamp_min(width, 1e-12), 0.0, 1.0)
  mid = torch.clamp(mid, 1e-4, 1 - 1e-4)
  power = torch.clamp_min(power, 1.0)
  y_lo = (x / mid) ** power * mid
  y_hi = 1.0 - ((1.0 - x) / (1.0 - mid)) ** power * (1.0 - mid)
  y = torch.where(x < mid, y_lo, y_hi)
  return d0 + y * (dmax - d0)


def _kbi(solref, solimp, r, vel, timestep):
  """Returns (d, aref) for rows with violation r and velocity vel."""
  d = impedance(solimp, r)
  dmax = solimp[..., 1]
  tc, dr = solref[..., 0], solref[..., 1]
  tc = torch.clamp_min(tc, 2.0 * timestep)
  direct = solref[..., 0] <= 0
  b_std = 2.0 / torch.clamp_min(dmax * tc, 1e-12)
  k_std = d / torch.clamp_min(dmax * dmax * tc * tc * dr * dr, 1e-12)
  b = torch.where(direct, -solref[..., 1], b_std)
  k = torch.where(direct, -solref[..., 0] * d, k_std)
  aref = -b * vel - k * r
  return d, aref


# ---------------------------------------------------------------------------
# Row assembly
# ---------------------------------------------------------------------------


def _kbi_shared(solref, solimp, r_imp, r, vel, timestep):
  """Like _kbi, but the impedance's argument r_imp (a multi-row residual
  norm) differs from the per-row stiffness residual r: MuJoCo's
  convention for CONNECT/WELD equalities."""
  d = impedance(solimp, r_imp)
  dmax = solimp[..., 1]
  tc, dr = solref[..., 0], solref[..., 1]
  tc = torch.clamp_min(tc, 2.0 * timestep)
  direct = solref[..., 0] <= 0
  b_std = 2.0 / torch.clamp_min(dmax * tc, 1e-12)
  k_std = d / torch.clamp_min(dmax * dmax * tc * tc * dr * dr, 1e-12)
  b = torch.where(direct, -solref[..., 1], b_std)
  k = torch.where(direct, -solref[..., 0] * d, k_std)
  return d, -b * vel - k * r


def _cw_geom(model: Model, data: Data, ei: int, etype: EqType, dtype):
  """CONNECT/WELD rows of equality ei: (J (..., k, nv), res (..., k)), k =
  3 (connect) or 6 (weld).

  eq_data layout (MuJoCo's):
    CONNECT: [0:3] the anchor in body1's frame, [3:6] the same point in
      body2's frame (resolved at compile).
    WELD: [0:3] the anchor in body2's frame, [3:6] body1's point (relpose
      position), [6:10] relpose quaternion, [10] torquescale."""
  data_e = model.eq_data[ei].to(dtype)
  b1, b2 = model.eq_obj1[ei], model.eq_obj2[ei]
  q1 = data.xquat[..., b1, :]
  q2 = data.xquat[..., b2, :]
  if etype == EqType.CONNECT:
    a1, a2 = data_e[0:3], data_e[3:6]
  else:
    a1, a2 = data_e[3:6], data_e[0:3]
  p1 = data.xpos[..., b1, :] + tmath.quat_rotate(q1, a1.expand(q1.shape[:-1]
                                                              + (3,)))
  p2 = data.xpos[..., b2, :] + tmath.quat_rotate(q2, a2.expand(q2.shape[:-1]
                                                              + (3,)))
  jac1p, jac1r = kinematics.jac_point(model, data, b1, p1)
  jac2p, jac2r = kinematics.jac_point(model, data, b2, p2)
  res_p = p1 - p2
  jrows = jac1p - jac2p                                   # (..., 3, nv)
  if etype == EqType.CONNECT:
    return jrows, res_p
  # Rotation residual: torquescale * vec(q2^-1 q1 qrel); its velocity
  # Jacobian is ts * 0.5 (e_w I - [e_vec]x) R2^T (jacr1 - jacr2).
  ts = torch.where(data_e[10] > 0, data_e[10], torch.ones_like(data_e[10]))
  qrel = data_e[6:10]
  qrel = qrel / torch.clamp_min(torch.linalg.norm(qrel), 1e-15)
  e_q = tmath.quat_mul(tmath.quat_mul(tmath.quat_inv(q2), q1),
                       qrel.expand(q1.shape))
  res_r = ts * e_q[..., 1:]
  e_w, e_v = e_q[..., 0], e_q[..., 1:]
  zero = torch.zeros_like(e_w)
  skew = torch.stack([
      torch.stack([zero, -e_v[..., 2], e_v[..., 1]], -1),
      torch.stack([e_v[..., 2], zero, -e_v[..., 0]], -1),
      torch.stack([-e_v[..., 1], e_v[..., 0], zero], -1)], -2)
  eye = torch.eye(3, dtype=dtype, device=e_q.device)
  r2t = tmath.quat_to_mat(q2).transpose(-1, -2)
  gmat = 0.5 * (e_w[..., None, None] * eye - skew) @ r2t
  jrot = ts * (gmat @ (jac1r - jac2r))                    # (..., 3, nv)
  return torch.cat([jrows, jrot], -2), torch.cat([res_p, res_r], -1)


def _qpos_tangent(model: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  dtype) -> torch.Tensor:
  """d(qpos)/dt given qvel, over leading axes: the tangent map of
  mj_integratePos at dt -> 0 (quaternion joints: q' = q (0, w_local)/2)."""
  out = torch.zeros_like(qpos)
  types = np.asarray(model.jnt_type)
  scalar = np.where((types == int(JointType.HINGE))
                    | (types == int(JointType.SLIDE)))[0]
  if len(scalar):
    qadr = model.index('tangent_scalar_qadr',
                       [model.jnt_qposadr[j] for j in scalar])
    dadr = model.index('tangent_scalar_dadr',
                       [model.jnt_dofadr[j] for j in scalar])
    out[..., qadr] = qvel[..., dadr]

  def qdot(q, omega):
    return 0.5 * tmath.quat_mul(q, torch.cat(
        [torch.zeros_like(omega[..., :1]), omega], -1))

  for ji in np.where(types == int(JointType.BALL))[0]:
    qadr, dadr = model.jnt_qposadr[ji], model.jnt_dofadr[ji]
    out[..., qadr:qadr + 4] = qdot(qpos[..., qadr:qadr + 4],
                                   qvel[..., dadr:dadr + 3])
  for ji in np.where(types == int(JointType.FREE))[0]:
    qadr, dadr = model.jnt_qposadr[ji], model.jnt_dofadr[ji]
    out[..., qadr:qadr + 3] = qvel[..., dadr:dadr + 3]
    out[..., qadr + 3:qadr + 7] = qdot(qpos[..., qadr + 3:qadr + 7],
                                       qvel[..., dadr + 3:dadr + 6])
  return out


def _cw_jdot_qvel(model: Model, data: Data, cw: list, dtype) -> torch.Tensor:
  """J̇q̇ of every CONNECT/WELD row (concatenated in eq order), (..., n):
  the directional derivative of the rows' velocities J(qpos) qvel along
  qpos's time derivative, by forward-mode AD through the frames
  (torch.func.jvp; the JAX package uses jax.jvp).  MuJoCo's equality
  aref subtracts it, so that the row's true residual acceleration
  J q̈ + J̇q̇ is what tracks -b vel - k res."""
  qvel = data.qvel

  def rowvels(qpos):
    d2 = kinematics.fwd_position(model, data.replace(qpos=qpos))
    return torch.cat([torch.einsum('...kv,...v->...k',
                                   _cw_geom(model, d2, ei, etype, dtype)[0],
                                   qvel)
                      for ei, etype in cw], -1)

  qdot = _qpos_tangent(model, data.qpos, qvel, dtype)
  return torch.func.jvp(rowvels, (data.qpos,), (qdot,))[1]


def _eq_tables(model: Model):
  """Static per-type equality tables and the row order (numpy)."""
  def build():
    types = [EqType(t) for t in model.eq_type]
    joint = [ei for ei, t in enumerate(types) if t == EqType.JOINT]
    tendon = [ei for ei, t in enumerate(types) if t == EqType.TENDON]
    cw = [(ei, t) for ei, t in enumerate(types)
          if t in (EqType.CONNECT, EqType.WELD)]
    for t in types:
      if t not in (EqType.JOINT, EqType.TENDON, EqType.CONNECT, EqType.WELD):
        raise NotImplementedError(t)
    # Rows come out grouped (JOINT, TENDON, CONNECT/WELD); `order` puts
    # them back in eq order, as the JAX package appends them.
    start, group_row = 0, {}
    for ei in joint + tendon:
      group_row[ei] = [start]
      start += 1
    for ei, t in cw:
      k = 3 if t == EqType.CONNECT else 6
      group_row[ei] = list(range(start, start + k))
      start += k
    order = np.asarray([r for ei in range(len(types))
                        for r in group_row[ei]], np.int64)
    trans = np.asarray([types[ei] in (EqType.JOINT, EqType.TENDON)
                        for ei in range(len(types))
                        for _ in group_row[ei]], bool)
    return dict(joint=joint, tendon=tendon, cw=cw, order=order, trans=trans)
  return model.cached('eq_tables', build)


def _poly(coef, x):
  """MuJoCo's quartic coupling: (poly(x), poly'(x)) for coef (n, 5)."""
  powers = torch.stack([x ** k for k in range(5)], -1)
  dpowers = torch.stack([(k + 1) * x ** k for k in range(4)], -1)
  return ((coef * powers).sum(-1), (coef[:, 1:5] * dpowers).sum(-1))


def _eq_rows(model: Model, data: Data, dtype):
  """Equality rows, in eq order: (J (..., n, nv), aref (..., n),
  d (..., n), invweight (n,), transmitted (n,) static bool: True for the
  dof-space JOINT/TENDON rows, False for CONNECT/WELD wrenches)."""
  tabs = _eq_tables(model)
  h = model.opt.timestep
  nv = model.nv
  bshape = data.qpos.shape[:-1]
  js, refs, ds, iws = [], [], [], []

  def const(key, build):
    return model.const(('eq', key), build, dtype)

  if tabs['joint']:
    ids = tabs['joint']
    j1 = [model.eq_obj1[e] for e in ids]
    j2 = [model.eq_obj2[e] for e in ids]
    has2_np = np.asarray([j >= 0 for j in j2])
    a1 = model.index('eq_joint_a1', [model.jnt_qposadr[j] for j in j1])
    d1_np = np.asarray([model.jnt_dofadr[j] for j in j1])
    a2 = model.index('eq_joint_a2', [model.jnt_qposadr[max(j, 0)]
                                     for j in j2])
    d2_np = np.asarray([model.jnt_dofadr[max(j, 0)] for j in j2])
    d1 = model.index('eq_joint_d1', d1_np)
    d2 = model.index('eq_joint_d2', d2_np)
    has2 = const('joint_has2', lambda: has2_np.astype(float))
    eid = model.index('eq_joint_ids', ids)
    coef = model.eq_data[eid, :5].to(dtype)
    qpos0 = model.qpos0.to(dtype)
    q1 = data.qpos[..., a1] - qpos0[a1]
    q2 = (data.qpos[..., a2] - qpos0[a2]) * has2
    poly, dpoly = _poly(coef, q2)
    dpoly2 = dpoly * has2
    e1 = const('joint_e1', lambda: np.eye(nv)[d1_np])
    e2 = const('joint_e2', lambda: np.eye(nv)[d2_np] * has2_np[:, None])
    js.append(e1 - dpoly2[..., None] * e2)
    vel = data.qvel[..., d1] - dpoly2 * data.qvel[..., d2]
    dd, aref = _kbi(model.eq_solref[eid].to(dtype),
                    model.eq_solimp[eid].to(dtype), q1 - poly, vel, h)
    refs.append(aref)
    ds.append(dd)
    iws.append(model.dof_invweight0[d1].to(dtype)
               + model.dof_invweight0[d2].to(dtype) * has2)

  if tabs['tendon']:
    ids = tabs['tendon']
    t1 = model.index('eq_tendon_t1', [model.eq_obj1[e] for e in ids])
    t2_np = np.asarray([model.eq_obj2[e] for e in ids])
    t2 = model.index('eq_tendon_t2', np.maximum(t2_np, 0))
    has2 = const('tendon_has2', lambda: (t2_np >= 0).astype(float))
    eid = model.index('eq_tendon_ids', ids)
    data_e = model.eq_data[eid].to(dtype)
    tm = model.tendon_moment.to(dtype)
    # The tendon lengths at qpos0, the couplings' zero.
    ref0 = model.cached(('eq_tendon_ref0', dtype), lambda: tm @ (
        model.qpos0.to(dtype)[model.index(
            'dof_qposadr', kinematics._dof_qposadr(model))]))
    l1 = data.ten_length[..., t1] - ref0[t1]
    l2 = (data.ten_length[..., t2] - ref0[t2]) * has2
    poly, dpoly = _poly(data_e[:, :5], l2)
    dpoly2 = dpoly * has2
    res = torch.where(has2 > 0, l1 - poly, l1 - data_e[:, 0])
    js.append(tm[t1] - dpoly2[..., None] * tm[t2])
    vel = data.ten_velocity[..., t1] - dpoly2 * data.ten_velocity[..., t2]
    dd, aref = _kbi(model.eq_solref[eid].to(dtype),
                    model.eq_solimp[eid].to(dtype), res, vel, h)
    refs.append(aref)
    ds.append(dd)
    iws.append(model.tendon_invweight0[t1].to(dtype)
               + model.tendon_invweight0[t2].to(dtype) * has2)

  if tabs['cw']:
    jdq_all = _cw_jdot_qvel(model, data, tabs['cw'], dtype)
    off = 0
    for ei, etype in tabs['cw']:
      k = 3 if etype == EqType.CONNECT else 6
      b1, b2 = model.eq_obj1[ei], model.eq_obj2[ei]
      jrows, res = _cw_geom(model, data, ei, etype, dtype)
      vel = torch.einsum('...kv,...v->...k', jrows, data.qvel)
      # The impedance comes once per equality, from the norm of its whole
      # residual; the aref subtracts the J̇q̇ bias.
      r_norm = torch.linalg.norm(res, dim=-1, keepdim=True)
      dd, aref = _kbi_shared(model.eq_solref[ei].to(dtype),
                             model.eq_solimp[ei].to(dtype), r_norm, res,
                             vel, h)
      js.append(jrows)
      refs.append(aref - jdq_all[..., off:off + k])
      ds.append(dd.expand(res.shape))
      iw = model.body_invweight0.to(dtype)
      iws.append(torch.cat([(iw[b1, 0] + iw[b2, 0]).expand(3),
                            (iw[b1, 1] + iw[b2, 1]).expand(k - 3)]))
      off += k

  order = model.index('eq_order', tabs['order'])
  J = torch.cat([j.expand(bshape + j.shape[-2:]) for j in js], -2)
  return (J[..., order, :], torch.cat(refs, -1)[..., order],
          torch.cat(ds, -1)[..., order], torch.cat(iws)[order],
          tabs['trans'])


def _eq_rows_blocks(model: Model, data: Data, dtype):
  if not model.neq:
    z = data.qpos.new_zeros(data.qpos.shape[:-1] + (0,))
    return (data.qpos.new_zeros(data.qpos.shape[:-1] + (0, model.nv)), z, z,
            data.qpos.new_zeros((0,)), np.zeros(0, bool))
  return _eq_rows(model, data, dtype)


def _fl_rows(model: Model, data: Data, dtype):
  """Dof frictionloss rows (static row set: dofs with fl > 0).

  Returns diag-row parts (dof idx, aref, d, invweight, fl): J = e_dof."""
  h = model.opt.timestep
  idx_np = model.cached('fl_dofs_np', lambda: np.where(
      model.dof_frictionloss.detach().cpu().numpy() > 0)[0])
  n = len(idx_np)
  bshape = data.qvel.shape[:-1]
  if n == 0:
    z = data.qvel.new_zeros(bshape + (0,))
    return idx_np, z, z, z, z
  idx = model.index('fl_dofs', idx_np)
  solref = model.const('fl_solref', lambda: [0.02, 1.0], dtype)
  solimp = model.const('fl_solimp', lambda: [0.9, 0.95, 0.001, 0.5, 2.0],
                       dtype)
  vel = data.qvel[..., idx]
  dd, aref = _kbi(solref, solimp, torch.zeros_like(vel), vel, h)
  dd = dd.expand(vel.shape)
  return (idx_np, aref, dd, model.dof_invweight0[idx],
          model.dof_frictionloss[idx].expand(vel.shape))


def _jnt_limit_rows(model: Model, data: Data, dtype):
  """Scalar-joint limit rows as diag rows: J = sign * e_dof.

  Returns (dof idx, sign, aref, d, invweight) with both sides stacked
  (side 0 rows then side 1 rows — reference efc ordering)."""
  h = model.opt.timestep
  jids = [ji for ji in range(model.njnt)
          if model.jnt_limited[ji]
          and JointType(model.jnt_type[ji]) in (JointType.HINGE,
                                                JointType.SLIDE)]
  bshape = data.qvel.shape[:-1]
  if not jids:
    z = data.qvel.new_zeros(bshape + (0,))
    return (np.zeros(0, np.int64), np.zeros(0), z, z, z)
  qadr_np = np.asarray([model.jnt_qposadr[j] for j in jids])
  dadr_np = np.asarray([model.jnt_dofadr[j] for j in jids])
  jid = model.index('limit_jids', jids)
  qadr = model.index('limit_qadr', qadr_np)
  dadr = model.index('limit_dadr', dadr_np)
  arefs, dds = [], []
  for side, sign in ((0, 1.0), (1, -1.0)):
    dist = sign * (data.qpos[..., qadr] - model.jnt_range[jid, side])
    margin = model.jnt_margin[jid]
    active = dist < margin
    r = torch.where(active, dist - margin, torch.zeros_like(dist))
    dd, aref = _kbi(model.jnt_solref[jid], model.jnt_solimp[jid], r,
                    sign * data.qvel[..., dadr], h)
    arefs.append(aref)
    dds.append(torch.where(active, dd, torch.zeros_like(dd)))
  n = len(jids)
  return (np.concatenate([dadr_np, dadr_np]),
          np.concatenate([np.ones(n), -np.ones(n)]),
          torch.cat(arefs, -1), torch.cat(dds, -1),
          torch.cat([model.dof_invweight0[dadr]] * 2))


def _ten_limit_rows(model: Model, data: Data, dtype):
  """Tendon limit rows (jacobian sign * tendon_moment)."""
  h = model.opt.timestep
  tids = [ti for ti in range(model.ntendon) if model.tendon_limited[ti]]
  bshape = data.qvel.shape[:-1]
  if not tids:
    z = data.qvel.new_zeros(bshape + (0,))
    return np.zeros((0, model.nv)), z, z, z
  tid = model.index('limit_tids', tids)
  tm = model.cached('limit_tendon_moment', lambda: model.tendon_moment.detach(
  ).cpu().numpy()[np.asarray(tids)])
  arefs, dds, iws = [], [], []
  for side, sign in ((0, 1.0), (1, -1.0)):
    dist = sign * (data.ten_length[..., tid] - model.tendon_range[tid, side])
    margin = model.tendon_margin[tid]
    active = dist < margin
    r = torch.where(active, dist - margin, torch.zeros_like(dist))
    dd, aref = _kbi(model.tendon_solref[tid], model.tendon_solimp[tid], r,
                    sign * data.ten_velocity[..., tid], h)
    arefs.append(aref)
    dds.append(torch.where(active, dd, torch.zeros_like(dd)))
    iws.append(model.tendon_invweight0[tid])
  return (np.concatenate([tm, -tm]), torch.cat(arefs, -1),
          torch.cat(dds, -1), torch.cat(iws))


def _contact_tables(model: Model, dtype):
  def build():
    table = primitives._pair_param_planes(model, np.arange(model.npair))
    return dict(
        par_t=torch.as_tensor(table.T, dtype=dtype, device=model.device),
        mask=torch.as_tensor(kinematics.ancestor_mask(model), dtype=dtype,
                             device=model.device))
  return model.cached(('contact_tables', dtype), build)


def _bcast_k(x):
  """(B, k) -> (B, 1, 1, k) for the (B, ndim, 2, k) pyramid-row layout."""
  return x[..., None, None, :]


def _contact_parts(model: Model, data: Data, dtype, groups=None):
  """Top-K contact rows with a pyramidal friction cone.

  The candidate points come from the narrow phase's group list
  (collide_group_planes, the hot substep) or, with groups=None, from
  data.contact (the refresh path, after narrowphase.collision).

  Returns ('dense', jn, aref, d, invweight) when every pair has condim 1,
  else ('pyr', R, mu, aref, d, invweight) with R = [jn; jf_1..jf_ndim]
  (B, 1+ndim, k, nv) — the factored pyramid (see ContactBlock)."""
  if model.npair == 0 or (groups is not None and not groups):
    return None
  h = model.opt.timestep
  max_condim = max(model.pair_condim)

  if groups is None:
    c = data.contact
    score = c.dist - c.margin
    payload = torch.cat([c.pos, c.frame], -2)             # (B, 12, npoint)
    pair = torch.clamp_min(c.pair, 0)
  else:
    score = torch.cat([g['dist'] - g['margin'] for g in groups], -1)
    payload = torch.cat([torch.stack(list(g['pos']) + list(g['frame']),
                                     dim=-2) for g in groups], -1)
    pair = torch.cat([g['pair'] for g in groups], -1)
  npoint = score.shape[-1]
  k_sel = min(model.opt.contact_top_k, npoint)
  # Exact top-K deepest, first index first among ties.
  sel = torch.sort(score, dim=-1, stable=True).indices[..., :k_sel]
  score_sel = torch.gather(score, -1, sel)
  active = score_sel < 0
  # Counters of the traced run: the narrow phase's slots, and those the
  # solve keeps as active contacts (counted only when the records are read).
  profiling.count('slots', score.numel())
  profiling.count('live', active, torch.count_nonzero)
  r = torch.clamp_max(score_sel, 0.0)

  selp = primitives.onehot_select(sel, payload)           # (B, 12, k)
  pid = torch.gather(pair, -1, sel)
  pos = selp[..., 0:3, :]
  nrm = selp[..., 3:6, :]
  t1d = selp[..., 6:9, :]
  t2d = selp[..., 9:12, :]

  tabs = _contact_tables(model, dtype)
  par = tabs['par_t'][pid].transpose(-1, -2)              # (B, NPARAM, k)
  solref = par[..., T.PARAM_SOLREF, :].transpose(-1, -2)  # (B, k, 2)
  solimp = par[..., T.PARAM_SOLIMP, :].transpose(-1, -2)  # (B, k, 5)
  mu3 = par[..., T.PARAM_FRICTION, :]                     # (B, 3, k)
  condim = par[..., T.PARAM_CONDIM, :]
  b1 = torch.round(par[..., T.PARAM_BODY1, :]).to(torch.int64)
  b2 = torch.round(par[..., T.PARAM_BODY2, :]).to(torch.int64)
  iw_t = par[..., T.PARAM_IW, :]

  mask = tabs['mask']
  maskdiff = mask[b2] - mask[b1]                          # (B, k, nv)

  ang = data.cdof[..., :3]                                # (B, nv, 3)
  lin = data.cdof[..., 3:]

  def cross_planes(u, v):
    return torch.stack([u[..., 1, :] * v[..., 2, :] - u[..., 2, :] * v[..., 1, :],
                        u[..., 2, :] * v[..., 0, :] - u[..., 0, :] * v[..., 2, :],
                        u[..., 0, :] * v[..., 1, :] - u[..., 1, :] * v[..., 0, :]],
                       dim=-2)

  def jac_t(d3):
    # J[k, v] = maskdiff * (d . lin_v + (pos x d) . ang_v).
    return maskdiff * (torch.einsum('...ck,...vc->...kv', d3, lin)
                       + torch.einsum('...ck,...vc->...kv',
                                      cross_planes(pos, d3), ang))

  def jac_r(d3):
    return maskdiff * torch.einsum('...ck,...vc->...kv', d3, ang)

  jn = jac_t(nrm)
  qvel = data.qvel

  if max_condim == 1:
    dd, aref = _kbi(solref, solimp, r,
                    torch.einsum('...kv,...v->...k', jn, qvel), h)
    dd = torch.where(active, dd, torch.zeros_like(dd))
    return ('dense', jn, aref, dd, iw_t)

  ndim_rows = max_condim - 1
  dirs = [jac_t(t1d), jac_t(t2d)]
  mus = [mu3[..., 0, :], mu3[..., 0, :]]
  if ndim_rows > 2:
    dirs += [jac_r(nrm), jac_r(t1d), jac_r(t2d)][:ndim_rows - 2]
    mus += [mu3[..., 1, :], mu3[..., 2, :], mu3[..., 2, :]][:ndim_rows - 2]
  rmat = torch.stack([jn] + dirs[:ndim_rows], dim=-3)     # (B, 1+ndim, k, nv)
  mu = torch.stack(mus[:ndim_rows], dim=-2)               # (B, ndim, k)

  # One regularizer per contact, from the slide friction coefficient.
  mu0 = mu3[..., 0, :]
  iw_pyr = iw_t * 2.0 * mu0 * mu0 * (1.0 + mu0 * mu0)

  rv = torch.einsum('...jkv,...v->...jk', rmat, qvel)     # (B, 1+ndim, k)
  jnv = rv[..., 0, :]
  jfv = rv[..., 1:, :]
  dims = torch.arange(ndim_rows, device=condim.device, dtype=condim.dtype)
  dim_ok = condim[..., None, :] > (1 + dims)[:, None]     # (B, ndim, k)
  # All 2*ndim pyramid rows in one evaluation: vel rows (B, ndim, 2, k),
  # j-major, + before -.
  signs = model.const('pyramid_signs', lambda: [1.0, -1.0], dtype)
  vel_rows = (jnv[..., None, None, :]
              + signs[:, None] * (mu * jfv)[..., :, None, :])
  dd, aref = _kbi(solref[..., None, None, :, :], solimp[..., None, None, :, :],
                  _bcast_k(r), vel_rows, h)
  on = _bcast_k(active) & dim_ok[..., :, None, :]
  dd = torch.where(on, dd.expand(vel_rows.shape), torch.zeros_like(vel_rows))
  bshape = vel_rows.shape[:-3]
  return ('pyr', rmat, mu, aref.reshape(bshape + (-1,)),
          dd.reshape(bshape + (-1,)), torch.cat([iw_pyr] * (2 * ndim_rows),
                                                -1))


class DenseBlock(NamedTuple):
  """Constraint rows with a dense (B, n, nv) jacobian."""
  J: torch.Tensor
  aref: torch.Tensor
  big_d: torch.Tensor  # (B, n) impedance weight D = d / ((1-d) iw)
  kind: int            # static row-type code (uniform within a block)
  fl: Optional[torch.Tensor]
  trans: Optional[np.ndarray]  # static per-row transmitted mask


class ContactBlock(NamedTuple):
  """Pyramidal contact rows in factored form: row(j, s) = jn + s mu_j jf_j.

  With D = diag weights per row, s_j = w_{j+} + w_{j-},
  c_j = mu_j (w_{j+} - w_{j-}), q_j = mu_j² s_j:
    J v   : rv = R v, rows(j, s) = rv_0 ± mu_j rv_j
    Jᵀ f  : Rᵀ coef with coef_0 = Σ f, coef_j = mu_j (f_{j+} - f_{j-})
    JᵀDJ  : Rᵀ P, P_0 = (Σ_j s_j) jn + Σ_j c_j jf_j, P_j = c_j jn + q_j jf_j
  Row order: (j, sign) groups, + before -, slot-major within a group."""
  r: torch.Tensor      # (B, 1+ndim, k, nv) stacked [jn; jf_1..jf_ndim]
  mu: torch.Tensor     # (B, ndim, k)
  aref: torch.Tensor   # (B, 2*ndim*k)
  big_d: torch.Tensor  # (B, 2*ndim*k)
  kind: int            # always _UNILATERAL


class StaticBlock(NamedTuple):
  """Rows whose jacobian is a model constant, merged across types
  (frictionloss, scalar joint limits, tendon limits — reference efc
  order).  The mixed row kinds are a static mask."""
  J: torch.Tensor      # (n, nv) constant jacobian
  jt: torch.Tensor     # (nv, n)
  jj: torch.Tensor     # (n, nv*nv) constant J[r,i]*J[r,j] (Hessian operand)
  aref: torch.Tensor   # (B, n)
  big_d: torch.Tensor  # (B, n)
  fl: torch.Tensor     # (B, n) frictionloss bound (0 on non-FL rows)
  m_fl: torch.Tensor   # (n,) static bool: True on frictionloss rows


def _bigd(d, invweight, dtype):
  d_clamped = torch.clamp(d, 0.0, 1.0 - 1e-6)
  big = d_clamped / torch.clamp_min((1.0 - d_clamped) * invweight, 1e-12)
  return torch.where(d > 0, big, torch.zeros_like(big)).to(dtype)


def _static_block(model: Model, parts, dtype):
  """parts: list of (J_const (n_i, nv) np, aref, big_d, fl or None)."""
  nv = model.nv
  js = np.concatenate([p[0] for p in parts])
  n = js.shape[0]

  def build():
    dev = model.device
    m_fl = np.concatenate([np.full(p[0].shape[0], p[3] is not None)
                           for p in parts])
    jj = np.einsum('ri,rj->rij', js, js).reshape(n, nv * nv)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return (f(js), f(js.T.copy()), f(jj),
            torch.as_tensor(m_fl, device=dev))
  j_t, jt_t, jj_t, m_fl_t = model.cached(('static_block', dtype), build)
  aref = torch.cat([p[1] for p in parts], -1)
  big_d = torch.cat([p[2] for p in parts], -1)
  fl = torch.cat([p[3] if p[3] is not None else torch.zeros_like(p[1])
                  for p in parts], -1)
  return StaticBlock(j_t, jt_t, jj_t, aref, big_d, fl, m_fl_t)


def assemble_blocks(model: Model, data: Data, contact_groups=None):
  """Block-structured constraint assembly (the solver's form).

  Reference efc ordering preserved across blocks: equalities,
  frictionloss, joint limits, tendon limits, contacts (from
  `contact_groups`, or from data.contact when None)."""
  dtype = data.qpos.dtype
  blocks = []
  if model.neq:
    ej, er, ed, ei, etrans = _eq_rows(model, data, dtype)
    blocks.append(DenseBlock(ej, er, _bigd(ed, ei, dtype), _BILATERAL,
                             None, etrans))
  static_parts = []
  fdof, fr, fd, fi, ffl = _fl_rows(model, data, dtype)
  if len(fdof):
    jfl = np.zeros((len(fdof), model.nv))
    jfl[np.arange(len(fdof)), fdof] = 1.0
    static_parts.append((jfl, fr, _bigd(fd, fi, dtype), ffl))
  ldof, lsign, lr, ld, li = _jnt_limit_rows(model, data, dtype)
  if len(ldof):
    jl = np.zeros((len(ldof), model.nv))
    jl[np.arange(len(ldof)), ldof] = lsign
    static_parts.append((jl, lr, _bigd(ld, li, dtype), None))
  tj, tr, td, ti = _ten_limit_rows(model, data, dtype)
  if tj.shape[0]:
    static_parts.append((tj, tr, _bigd(td, ti, dtype), None))
  if static_parts:
    blocks.append(_static_block(model, static_parts, dtype))
  cb = _contact_block(model, data, dtype, groups=contact_groups)
  if cb is not None:
    blocks.append(cb)
  return blocks


class Rows(NamedTuple):
  """Dense concatenated constraint rows (assemble)."""
  J: torch.Tensor          # (B, nrow, nv)
  aref: torch.Tensor       # (B, nrow)
  d: torch.Tensor          # (B, nrow) impedance (0 for disabled rows)
  invweight: torch.Tensor  # (B, nrow)
  fl: torch.Tensor         # (B, nrow) frictionloss bound (FL rows only)
  kind: np.ndarray         # (nrow,) static row-type codes
  # Static: True for rows whose force goes through the joints (limits,
  # frictionloss, JOINT/TENDON equalities); False for contacts and
  # CONNECT/WELD wrenches.
  transmitted: np.ndarray  # (nrow,) bool


def _contact_rows(model: Model, data: Data, dtype, groups=None):
  """Dense contact rows (J, aref, d, invweight): the pyramid's rows
  jn ± mu_j jf_j written out, (j, sign) groups, + before -."""
  parts = _contact_parts(model, data, dtype, groups=groups)
  if parts is None:
    bshape = data.qpos.shape[:-1]
    z = data.qpos.new_zeros(bshape + (0,))
    return data.qpos.new_zeros(bshape + (0, model.nv)), z, z, z
  if parts[0] == 'dense':
    return parts[1:]
  _, rmat, mu, aref, dd, iw = parts
  jn, jf = rmat[..., 0, :, :], rmat[..., 1:, :, :]
  rows = torch.cat([jn + sign * mu[..., j, :, None] * jf[..., j, :, :]
                    for j in range(jf.shape[-3]) for sign in (1.0, -1.0)],
                   -2)
  return rows, aref, dd, iw


def _contact_block(model: Model, data: Data, dtype, groups=None):
  """Contact rows as a solver block (the factored pyramid when
  condim > 1), or None without contact rows."""
  parts = _contact_parts(model, data, dtype, groups=groups)
  if parts is None:
    return None
  if parts[0] == 'dense':
    _, jn, aref, dd, iw = parts
    return DenseBlock(jn, aref, _bigd(dd, iw, dtype), _UNILATERAL, None,
                      np.zeros(jn.shape[-2], bool))
  _, rmat, mu, aref, dd, iw = parts
  return ContactBlock(rmat, mu, aref, _bigd(dd, iw, dtype), _UNILATERAL)


def assemble(model: Model, data: Data) -> Rows:
  """Dense concatenated rows in MuJoCo's efc order (equalities,
  frictionloss, joint limits, tendon limits, contacts from data.contact);
  the solver uses assemble_blocks."""
  dtype = data.qpos.dtype
  bshape = data.qpos.shape[:-1]
  nv = model.nv

  def const_rows(j):
    return torch.as_tensor(j, dtype=dtype, device=data.qpos.device).expand(
        bshape + j.shape)

  ej, er, ed, ei, etrans = _eq_rows_blocks(model, data, dtype)
  fdof, fr, fd, fi, ffl = _fl_rows(model, data, dtype)
  fj = np.zeros((len(fdof), nv))
  fj[np.arange(len(fdof)), fdof] = 1.0
  ldof, lsign, lr, ld, li = _jnt_limit_rows(model, data, dtype)
  lj = np.zeros((len(ldof), nv))
  lj[np.arange(len(ldof)), ldof] = lsign
  tj, tr, td, ti = _ten_limit_rows(model, data, dtype)
  cj, cr, cd, ci = _contact_rows(model, data, dtype)

  n_e, n_f, n_l = ej.shape[-2], len(fdof), len(ldof)
  n_t, n_c = tj.shape[0], cj.shape[-2]
  kind = np.concatenate([
      np.full(n_e, _BILATERAL, np.int32),
      np.full(n_f, _FRICTIONLOSS, np.int32),
      np.full(n_l + n_t + n_c, _UNILATERAL, np.int32)])
  transmitted = np.concatenate([etrans, np.ones(n_f + n_l + n_t, bool),
                                np.zeros(n_c, bool)])

  def rowvec(x):
    return x.expand(bshape + x.shape[-1:])

  zeros = data.qpos.new_zeros(bshape + (n_l + n_t + n_c,))
  return Rows(
      J=torch.cat([ej, const_rows(fj), const_rows(lj), const_rows(tj), cj],
                  -2),
      aref=torch.cat([er, fr, lr, tr, cr], -1),
      d=torch.cat([ed, fd, ld, td, cd], -1),
      invweight=torch.cat([rowvec(ei), rowvec(fi), rowvec(li), rowvec(ti),
                           ci], -1),
      fl=torch.cat([data.qpos.new_zeros(bshape + (n_e,)), ffl, zeros], -1),
      kind=kind, transmitted=transmitted)


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


def _blk_matvec(blk, v):
  """J_blk @ v for (B, nv) v -> (B, n)."""
  if isinstance(blk, StaticBlock):
    return v @ blk.jt
  if isinstance(blk, ContactBlock):
    rv = torch.einsum('...jkv,...v->...jk', blk.r, v)     # (B, 1+ndim, k)
    jnv, jfv = rv[..., 0:1, :], blk.mu * rv[..., 1:, :]
    rows = torch.stack([jnv + jfv, jnv - jfv], dim=-2)    # (B, ndim, 2, k)
    return rows.flatten(-3)
  return torch.einsum('...nv,...v->...n', blk.J, v)


def _blk_rmatvec(blk, f):
  """J_blkᵀ @ f -> (B, nv)."""
  if isinstance(blk, StaticBlock):
    return f @ blk.J
  if isinstance(blk, ContactBlock):
    ndim, k = blk.mu.shape[-2:]
    fr = f.unflatten(-1, (ndim, 2, k))
    fn = fr.sum((-3, -2))                                 # (B, k) on jn
    fd = blk.mu * (fr[..., 0, :] - fr[..., 1, :])         # (B, ndim, k)
    coef = torch.cat([fn.unsqueeze(-2), fd], dim=-2)      # (B, 1+ndim, k)
    return torch.einsum('...jkv,...jk->...v', blk.r, coef)
  return torch.einsum('...nv,...n->...v', blk.J, f)


def _blk_hess(blk, w, nv):
  """J_blkᵀ diag(w) J_blk -> (B, nv, nv)."""
  if isinstance(blk, StaticBlock):
    return (w @ blk.jj).unflatten(-1, (nv, nv))
  if isinstance(blk, ContactBlock):
    ndim, k = blk.mu.shape[-2:]
    wr = w.unflatten(-1, (ndim, 2, k))
    s = wr[..., 0, :] + wr[..., 1, :]                     # (B, ndim, k)
    c = blk.mu * (wr[..., 0, :] - wr[..., 1, :])
    q = blk.mu * blk.mu * s
    jn, jf = blk.r[..., 0:1, :, :], blk.r[..., 1:, :, :]
    p0 = (s.sum(-2, keepdim=True)[..., None] * jn
          + torch.sum(c[..., None] * jf, dim=-3, keepdim=True))
    pj = c[..., None] * jn + q[..., None] * jf            # (B, ndim, k, nv)
    p = torch.cat([p0, pj], dim=-3)                       # (B, 1+ndim, k, nv)
    return torch.einsum('...jkv,...jkw->...vw', blk.r, p)
  return torch.einsum('...nv,...n,...nw->...vw', blk.J, w, blk.J)


def _bc(p, x):
  """Per-row parameter (B, n) broadcast against x (B, [L,] n)."""
  while p.dim() < x.dim():
    p = p.unsqueeze(-2)
  return p


def _blk_force_weight(blk, x):
  """Per-row constraint force -s'(x) and Hessian weight s''(x)."""
  zero = torch.zeros_like(x)
  f_quad = -blk.big_d * x
  if isinstance(blk, StaticBlock):
    m_fl = blk.m_fl
    uni_act = (x < 0) & ~m_fl
    in_cone = (torch.abs(f_quad) < blk.fl) & m_fl
    f = torch.where(m_fl, torch.minimum(torch.maximum(f_quad, -blk.fl),
                                        blk.fl),
                    torch.where(uni_act, f_quad, zero))
    w = torch.where(in_cone | uni_act, blk.big_d, zero)
    return f, w
  if blk.kind == _BILATERAL:
    return f_quad, blk.big_d
  if blk.kind == _FRICTIONLOSS:
    f = torch.minimum(torch.maximum(f_quad, -blk.fl), blk.fl)
    w = torch.where(torch.abs(f_quad) < blk.fl, blk.big_d, zero)
    return f, w
  active = x < 0
  return torch.where(active, f_quad, zero), torch.where(active, blk.big_d,
                                                        zero)


def _blk_cost(blk, x):
  """Per-block convex penalty s(x), summed over the last axis; x is
  (B, n) or (B, L, n) (line-search candidates)."""
  big_d = _bc(blk.big_d, x)
  quad = 0.5 * big_d * x * x
  zero = torch.zeros_like(quad)
  if isinstance(blk, StaticBlock):
    fl = _bc(blk.fl, x)
    lin = fl * torch.abs(x) - 0.5 * fl * fl / torch.clamp_min(big_d, 1e-12)
    c_fl = torch.where(torch.abs(big_d * x) < fl, quad, lin)
    c_uni = torch.where(x < 0, quad, zero)
    return torch.sum(torch.where(blk.m_fl, c_fl, c_uni), dim=-1)
  if blk.kind == _BILATERAL:
    return torch.sum(quad, dim=-1)
  return torch.sum(torch.where(x < 0, quad, zero), dim=-1)


def _dot(a, b):
  return (a * b).sum(-1)


def _mv(m, v):
  return torch.einsum('...vw,...w->...v', m, v)


def solve(model: Model, data: Data, qfrc_smooth: torch.Tensor,
          contact_groups=None) -> Data:
  """Newton over block-structured rows, batch-leading.  The contacts come
  from `contact_groups` (the hot substep's narrow phase) or, when None,
  from data.contact."""
  with profiling.trace_annotation('constraint.solve'):
    dtype = data.qpos.dtype
    nv = model.nv
    if model.opt.implicit_damping:
      # Solve against M' = M + h·diag(damping): qacc is already damped.
      m = data.qM + model.opt.timestep * torch.diag(
          model.dof_damping.to(dtype))
    else:
      m = data.qM

    def smooth_only():
      qacc = linalg_cuda.cholesky_solve(m, qfrc_smooth)
      return data.replace(qfrc_constraint=torch.zeros_like(qfrc_smooth),
                          qacc_smooth=qacc, qacc=qacc)

    if model.opt.disable_constraint:
      return smooth_only()
    with profiling.trace_annotation('constraint.assemble'):
      blocks = assemble_blocks(model, data, contact_groups=contact_groups)
    if not blocks:
      return smooth_only()

    def matvecs(v):
      return tuple(_blk_matvec(b, v) for b in blocks)

    def row_cost(xs):
      return sum(_blk_cost(b, x) for b, x in zip(blocks, xs))

    alphas = 2.0 ** -torch.arange(model.opt.ls_iterations, dtype=dtype,
                                  device=qfrc_smooth.device)
    refac_every = model.opt.solver_refactor_every
    eye = 1e-10 * torch.eye(nv, dtype=dtype, device=qfrc_smooth.device)

    def hessian(fws):
      return m + sum(_blk_hess(b, w, nv) for b, (_, w) in zip(blocks, fws))

    def newton_iter(carry, fac):
      """One (modified-)Newton iteration.  fac=None: factor the Hessian this
      iteration; otherwise re-solve against the stale packed factor."""
      a, xs, ma = carry
      fws = [_blk_force_weight(b, x) for b, x in zip(blocks, xs)]
      grad = (ma - qfrc_smooth
              - sum(_blk_rmatvec(b, f) for b, (f, _) in zip(blocks, fws)))
      if refac_every > 1:
        if fac is None:
          # Detached, as the JAX package stops its gradient: the packed
          # factor is a preconditioner whose tangents vanish at the
          # solver's fixed point (K1's rule drops dH as well).
          sol, fac = linalg_cuda.cholesky_solve_factor(
              (hessian(fws) + eye).detach(), grad)
          delta = -sol
        else:
          delta = -linalg_cuda.cholesky_resolve_const(fac, grad)
      else:
        delta = -linalg_cuda.cholesky_solve(hessian(fws) + eye, grad)
      jds = matvecs(delta)
      md = _mv(m, delta)
      # cost(a + al·delta) = quad0 + al·lin + al²·quad2 + row_cost(x + al·jd)
      quad0 = 0.5 * _dot(a, ma) - _dot(a, qfrc_smooth)
      lin = _dot(delta, ma) - _dot(delta, qfrc_smooth)
      quad2 = 0.5 * _dot(delta, md)
      c0 = quad0 + row_cost(xs)
      costs = (quad0[..., None] + alphas * lin[..., None]
               + alphas * alphas * quad2[..., None]
               + row_cost(tuple(x.unsqueeze(-2) + alphas[:, None]
                                * jd.unsqueeze(-2)
                                for x, jd in zip(xs, jds))))
      # argmin with first-occurrence ties (the largest alpha).
      cmin = torch.amin(costs, dim=-1)
      is_min = costs == cmin[..., None]
      first = is_min & (torch.cumsum(is_min.to(torch.int32), dim=-1) == 1)
      step = torch.where(cmin < c0,
                         torch.sum(torch.where(first, alphas, 0.0), dim=-1),
                         torch.zeros_like(cmin))
      # step is 0 or one of the alphas: a row at 0 repeats the same
      # arithmetic in every later iteration.
      profiling.count('row_iters', step.numel())
      profiling.count('moved', step, torch.count_nonzero)
      new_xs = tuple(x + step[..., None] * jd for x, jd in zip(xs, jds))
      return (a + step[..., None] * delta, new_xs,
              ma + step[..., None] * md), fac

    with profiling.trace_annotation('constraint.newton'):
      # Warm start from the previous step's qacc when it is cheaper than
      # zero.
      warm = data.qacc
      xs_warm = tuple(mv - b.aref for mv, b in zip(matvecs(warm), blocks))
      ma_warm = _mv(m, warm)
      xs_zero = tuple(-b.aref for b in blocks)
      c_warm = (0.5 * _dot(warm, ma_warm) - _dot(warm, qfrc_smooth)
                + row_cost(xs_warm))
      c_zero = row_cost(xs_zero)
      use_warm = (c_warm < c_zero)[..., None]
      carry = (torch.where(use_warm, warm, torch.zeros_like(warm)),
               tuple(torch.where(use_warm, xw, xz)
                     for xw, xz in zip(xs_warm, xs_zero)),
               torch.where(use_warm, ma_warm, torch.zeros_like(ma_warm)))
      # The refactor schedule is unrolled: iteration `it` factors when
      # it % refac_every == 0 and re-solves against the stale factor
      # otherwise.
      fac = None
      for it in range(model.opt.solver_iterations):
        if it % refac_every == 0:
          fac = None
        carry, fac = newton_iter(carry, fac)
    a, xs, _ = carry

    fs = [_blk_force_weight(b, x)[0] for b, x in zip(blocks, xs)]
    qfrc_constraint = sum(_blk_rmatvec(b, f) for b, f in zip(blocks, fs))
    # Joint-transmitted share (limits, frictionloss, JOINT/TENDON
    # equalities): what a joint torque sensor sees; contacts and
    # CONNECT/WELD wrenches are external.
    axis_terms = []
    for b, f in zip(blocks, fs):
      if isinstance(b, StaticBlock):
        axis_terms.append(_blk_rmatvec(b, f))
      elif isinstance(b, DenseBlock) and b.trans.any():
        axis_terms.append(_blk_rmatvec(
            b, f * torch.as_tensor(b.trans, dtype=dtype, device=f.device)))
    qfrc_constraint_axis = (sum(axis_terms) if axis_terms
                            else torch.zeros_like(qfrc_smooth))
    return data.replace(qacc=a, qfrc_constraint=qfrc_constraint,
                        qfrc_constraint_axis=qfrc_constraint_axis)
