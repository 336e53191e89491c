"""Smooth (unconstrained) dynamics: inertia, bias, passive, actuation,
integration (port of dexterity_tpu/physics/smooth.py).

Plane functions (`*_planes`) take component planes with the batch
trailing, as in the JAX package; the others (`crb`, `rne`,
`xfrc_accumulate`, `actuation`, `passive`, `integrate_pos`, `euler`)
take a Data with any leading batch shape.  The tree reductions are
contractions with static masks.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.dex.core.types import (DOF_WIDTH, ActuatorTrn,
                                            BiasType, Data, JointType, Model)
from reference.dex.physics import kinematics
from reference.dex.physics import linalg_plain as linalg_cuda
from reference.dex.physics import math as tmath
from reference.dex.physics import tree


def _ancestor(model: Model, dtype) -> torch.Tensor:
  return model.const('ancestor_mask', lambda: kinematics.ancestor_mask(model),
                     dtype)


# ---------------------------------------------------------------------------
# AoS inertia (model compiler: inverse weights at qpos0)
# ---------------------------------------------------------------------------


def com_jacobians(model: Model, data: Data) -> torch.Tensor:
  """(..., nbody, 6, nv) spatial Jacobians at each body COM: rows
  [ang, lin]."""
  mask = _ancestor(model, data.cdof.dtype)                  # (nbody, nv)
  ang = data.cdof[..., None, :, :3]                          # (..., 1, nv, 3)
  lin0 = data.cdof[..., None, :, 3:]
  ang_b, com = torch.broadcast_tensors(ang, data.xipos[..., :, None, :])
  lin = lin0 + torch.cross(ang_b, com, dim=-1)               # (.., nbody, nv, 3)
  jac = torch.cat([ang_b, lin], dim=-1) * mask[..., None]
  return jac.transpose(-1, -2)


def crb(model: Model, data: Data) -> Data:
  """Joint-space inertia M = Σ_b J_bᵀ diag(I_b^world, m_b·1) J_b (+armature)."""
  jac = com_jacobians(model, data)
  iw = tmath.inertia_world(model.body_mass, model.body_inertia, data.ximat)
  jang = jac[..., :3, :]
  jlin = jac[..., 3:, :]
  m_ang = torch.einsum('...biv,...bij,...bjw->...vw', jang, iw, jang)
  m_lin = torch.einsum('b,...biv,...biw->...vw', model.body_mass, jlin, jlin)
  return data.replace(qM=m_ang + m_lin + torch.diag(model.dof_armature))


def solve_m(data: Data, vec: torch.Tensor) -> torch.Tensor:
  """Solves M x = vec (K3)."""
  return linalg_cuda.cholesky_solve(data.qM, vec)


# ---------------------------------------------------------------------------
# Plane-form inertia & dynamics (the hot substep)
# ---------------------------------------------------------------------------


def _subtree_mask_np(model: Model) -> np.ndarray:
  """(nbody, nbody) S[b, d] = 1 if body d is in the subtree rooted at b."""
  s = np.zeros((model.nbody, model.nbody))
  for d in range(model.nbody):
    i = d
    while True:
      s[i, d] = 1.0
      if i == 0:
        break
      i = model.body_parentid[i]
  return s


def _dof_upper_mask_np(model: Model) -> np.ndarray:
  """(nv, nv) U[v, w] = 1 iff dof v is an ancestor dof of body(w) and
  v <= w: the upper-triangular CRB sparsity pattern (topological dof
  ordering, which the compiler guarantees)."""
  anc = kinematics.ancestor_mask(model)
  db = np.asarray(model.dof_bodyid, np.int64)
  full = anc[db]
  up = np.zeros((model.nv, model.nv))
  for w in range(model.nv):
    for v in range(model.nv):
      if full[w, v] and v <= w:
        up[v, w] = 1.0
  for v in range(model.nv):
    for w in range(v + 1, model.nv):
      if full[v, w] and not full[w, v]:
        raise ValueError(
            'dof ordering is not topological; CRB mask would drop terms')
  return up


def inertia_origin_planes(model: Model, xpos_p, xquat_p):
  """Spatial-inertia params about the world origin per body.

  Returns (body10 (10, nbody, *B), xipos3 (3, nbody, *B)): body10 rows are
  [m, h(3), I_o(6 upper-tri xx,xy,xz,yy,yz,zz)], h = m·com,
  I_o = I_com + m((c·c)δ − ccᵀ)."""
  dtype = xpos_p.dtype
  bdims = (1,) * (xpos_p.dim() - 2)
  pos, mat = kinematics.frame_planes(
      xpos_p, xquat_p, model.index('body_ids', np.arange(model.nbody)),
      model.body_ipos,
      model.body_iquat, dtype)
  inertia = model.body_inertia.to(dtype)
  i1, i2, i3 = (inertia[:, c].reshape((-1,) + bdims) for c in range(3))
  m = model.body_mass.to(dtype).reshape((-1,) + bdims)

  def iw(a, b):
    return (i1 * mat[3 * a + 0] * mat[3 * b + 0]
            + i2 * mat[3 * a + 1] * mat[3 * b + 1]
            + i3 * mat[3 * a + 2] * mat[3 * b + 2])

  cx, cy, cz = pos
  cc = cx * cx + cy * cy + cz * cz
  ixx = iw(0, 0) + m * (cc - cx * cx)
  ixy = iw(0, 1) - m * cx * cy
  ixz = iw(0, 2) - m * cx * cz
  iyy = iw(1, 1) + m * (cc - cy * cy)
  iyz = iw(1, 2) - m * cy * cz
  izz = iw(2, 2) + m * (cc - cz * cz)
  body10 = torch.stack([m.expand(cx.shape), m * cx, m * cy, m * cz,
                        ixx, ixy, ixz, iyy, iyz, izz])
  return body10, torch.stack(pos)


def _spatial_inertia_apply(p10, m6):
  """Origin-frame spatial inertias (10, n, ...) applied to motion planes
  (6, n, ...) -> force planes [torque-about-origin, force]."""
  m, hx, hy, hz = p10[0], p10[1], p10[2], p10[3]
  ixx, ixy, ixz, iyy, iyz, izz = (p10[4], p10[5], p10[6], p10[7], p10[8],
                                  p10[9])
  wx, wy, wz = m6[0], m6[1], m6[2]
  vx, vy, vz = m6[3], m6[4], m6[5]
  tx = ixx * wx + ixy * wy + ixz * wz + (hy * vz - hz * vy)
  ty = ixy * wx + iyy * wy + iyz * wz + (hz * vx - hx * vz)
  tz = ixz * wx + iyz * wy + izz * wz + (hx * vy - hy * vx)
  fx = m * vx + (wy * hz - wz * hy)
  fy = m * vy + (wz * hx - wx * hz)
  fz = m * vz + (wx * hy - wy * hx)
  return torch.stack([tx, ty, tz, fx, fy, fz])


def crb_planes(model: Model, body10: torch.Tensor, cdof6: torch.Tensor):
  """Joint-space inertia (nv, nv, *B) via the CRB algorithm as three
  contractions: subtree-composite inertias (static subtree mask), per-dof
  spatial force f_w = I^C_{body(w)} cdof_w, and M[v, w] = cdof_v · f_w on
  the static ancestor-dof sparsity pattern."""
  dtype = body10.dtype
  sub = model.const('subtree_mask', lambda: _subtree_mask_np(model), dtype)
  comp = torch.einsum('cn...,mn->cm...', body10, sub)
  db = model.index('dof_bodyid', model.dof_bodyid)
  f6 = _spatial_inertia_apply(comp[:, db], cdof6)
  g = torch.einsum('cv...,cw...->vw...', cdof6, f6)
  bdims = (1,) * (cdof6.dim() - 2)
  up = model.const('dof_upper_mask', lambda: _dof_upper_mask_np(model), dtype)
  u = g * up.reshape(up.shape + bdims)
  off = 1.0 - torch.eye(model.nv, dtype=dtype, device=g.device)
  qm = u + u.transpose(0, 1) * off.reshape(off.shape + bdims)
  arm = torch.diag(model.dof_armature.to(dtype))
  return qm + arm.reshape(arm.shape + bdims)


def _motion_cross_planes(v6, m6):
  """Spatial motion cross product on planes: v ×ₘ m."""
  ax, ay, az = v6[0], v6[1], v6[2]
  bx, by, bz = m6[0], m6[1], m6[2]
  cx, cy, cz = v6[3], v6[4], v6[5]
  dx, dy, dz = m6[3], m6[4], m6[5]
  return torch.stack([
      ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx,
      (ay * dz - az * dy) + (cy * bz - cz * by),
      (az * dx - ax * dz) + (cz * bx - cx * bz),
      (ax * dy - ay * dx) + (cx * by - cy * bx)])


def _force_cross_planes(v6, f6):
  """Motion ×* force on planes."""
  ax, ay, az = v6[0], v6[1], v6[2]
  cx, cy, cz = v6[3], v6[4], v6[5]
  tx, ty, tz = f6[0], f6[1], f6[2]
  fx, fy, fz = f6[3], f6[4], f6[5]
  return torch.stack([
      (ay * tz - az * ty) + (cy * fz - cz * fy),
      (az * tx - ax * tz) + (cz * fx - cx * fz),
      (ax * ty - ay * tx) + (cx * fy - cy * fx),
      ay * fz - az * fy, az * fx - ax * fz, ax * fy - ay * fx])


def _trans_free_np(model: Model) -> np.ndarray:
  out = np.zeros(model.nv, bool)
  for ji in range(model.njnt):
    if model.jnt_type[ji] == int(JointType.FREE):
      d = model.jnt_dofadr[ji]
      out[d:d + 3] = True
  return out


def rne_planes(model: Model, body10: torch.Tensor, cdof6: torch.Tensor,
               qvel: torch.Tensor):
  """qfrc_bias = C(q, v)·v + G(q) in plane form (single-jointed trees).

  Returns (qfrc_bias (nv, *B), cvel6 (6, nbody, *B))."""
  dtype = cdof6.dtype
  bdims = (1,) * (cdof6.dim() - 2)
  mask = _ancestor(model, dtype)
  w6 = cdof6 * qvel[None]
  cvel6 = torch.einsum('cv...,nv->cn...', w6, mask)

  db = model.index('dof_bodyid', model.dof_bodyid)
  ref6 = cvel6[:, db]
  trans_free = _trans_free_np(model)
  if trans_free.any():
    keep = model.const('not_trans_free', lambda: ~trans_free, torch.bool)
    ref6 = ref6 * keep.reshape((1, -1) + bdims)

  tau6 = _motion_cross_planes(ref6, cdof6) * qvel[None]
  grav6 = torch.cat([torch.zeros(3, dtype=dtype, device=cdof6.device),
                     -model.opt.gravity.to(dtype)])
  cacc6 = (grav6.reshape((6, 1) + bdims)
           + torch.einsum('cv...,nv->cn...', tau6, mask))

  iv = _spatial_inertia_apply(body10, cvel6)
  ia = _spatial_inertia_apply(body10, cacc6)
  f6 = ia + _force_cross_planes(cvel6, iv)

  btot = torch.einsum('cn...,nv->cv...', f6, mask)
  qfrc_bias = torch.einsum('cv...,cv...->v...', cdof6, btot)
  return qfrc_bias, cvel6


def xfrc_planes(model: Model, xipos3: torch.Tensor, cdof6: torch.Tensor,
                xfrc_applied: torch.Tensor) -> torch.Tensor:
  """Projects world COM wrenches (nbody, 6, *B) into qfrc (nv, *B)."""
  dtype = cdof6.dtype
  com = (xipos3[0], xipos3[1], xipos3[2])
  force = tuple(xfrc_applied[:, c].to(dtype) for c in range(3))
  torque = tuple(xfrc_applied[:, 3 + c].to(dtype) for c in range(3))
  tau0 = tmath.cross_p(com, force)
  f6 = torch.stack([torque[0] + tau0[0], torque[1] + tau0[1],
                    torque[2] + tau0[2]] + list(force))
  mask = _ancestor(model, dtype)
  return torch.einsum('cv...,cv...->v...', cdof6,
                      torch.einsum('cn...,nv->cv...', f6, mask))


# ---------------------------------------------------------------------------
# Bias forces (coriolis + centrifugal + gravity): RNEA in Plücker coords
# ---------------------------------------------------------------------------


def _motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
  """Spatial cross product of motion vectors (..., 6): v ×ₘ m."""
  vang, vlin = v[..., :3], v[..., 3:]
  mang, mlin = m[..., :3], m[..., 3:]
  return torch.cat([tmath.cross(vang, mang),
                    tmath.cross(vang, mlin) + tmath.cross(vlin, mang)], -1)


def _inertia_mul(mass, com, iw, motion):
  """Spatial inertia about the world origin applied to a motion vector,
  over any leading axes (it is also the JAX package's per-body
  `_inertia_mul_batch`; `_force_cross` likewise serves as
  `_force_cross_batch`).

  Args:
    mass: (...) body mass.
    com: (..., 3) world COM.
    iw: (..., 3, 3) world rotational inertia about the COM.
    motion: (..., 6) [ang, lin0].

  Returns:
    (..., 6) force vector [torque-about-origin, force].
  """
  ang, lin0 = motion[..., :3], motion[..., 3:]
  h = mass[..., None] * (lin0 + tmath.cross(ang, com))   # linear momentum
  l0 = (iw @ ang[..., None])[..., 0] + tmath.cross(com, h)
  return torch.cat([l0, h], -1)


def _force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """Motion ×* force, the dual cross product, on (..., 6) vectors."""
  vang, vlin = v[..., :3], v[..., 3:]
  tau0, force = f[..., :3], f[..., 3:]
  return torch.cat([tmath.cross(vang, tau0) + tmath.cross(vlin, force),
                    tmath.cross(vang, force)], -1)


def _dof_width(model: Model, ji: int) -> int:
  return DOF_WIDTH[JointType(model.jnt_type[ji])]


def rne(model: Model, data: Data) -> Data:
  """qfrc_bias = C(q, v)·v + G(q), by Newton–Euler with qacc = 0; also
  sets cvel.

  Velocities and bias accelerations by two ancestor-mask contractions
  when every body has at most one joint; the general body-at-a-time
  recursion otherwise."""
  dtype = data.qpos.dtype
  iw = tmath.inertia_world(model.body_mass, model.body_inertia.to(dtype),
                           data.ximat)
  if tree.tree_tables(model).single_jointed:
    cvel, cacc = _vel_acc_matmul(model, data, dtype)
  else:
    cvel, cacc = _vel_acc_unrolled(model, data, dtype)

  # Per-body bias force f = I a + v ×* (I v).
  mass = model.body_mass.to(dtype)
  iv = _inertia_mul(mass, data.xipos, iw, cvel)
  ia = _inertia_mul(mass, data.xipos, iw, cacc)
  forces = ia + _force_cross(cvel, iv)

  # Backward pass as a mask contraction: qfrc_bias_i = Σ_b mask[b, i]
  # (cdof_i · f_b).
  mask = _ancestor(model, dtype)
  qfrc_bias = (data.cdof * torch.einsum('bv,...bk->...vk', mask,
                                        forces)).sum(-1)
  return data.replace(qfrc_bias=qfrc_bias, cvel=cvel)


def _vel_acc_matmul(model: Model, data: Data, dtype):
  """Velocity and bias acceleration as two ancestor-mask contractions.

  cvel[b] = Σ_{dofs i on the path to b} cdof_i qvel_i.  The per-dof bias
  term τ_i = (v ×ₘ cdof_i) qvel_i takes as v the dof's body velocity
  (self terms cancel), or the parent's (world: zero) for a free joint's
  translations; cacc is then a second contraction over τ."""
  mask = _ancestor(model, dtype)
  cvel = torch.einsum('bv,...vk->...bk', mask,
                      data.cdof * data.qvel[..., None])
  ref_vel = cvel[..., model.index('dof_bodyid', model.dof_bodyid), :]
  trans_free = _trans_free_np(model)
  if trans_free.any():
    keep = model.const('not_trans_free', lambda: ~trans_free, torch.bool)
    ref_vel = ref_vel * keep[:, None]
  tau = _motion_cross(ref_vel, data.cdof) * data.qvel[..., None]
  grav = torch.cat([torch.zeros(3, dtype=dtype, device=data.qpos.device),
                    -model.opt.gravity.to(dtype)])
  cacc = grav + torch.einsum('bv,...vk->...bk', mask, tau)
  return cvel, cacc


def _vel_acc_unrolled(model: Model, data: Data, dtype):
  """General body-at-a-time sweep (multi-joint bodies)."""
  bshape = data.qpos.shape[:-1]
  zero = data.qpos.new_zeros(bshape + (6,))
  grav = torch.cat([torch.zeros(3, dtype=dtype, device=data.qpos.device),
                    -model.opt.gravity.to(dtype)])
  cvel, cacc = [zero], [zero + grav]
  cdof, qvel = data.cdof, data.qvel
  for b in range(1, model.nbody):
    parent = model.body_parentid[b]
    vel, acc = cvel[parent], cacc[parent]
    jadr, jnum = model.body_jntadr[b], model.body_jntnum[b]
    for k in range(jnum):
      ji = jadr + k
      dadr = model.jnt_dofadr[ji]
      jtype = JointType(model.jnt_type[ji])
      if jtype in (JointType.HINGE, JointType.SLIDE):
        cdof_d, qd = cdof[..., dadr, :], qvel[..., dadr, None]
        acc = acc + _motion_cross(vel, cdof_d) * qd
        vel = vel + cdof_d * qd
      else:
        width = _dof_width(model, ji)
        vel_full = vel + sum(cdof[..., d, :] * qvel[..., d, None]
                             for d in range(dadr, dadr + width))
        rot_start = dadr + 3 if jtype == JointType.FREE else dadr
        for d in range(rot_start, dadr + width):
          acc = acc + (_motion_cross(vel_full, cdof[..., d, :])
                       * qvel[..., d, None])
        vel = vel_full
    cvel.append(vel)
    cacc.append(acc)
  return torch.stack(cvel, -2), torch.stack(cacc, -2)


# ---------------------------------------------------------------------------
# Applied / passive / actuator forces (batch-leading)
# ---------------------------------------------------------------------------


def xfrc_accumulate(model: Model, data: Data) -> torch.Tensor:
  """Projects xfrc_applied (world force/torque at each body's COM,
  (..., nbody, 6)) into joint space, (..., nv)."""
  dtype = data.qpos.dtype
  force = data.xfrc_applied[..., :3].to(dtype)
  torque = data.xfrc_applied[..., 3:].to(dtype)
  fvec = torch.cat([torque + tmath.cross(data.xipos, force), force], -1)
  return torch.einsum('...vk,...bk,bv->...v', data.cdof, fvec,
                      _ancestor(model, dtype))


def passive(model: Model, data: Data) -> Data:
  """Viscous joint damping (frictionloss is a constraint row)."""
  return data.replace(qfrc_passive=-model.dof_damping * data.qvel)


def _actuator_tables(model: Model):
  def build():
    trntype = np.asarray(model.actuator_trntype)
    trnid = np.asarray(model.actuator_trnid)
    u_jnt = np.where(trntype == int(ActuatorTrn.JOINT))[0]
    u_ten = np.where(trntype == int(ActuatorTrn.TENDON))[0]
    qadr = np.asarray([model.jnt_qposadr[t] for t in trnid[u_jnt]], np.int64)
    dadr = np.asarray([model.jnt_dofadr[t] for t in trnid[u_jnt]], np.int64)
    tids = trnid[u_ten]
    gear = model.actuator_gear
    # The transmission moment (nu, nv) is a model constant.
    moment = torch.zeros((model.nu, model.nv), dtype=model.dtype,
                         device=model.device)
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                    device=model.device)
    if len(u_jnt):
      moment[idx(u_jnt), idx(dadr)] = gear[idx(u_jnt)]
    if len(u_ten):
      moment[idx(u_ten)] = (model.tendon_moment[idx(tids)]
                            * gear[idx(u_ten)][:, None])
    affine = (np.asarray(model.actuator_biastype) ==
              int(BiasType.AFFINE)).astype(np.float64)
    return dict(u_jnt=idx(u_jnt), u_ten=idx(u_ten), qadr=idx(qadr),
                dadr=idx(dadr), tids=idx(tids), moment=moment,
                affine=torch.as_tensor(affine, dtype=model.dtype,
                                       device=model.device))
  return model.cached('actuator_tables', build)


def actuation(model: Model, data: Data) -> Data:
  """Actuator forces: force = gain·ctrl + bias(length, velocity), on
  joints and fixed tendons."""
  nu = model.nu
  if nu == 0:
    return data.replace(qfrc_actuator=torch.zeros_like(data.qvel))
  t = _actuator_tables(model)
  gear = model.actuator_gear
  bshape = data.qpos.shape[:-1]
  length = data.qpos.new_zeros(bshape + (nu,))
  velocity = data.qpos.new_zeros(bshape + (nu,))
  if len(t['u_jnt']):
    g = gear[t['u_jnt']]
    length[..., t['u_jnt']] = data.qpos[..., t['qadr']] * g
    velocity[..., t['u_jnt']] = data.qvel[..., t['dadr']] * g
  if len(t['u_ten']):
    g = gear[t['u_ten']]
    length[..., t['u_ten']] = data.ten_length[..., t['tids']] * g
    velocity[..., t['u_ten']] = data.ten_velocity[..., t['tids']] * g

  ctrl = torch.clamp(data.ctrl, model.actuator_ctrlrange[:, 0],
                     model.actuator_ctrlrange[:, 1])
  force = model.actuator_gainprm[:, 0] * ctrl
  bias = (model.actuator_biasprm[:, 0]
          + model.actuator_biasprm[:, 1] * length
          + model.actuator_biasprm[:, 2] * velocity)
  force = force + t['affine'] * bias
  force = torch.clamp(force, model.actuator_forcerange[:, 0],
                      model.actuator_forcerange[:, 1])
  return data.replace(
      actuator_length=length, actuator_velocity=velocity,
      actuator_force=force, qfrc_actuator=force @ t['moment'])


# ---------------------------------------------------------------------------
# Integration (batch-leading)
# ---------------------------------------------------------------------------


def _integrate_tables(model: Model):
  def build():
    types = np.asarray(model.jnt_type)
    scalar = np.where((types == int(JointType.HINGE))
                      | (types == int(JointType.SLIDE)))[0]
    return dict(
        qadr=model.index('scalar_qadr',
                         [model.jnt_qposadr[j] for j in scalar]),
        dadr=model.index('scalar_dadr',
                         [model.jnt_dofadr[j] for j in scalar]),
        ball=[(model.jnt_qposadr[j], model.jnt_dofadr[j])
              for j in np.where(types == int(JointType.BALL))[0]],
        free=[(model.jnt_qposadr[j], model.jnt_dofadr[j])
              for j in np.where(types == int(JointType.FREE))[0]])
  return model.cached('integrate_tables', build)


def integrate_pos(model: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt) -> torch.Tensor:
  """mj_integratePos: qpos ← qpos ⊕ qvel·dt (quaternion-aware)."""
  t = _integrate_tables(model)
  out = qpos.clone()
  if len(t['qadr']):
    out[..., t['qadr']] = qpos[..., t['qadr']] + dt * qvel[..., t['dadr']]
  for qadr, dadr in t['ball']:
    out[..., qadr:qadr + 4] = tmath.quat_integrate(
        qpos[..., qadr:qadr + 4], qvel[..., dadr:dadr + 3], dt)
  for qadr, dadr in t['free']:
    out[..., qadr:qadr + 3] = (qpos[..., qadr:qadr + 3]
                               + dt * qvel[..., dadr:dadr + 3])
    out[..., qadr + 3:qadr + 7] = tmath.quat_integrate(
        qpos[..., qadr + 3:qadr + 7], qvel[..., dadr + 3:dadr + 6], dt)
  return out


def euler(model: Model, data: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping (MuJoCo 'Euler'),
  from the smooth forces of a forward pass (`euler_from_smooth`)."""
  qfrc_smooth = (data.qfrc_passive + data.qfrc_actuator + data.qfrc_applied
                 + xfrc_accumulate(model, data) - data.qfrc_bias)
  return euler_from_smooth(model, data, qfrc_smooth)


def euler_from_smooth(model: Model, data: Data,
                      qfrc_smooth: torch.Tensor) -> Data:
  """Semi-implicit Euler with implicit joint damping (MuJoCo 'Euler'):
  solves (M + h·diag(damping)) qacc = qfrc_smooth + qfrc_constraint, then
  v⁺ = v + h·qacc, q⁺ = q ⊕ h·v⁺.  With Option.implicit_damping the
  constraint solve already used M + h·diag(damping), so its qacc is
  integrated directly.  data.qacc keeps the constraint-stage acceleration."""
  h = model.opt.timestep
  if model.opt.implicit_damping:
    qacc_implicit = data.qacc
  else:
    qfrc = qfrc_smooth + data.qfrc_constraint
    mhb = data.qM + h * torch.diag(model.dof_damping.to(data.qM.dtype))
    qacc_implicit = linalg_cuda.cholesky_solve(mhb, qfrc)
  qvel = data.qvel + h * qacc_implicit
  qpos = integrate_pos(model, data.qpos, qvel, h)
  return data.replace(qpos=qpos, qvel=qvel, time=data.time + h)
