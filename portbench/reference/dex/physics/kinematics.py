"""Forward kinematics (port of dexterity_tpu/physics/kinematics.py).

World-frame Plücker coordinates about the world origin: motion vectors
are [angular(3), linear-velocity-of-origin-coincident-point(3)].

Layouts follow the JAX package: the plane functions take component planes
with the batch TRAILING ((nq, B) in, (3, nbody, B) out); `fwd_position`,
`fwd_velocity_kinematics` and the Jacobians take a Data with any leading
batch shape (none for one environment).
"""

from __future__ import annotations

import numpy as np
import torch

from reference.dex.core.types import Data, JointType, Model
from reference.dex.physics import math as tmath
from reference.dex.physics import tree


def _joint_class_tables(model: Model):
  """Static per-class joint/body index tables (device index tensors)."""
  def build():
    out = {}
    for jtype in (JointType.HINGE, JointType.SLIDE, JointType.BALL,
                  JointType.FREE):
      jids = [ji for ji in range(model.njnt)
              if model.jnt_type[ji] == int(jtype)]
      tabs = dict(
          jids=jids,
          body=[model.jnt_bodyid[j] for j in jids],
          qadr=[model.jnt_qposadr[j] for j in jids],
          dadr=[model.jnt_dofadr[j] for j in jids])
      out[jtype] = {k: torch.as_tensor(np.asarray(v, np.int64),
                                       device=model.device)
                    for k, v in tabs.items()}
    mocap_body = [b for b in range(model.nbody) if model.body_mocapid[b] >= 0]
    out['mocap'] = tuple(torch.as_tensor(np.asarray(v, np.int64),
                                         device=model.device)
                         for v in (mocap_body,
                                   [model.body_mocapid[b] for b in mocap_body]))
    out['jump'] = [torch.as_tensor(np.asarray(t, np.int64),
                                   device=model.device)
                   for t in tree.jump_tables(model.body_parentid)]
    return out
  return model.cached('joint_class_tables', build)


def body_poses_planes(model: Model, qpos: torch.Tensor, mocap_pos,
                      mocap_quat):
  """Plane-form FK: world body poses and dof axes.

  Returns (xpos_p, xquat_p, cdof6) shaped (3, nbody, *B), (4, nbody, *B)
  and (6, nv, *B) (cdof rows [ang, lin]) for qpos (nq, *B) and mocap
  (nmocap, 3|4, *B): local poses per body, then pointer-jumping
  composition along the ancestor chains.
  """
  dtype = qpos.dtype
  nbody = model.nbody
  bshape = tuple(qpos.shape[1:])
  bdims = (1,) * len(bshape)
  cls = _joint_class_tables(model)

  def consts(a, idx=None):
    a = a.to(dtype)
    if idx is not None:
      a = a[idx]
    return tuple(a[..., c].reshape(a.shape[:-1] + bdims)
                 for c in range(a.shape[-1]))

  def init(planes):
    return [p.expand((nbody,) + bshape).clone() for p in planes]

  lpos = init(consts(model.body_pos))
  lquat = init(consts(model.body_quat))

  def gather(planes, b):
    return tuple(p[b] for p in planes)

  def set_rows(planes, b, vals):
    for p, v in zip(planes, vals):
      p[b] = v

  t = cls[JointType.HINGE]
  if len(t['jids']):
    q = qpos[t['qadr']]
    axis = consts(model.jnt_axis, t['jids'])
    jpos = consts(model.jnt_pos, t['jids'])
    half = 0.5 * q
    s = torch.sin(half)
    dq = (torch.cos(half), axis[0] * s, axis[1] * s, axis[2] * s)
    rj = tmath.quat_rotate_p(dq, jpos)
    pos_l = (jpos[0] - rj[0], jpos[1] - rj[1], jpos[2] - rj[2])
    b = t['body']
    qb = gather(lquat, b)
    rp = tmath.quat_rotate_p(qb, pos_l)
    set_rows(lpos, b, [p[b] + r for p, r in zip(lpos, rp)])
    set_rows(lquat, b, tmath.quat_mul_p(qb, dq))

  t = cls[JointType.SLIDE]
  if len(t['jids']):
    q = qpos[t['qadr']]
    axis = consts(model.jnt_axis, t['jids'])
    b = t['body']
    rp = tmath.quat_rotate_p(gather(lquat, b),
                             (axis[0] * q, axis[1] * q, axis[2] * q))
    set_rows(lpos, b, [p[b] + r for p, r in zip(lpos, rp)])

  t = cls[JointType.BALL]
  if len(t['jids']):
    qadr = t['qadr']
    dq = tmath.quat_normalize_p(tuple(qpos[qadr + i] for i in range(4)))
    jpos = consts(model.jnt_pos, t['jids'])
    rj = tmath.quat_rotate_p(dq, jpos)
    pos_l = (jpos[0] - rj[0], jpos[1] - rj[1], jpos[2] - rj[2])
    b = t['body']
    qb = gather(lquat, b)
    rp = tmath.quat_rotate_p(qb, pos_l)
    set_rows(lpos, b, [p[b] + r for p, r in zip(lpos, rp)])
    set_rows(lquat, b, tmath.quat_mul_p(qb, dq))

  t = cls[JointType.FREE]
  if len(t['jids']):
    qadr = t['qadr']
    b = t['body']
    set_rows(lpos, b, [qpos[qadr + i] for i in range(3)])
    set_rows(lquat, b, tmath.quat_normalize_p(
        tuple(qpos[qadr + 3 + i] for i in range(4))))

  mocap_body, mocap_id = cls['mocap']
  if len(mocap_body):
    set_rows(lpos, mocap_body,
             [mocap_pos[mocap_id, c].to(dtype) for c in range(3)])
    set_rows(lquat, mocap_body,
             [mocap_quat[mocap_id, c].to(dtype) for c in range(4)])

  # World row stays identity.
  for p, v in zip(lpos + lquat, (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)):
    p[0] = v

  # Pointer jumping.
  for anc in cls['jump']:
    qa = gather(lquat, anc)
    rp = tmath.quat_rotate_p(qa, tuple(lpos))
    lpos = [lp[anc] + r for lp, r in zip(lpos, rp)]
    lquat = list(tmath.quat_mul_p(qa, tuple(lquat)))

  xpos_t, xquat_t = tuple(lpos), tuple(lquat)

  # cdof planes from final poses, per joint class.
  ang = [torch.zeros((model.nv,) + bshape, dtype=dtype, device=qpos.device)
         for _ in range(3)]
  lin = [torch.zeros_like(ang[0]) for _ in range(3)]

  def neg(v):
    return (-v[0], -v[1], -v[2])

  t = cls[JointType.HINGE]
  if len(t['jids']):
    b = t['body']
    qb = gather(xquat_t, b)
    pb = gather(xpos_t, b)
    axis_w = tmath.quat_rotate_p(qb, consts(model.jnt_axis, t['jids']))
    rj = tmath.quat_rotate_p(qb, consts(model.jnt_pos, t['jids']))
    anchor = (pb[0] + rj[0], pb[1] + rj[1], pb[2] + rj[2])
    lin_w = tmath.cross_p(axis_w, neg(anchor))
    set_rows(ang, t['dadr'], axis_w)
    set_rows(lin, t['dadr'], lin_w)

  t = cls[JointType.SLIDE]
  if len(t['jids']):
    b = t['body']
    axis_w = tmath.quat_rotate_p(gather(xquat_t, b),
                                 consts(model.jnt_axis, t['jids']))
    set_rows(lin, t['dadr'], axis_w)

  t = cls[JointType.BALL]
  if len(t['jids']):
    b = t['body']
    qb = gather(xquat_t, b)
    pb = gather(xpos_t, b)
    mat = tmath.quat_to_mat_p(qb)
    rj = tmath.quat_rotate_p(qb, consts(model.jnt_pos, t['jids']))
    anchor = (pb[0] + rj[0], pb[1] + rj[1], pb[2] + rj[2])
    for a in range(3):
      axis_w = (mat[a], mat[3 + a], mat[6 + a])   # column a of R
      set_rows(ang, t['dadr'] + a, axis_w)
      set_rows(lin, t['dadr'] + a, tmath.cross_p(axis_w, neg(anchor)))

  t = cls[JointType.FREE]
  if len(t['jids']):
    b = t['body']
    qb = gather(xquat_t, b)
    pb = gather(xpos_t, b)
    mat = tmath.quat_to_mat_p(qb)
    for a in range(3):
      lin[a][t['dadr'] + a] = 1.0
    for a in range(3):
      axis_w = (mat[a], mat[3 + a], mat[6 + a])
      set_rows(ang, t['dadr'] + 3 + a, axis_w)
      set_rows(lin, t['dadr'] + 3 + a, tmath.cross_p(axis_w, neg(pb)))

  xpos_p = torch.stack(xpos_t)                    # (3, nbody, *B)
  xquat_p = torch.stack(xquat_t)                  # (4, nbody, *B)
  cdof6 = torch.stack(ang + lin)                  # (6, nv, *B)
  return xpos_p, xquat_p, cdof6


def frame_planes(xpos_p, xquat_p, bodyid, pos_const, quat_const, dtype):
  """World frames of static child elements (geoms/sites/inertia boxes).

  Args:
    xpos_p/xquat_p: (3, nbody, *B)/(4, nbody, *B) body pose planes.
    bodyid: (n,) parent body per element (sequence or index tensor).
    pos_const/quat_const: (n, 3)/(n, 4) local offsets (model constants).

  Returns:
    (pos (3-tuple of (n, *B)), mat (row-major 9-tuple of (n, *B))).
  """
  b = bodyid if isinstance(bodyid, torch.Tensor) else torch.as_tensor(
      np.asarray(bodyid, np.int64), device=xpos_p.device)
  bdims = (1,) * (xpos_p.dim() - 2)
  qb = tuple(xquat_p[i][b] for i in range(4))
  pb = tuple(xpos_p[i][b] for i in range(3))
  pc = tuple(pos_const[:, i].to(dtype).reshape((-1,) + bdims)
             for i in range(3))
  qc = tuple(quat_const[:, i].to(dtype).reshape((-1,) + bdims)
             for i in range(4))
  rp = tmath.quat_rotate_p(qb, pc)
  pos = tuple(pb[i] + rp[i] for i in range(3))
  mat = tmath.quat_to_mat_p(tmath.quat_mul_p(qb, qc))
  return pos, mat


def geom_planes(model: Model, xpos_p, xquat_p) -> torch.Tensor:
  """(12, ngeom, *B) geom frame planes: rows 0-2 position, 3-11 row-major
  rotation (the narrow phase's input layout)."""
  pos, mat = frame_planes(xpos_p, xquat_p,
                          model.index('geom_bodyid', model.geom_bodyid),
                          model.geom_pos, model.geom_quat, xpos_p.dtype)
  return torch.stack(pos + mat)


def _batch_minor(x: torch.Tensor, nb: int) -> torch.Tensor:
  """Moves the first nb (batch) axes to the end."""
  return x.movedim(tuple(range(nb)), tuple(range(x.dim() - nb, x.dim())))


def _aos(planes, nb: int) -> torch.Tensor:
  """(c, n, *B) planes or a c-tuple of (n, *B) -> (*B, n, c)."""
  p = torch.stack(tuple(planes)) if isinstance(planes, tuple) else planes
  return p.movedim((0, 1), (-1, -2))


def _joint_local_qpos(model: Model, ji: int, qpos: torch.Tensor):
  """Joint ji's slice of qpos (..., nq): (position, quaternion) for a
  free joint, (None, quaternion) for a ball, (scalar, None) otherwise."""
  adr = model.jnt_qposadr[ji]
  jtype = JointType(model.jnt_type[ji])
  if jtype == JointType.FREE:
    return qpos[..., adr:adr + 3], qpos[..., adr + 3:adr + 7]
  if jtype == JointType.BALL:
    return None, qpos[..., adr:adr + 4]
  return qpos[..., adr], None


def fwd_position(model: Model, data: Data) -> Data:
  """Body/site/geom world poses, inertial frames, dof axes and tendon
  lengths for a Data with any leading batch shape (none for one
  environment).

  Every body with at most one joint (every dexterity model): local poses
  at once, then pointer-jumping composition (`body_poses_planes`, which
  the JAX package calls _fwd_position_jump).  Otherwise the general
  body-at-a-time recursion (`_fwd_position_unrolled`)."""
  nb = data.qpos.dim() - 1
  if tree.tree_tables(model).single_jointed:
    xpos_p, xquat_p, cdof6 = body_poses_planes(
        model, _batch_minor(data.qpos, nb), _batch_minor(data.mocap_pos, nb),
        _batch_minor(data.mocap_quat, nb))
  else:
    xpos, xquat, cdof = _fwd_position_unrolled(model, data)
    xpos_p, xquat_p, cdof6 = (_planes(x) for x in (xpos, xquat, cdof))
  return _fwd_position_finish(model, data, xpos_p, xquat_p, cdof6)


def _planes(x: torch.Tensor) -> torch.Tensor:
  """(*B, n, c) -> (c, n, *B): the inverse of _aos."""
  return x.movedim((-1, -2), (0, 1))


def _fwd_position_finish(model: Model, data: Data, xpos_p, xquat_p, cdof6):
  """Shared tail from the body pose and dof-axis planes: inertial, site
  and geom frames, tendon lengths, all as batch-leading AoS fields."""
  nb = data.qpos.dim() - 1
  dtype = data.qpos.dtype
  bodies = np.arange(model.nbody)
  ipos, imat = frame_planes(xpos_p, xquat_p, bodies, model.body_ipos,
                            model.body_iquat, dtype)
  spos, smat = frame_planes(xpos_p, xquat_p, model.site_bodyid,
                            model.site_pos, model.site_quat, dtype)
  gpos, gmat = frame_planes(xpos_p, xquat_p, model.geom_bodyid,
                            model.geom_pos, model.geom_quat, dtype)

  def mats(m):
    return _aos(m, nb).unflatten(-1, (3, 3))

  if model.ntendon:
    dof_qposadr = model.index('dof_qposadr', _dof_qposadr(model))
    ten_length = data.qpos[..., dof_qposadr] @ model.tendon_moment.T
  else:
    ten_length = data.qpos.new_zeros(data.qpos.shape[:-1] + (0,))
  return data.replace(
      xpos=_aos(xpos_p, nb), xquat=_aos(xquat_p, nb),
      xipos=_aos(ipos, nb), ximat=mats(imat),
      site_xpos=_aos(spos, nb), site_xmat=mats(smat),
      geom_xpos=_aos(gpos, nb), geom_xmat=mats(gmat),
      cdof=_aos(cdof6, nb), ten_length=ten_length)


def _fwd_position_unrolled(model: Model, data: Data):
  """General body-at-a-time FK (multi-joint bodies): (xpos (*B, nbody,
  3), xquat (*B, nbody, 4), cdof (*B, nv, 6))."""
  qpos = data.qpos
  bshape = qpos.shape[:-1]
  kw = dict(dtype=qpos.dtype, device=qpos.device)
  eye = torch.eye(3, **kw)
  zero3 = torch.zeros(bshape + (3,), **kw)

  def const(t):
    return t.to(qpos.dtype).expand(bshape + t.shape)

  def row(ang, lin):
    return torch.cat(torch.broadcast_tensors(ang, lin), -1)

  xpos = [zero3]
  xquat = [const(torch.tensor([1.0, 0.0, 0.0, 0.0], **kw))]
  cdof_rows = [None] * model.nv

  for b in range(1, model.nbody):
    parent = model.body_parentid[b]
    mocapid = model.body_mocapid[b]
    if mocapid >= 0:
      xpos.append(data.mocap_pos[..., mocapid, :].to(qpos.dtype))
      xquat.append(data.mocap_quat[..., mocapid, :].to(qpos.dtype))
      continue

    # Frame from the parent.
    pos, quat = tmath.pose_mul(xpos[parent], xquat[parent],
                               const(model.body_pos[b]),
                               const(model.body_quat[b]))
    jadr, jnum = model.body_jntadr[b], model.body_jntnum[b]
    for k in range(jnum):
      ji = jadr + k
      jtype = JointType(model.jnt_type[ji])
      dadr = model.jnt_dofadr[ji]
      jpos = const(model.jnt_pos[ji])
      if jtype == JointType.FREE:
        # Translational dofs along the world axes; rotational dofs along
        # the body axes, anchored at the body origin.
        pos, q_j = _joint_local_qpos(model, ji, qpos)
        quat = tmath.quat_normalize(q_j)
        for a in range(3):
          cdof_rows[dadr + a] = row(zero3, eye[a])
        for a in range(3):
          axis_w = tmath.quat_rotate(quat, eye[a])
          cdof_rows[dadr + 3 + a] = row(axis_w,
                                        tmath.cross(axis_w, -pos))
      elif jtype == JointType.BALL:
        q_j = tmath.quat_normalize(_joint_local_qpos(model, ji, qpos)[1])
        anchor = tmath.transform_point(pos, quat, jpos)
        quat = tmath.quat_mul(quat, q_j)
        pos = anchor - tmath.quat_rotate(quat, jpos)
        for a in range(3):
          axis_w = tmath.quat_rotate(quat, eye[a])
          cdof_rows[dadr + a] = row(axis_w,
                                    tmath.cross(axis_w, -anchor))
      else:
        q_j = _joint_local_qpos(model, ji, qpos)[0]
        axis_local = const(model.jnt_axis[ji])
        axis_w = tmath.quat_rotate(quat, axis_local)
        if jtype == JointType.HINGE:
          anchor = tmath.transform_point(pos, quat, jpos)
          quat = tmath.quat_mul(quat,
                                tmath.axis_angle_to_quat(axis_local, q_j))
          pos = anchor - tmath.quat_rotate(quat, jpos)
          cdof_rows[dadr] = row(axis_w, tmath.cross(axis_w, -anchor))
        else:  # SLIDE
          pos = pos + axis_w * q_j[..., None]
          cdof_rows[dadr] = row(zero3, axis_w)
    xpos.append(pos)
    xquat.append(quat)

  cdof = (torch.stack(cdof_rows, -2) if model.nv
          else qpos.new_zeros(bshape + (0, 6)))
  return torch.stack(xpos, -2), torch.stack(xquat, -2), cdof


def _dof_qposadr(model: Model) -> np.ndarray:
  """qpos address per dof (valid for scalar-joint dofs; 0 otherwise)."""
  out = np.zeros(model.nv, dtype=np.int64)
  for ji in range(model.njnt):
    if model.jnt_type[ji] in (int(JointType.HINGE), int(JointType.SLIDE)):
      out[model.jnt_dofadr[ji]] = model.jnt_qposadr[ji]
  return out


def ancestor_mask(model: Model) -> np.ndarray:
  """(nbody, nv) 0/1 mask: mask[b, i] = dof i is an ancestor dof of body b."""
  mask = np.zeros((model.nbody, model.nv), dtype=np.float64)
  for b in range(1, model.nbody):
    i = b
    while i != 0:
      if model.body_dofnum[i]:
        adr = model.body_dofadr[i]
        mask[b, adr:adr + model.body_dofnum[i]] = 1.0
      i = model.body_parentid[i]
  return mask


def fwd_velocity_kinematics(model: Model, data: Data) -> Data:
  """Body spatial velocities (cvel, (..., nbody, 6)) and tendon
  velocities: cvel[b] is the sum of b's ancestor dofs' cdof * qvel, one
  contraction with the ancestor mask."""
  mask = model.const('ancestor_mask', lambda: ancestor_mask(model),
                     data.cdof.dtype)
  cvel = torch.einsum('bv,...vk->...bk', mask,
                      data.cdof * data.qvel[..., None])
  if model.ntendon:
    ten_velocity = data.qvel @ model.tendon_moment.T
  else:
    ten_velocity = data.qvel.new_zeros(data.qvel.shape[:-1] + (0,))
  return data.replace(cvel=cvel, ten_velocity=ten_velocity)


def point_velocity(data: Data, bodyid_cvel: torch.Tensor,
                   point: torch.Tensor):
  """Linear and angular world velocity of a body-fixed point, given the
  body's cvel row (..., 6) and the point (..., 3): (linvel, angvel), the
  [lin, ang] order of the reference's get_site_velocity."""
  del data
  ang = bodyid_cvel[..., :3]
  lin = bodyid_cvel[..., 3:] + tmath.cross(ang, point)
  return lin, ang


def jac_point(model: Model, data: Data, bodyid: int, point: torch.Tensor):
  """Translational and rotational Jacobians (..., 3, nv) of a world point
  (..., 3) fixed on body `bodyid`."""
  mask = model.const('ancestor_mask', lambda: ancestor_mask(model),
                     data.cdof.dtype)[bodyid]             # (nv,)
  ang = data.cdof[..., :3]                                # (..., nv, 3)
  lin = data.cdof[..., 3:] + tmath.cross(ang, point[..., None, :])
  jacp = (lin * mask[:, None]).transpose(-1, -2)
  jacr = (ang * mask[:, None]).transpose(-1, -2)
  return jacp, jacr


def site_jacobian(model: Model, data: Data, site_ids) -> torch.Tensor:
  """Stacked position Jacobians of the sites `site_ids` (static list):
  (..., 3 * len(site_ids), nv)."""
  return torch.cat([jac_point(model, data, model.site_bodyid[sid],
                              data.site_xpos[..., sid, :])[0]
                    for sid in site_ids], dim=-2)
