"""Structure-of-arrays narrow-phase kernels
(port of dexterity_tpu/physics/collision/soa.py).

Every variable is one plane per scalar component, shaped (*B, m) over the
candidate-pair axis m with any leading batch shape B.  A kernel's k contact
points per pair stack on the axis before it: (*B, k, m).  With B = () the
functions compute exactly what the JAX per-env kernels compute.

Conventions: normal points geom1 -> geom2, dist < 0 penetrating, unused
slots report +BIG.
"""

from __future__ import annotations

from typing import Tuple

import torch

from reference.dex.core.types import GeomType

_BIG = 1e10
_EPS = 1e-10

V3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
M3 = Tuple[torch.Tensor, ...]  # row-major 9-tuple


def _stack(xs):
  """Stacks per-point planes (*B, m) into (*B, k, m)."""
  return torch.stack(torch.broadcast_tensors(*xs), dim=-2)


def _one(x):
  """A single point's plane (*B, m) as (*B, 1, m)."""
  return x.unsqueeze(-2)


def masked_topk_select(dist, payloads, k):
  """Selects the k smallest candidates of `dist` (*B, C, m) along C, with
  first-occurrence ties.  Returns (dist_sel (*B, k, m), [payload_sel
  (*B, k, m), ...])."""
  work = dist
  d_rows = []
  p_rows = [[] for _ in payloads]
  for _ in range(k):
    dsel = torch.amin(work, dim=-2)                     # (*B, m)
    ismin = work == dsel.unsqueeze(-2)
    first = ismin & (torch.cumsum(ismin.to(torch.int32), dim=-2) == 1)
    fmask = first.to(dist.dtype)
    d_rows.append(dsel)
    for out, payload in zip(p_rows, payloads):
      out.append(torch.sum(payload * fmask, dim=-2))
    work = work + (2.0 * _BIG) * fmask
  return _stack(d_rows), [_stack(rows) for rows in p_rows]


def vec3(a) -> V3:
  """A (..., 3) tensor as its three planes."""
  return a.unbind(-1)


def mat3(a) -> M3:
  """A (..., 3, 3) tensor as its row-major 9-tuple of planes."""
  return tuple(a[..., i, j] for i in range(3) for j in range(3))


def stack_v3(v: V3):
  """Three planes back into a (..., 3) tensor."""
  return torch.stack(v, dim=-1)


def add(u, v):
  return (u[0] + v[0], u[1] + v[1], u[2] + v[2])


def sub(u, v):
  return (u[0] - v[0], u[1] - v[1], u[2] - v[2])


def scale(u, s):
  return (u[0] * s, u[1] * s, u[2] * s)


def dot(u, v):
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def cross(u, v):
  return (u[1] * v[2] - u[2] * v[1],
          u[2] * v[0] - u[0] * v[2],
          u[0] * v[1] - u[1] * v[0])


def norm(u):
  return torch.sqrt(torch.clamp_min(dot(u, u), _EPS * _EPS))


def normalize(u):
  n = norm(u)
  return scale(u, 1.0 / n), n


def matvec(m: M3, v: V3) -> V3:
  return (m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
          m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
          m[6] * v[0] + m[7] * v[1] + m[8] * v[2])


def matTvec(m: M3, v: V3) -> V3:
  return (m[0] * v[0] + m[3] * v[1] + m[6] * v[2],
          m[1] * v[0] + m[4] * v[1] + m[7] * v[2],
          m[2] * v[0] + m[5] * v[1] + m[8] * v[2])


def col(m: M3, j: int) -> V3:
  return (m[j], m[3 + j], m[6 + j])


def where_v3(c, u, v):
  return (torch.where(c, u[0], v[0]), torch.where(c, u[1], v[1]),
          torch.where(c, u[2], v[2]))


def _clip(x, lo, hi):
  return torch.minimum(torch.maximum(x, lo), hi)


def _sign(x):
  return torch.sign(x)


# ---------------------------------------------------------------------------
# Kernels.  Signature: (p1:V3, m1:M3, s1:V3, p2, m2, s2) ->
#   (dist (*B, k, m), pos V3 of (*B, k, m), normal V3 of (*B, k, m))
# ---------------------------------------------------------------------------


def _single(d, pos, n):
  shape = torch.broadcast_shapes(d.shape, *(c.shape for c in pos),
                                 *(c.shape for c in n))
  return (_one(d.expand(shape)), tuple(_one(c.expand(shape)) for c in pos),
          tuple(_one(c.expand(shape)) for c in n))


def plane_sphere(p1, m1, s1, p2, m2, s2):
  n = col(m1, 2)
  d = dot(sub(p2, p1), n) - s2[0]
  pos = sub(p2, scale(n, s2[0] + 0.5 * d))
  return _single(d, pos, n)


def plane_capsule(p1, m1, s1, p2, m2, s2):
  n = col(m1, 2)
  axis = col(m2, 2)
  ds, ps = [], []
  for sgn in (1.0, -1.0):
    end = add(p2, scale(axis, sgn * s2[1]))
    d = dot(sub(end, p1), n) - s2[0]
    pos = sub(end, scale(n, s2[0] + 0.5 * d))
    ds.append(d)
    ps.append(pos)
  dist = _stack(ds)
  pos = tuple(_stack([p[i] for p in ps]) for i in range(3))
  normal = tuple(_one(c).expand(dist.shape) for c in n)
  return dist, pos, normal


def plane_box(p1, m1, s1, p2, m2, s2):
  """All 8 corners as candidates (no sort; inactive ones sit above)."""
  n = col(m1, 2)
  ds, ps = [], []
  for sx in (-1.0, 1.0):
    for sy in (-1.0, 1.0):
      for sz in (-1.0, 1.0):
        corner_local = (sx * s2[0], sy * s2[1], sz * s2[2])
        corner = add(p2, matvec(m2, corner_local))
        d = dot(sub(corner, p1), n)
        ds.append(d)
        ps.append(sub(corner, scale(n, 0.5 * d)))
  dist = _stack(ds)
  pos = tuple(_stack([p[i] for p in ps]) for i in range(3))
  normal = tuple(_one(c).expand(dist.shape) for c in n)
  return dist, pos, normal


def sphere_sphere(p1, m1, s1, p2, m2, s2):
  delta = sub(p2, p1)
  n, dist0 = normalize(delta)
  d = dist0 - s1[0] - s2[0]
  pos = add(p1, scale(n, s1[0] + 0.5 * d))
  return _single(d, pos, n)


def _closest_on_segment(a, b, p):
  ab = sub(b, a)
  t = torch.clamp(dot(sub(p, a), ab) / torch.clamp_min(dot(ab, ab), _EPS),
                  0.0, 1.0)
  return add(a, scale(ab, t))


def sphere_capsule(p1, m1, s1, p2, m2, s2):
  axis = col(m2, 2)
  a = sub(p2, scale(axis, s2[1]))
  b = add(p2, scale(axis, s2[1]))
  c = _closest_on_segment(a, b, p1)
  delta = sub(c, p1)
  n, dist0 = normalize(delta)
  d = dist0 - s1[0] - s2[0]
  pos = add(p1, scale(n, s1[0] + 0.5 * d))
  return _single(d, pos, n)


def _sphere_box_core(center, r, pb, mb, sb):
  """Shared sphere-vs-box scalar core. Returns (d, pos V3, n V3)."""
  local = matTvec(mb, sub(center, pb))
  clamped = tuple(_clip(local[i], -sb[i], sb[i]) for i in range(3))
  inside = ((torch.abs(local[0]) < sb[0]) & (torch.abs(local[1]) < sb[1])
            & (torch.abs(local[2]) < sb[2]))
  fd = tuple(sb[i] - torch.abs(local[i]) for i in range(3))
  # nearest face axis
  ax0 = (fd[0] <= fd[1]) & (fd[0] <= fd[2])
  ax1 = (~ax0) & (fd[1] <= fd[2])
  ax2 = ~(ax0 | ax1)
  fdm = torch.where(ax0, fd[0], torch.where(ax1, fd[1], fd[2]))
  sign = tuple(torch.where(local[i] >= 0, 1.0, -1.0).to(local[i].dtype)
               for i in range(3))
  axes = (ax0, ax1, ax2)
  inside_pt = tuple(torch.where(axes[i], sign[i] * sb[i], clamped[i])
                    for i in range(3))
  surf_local = tuple(torch.where(inside, inside_pt[i], clamped[i])
                     for i in range(3))
  surf = add(pb, matvec(mb, surf_local))
  delta = sub(surf, center)
  n_out, dist_out = normalize(delta)
  zero = torch.zeros_like(sign[0])
  n_in_local = (torch.where(ax0, sign[0], zero),
                torch.where(ax1, sign[1], zero),
                torch.where(ax2, sign[2], zero))
  n_in = scale(matvec(mb, n_in_local), -1.0)
  n = where_v3(inside, n_in, n_out)
  d = torch.where(inside, -fdm - r, dist_out - r)
  pos = add(center, scale(n, r + 0.5 * d))
  return d, pos, n


def sphere_box(p1, m1, s1, p2, m2, s2):
  d, pos, n = _sphere_box_core(p1, s1[0], p2, m2, s2)
  return _single(d, pos, n)


def capsule_capsule(p1, m1, s1, p2, m2, s2):
  u1, u2 = col(m1, 2), col(m2, 2)
  a1 = sub(p1, scale(u1, s1[1]))
  d1v = scale(u1, 2 * s1[1])
  a2 = sub(p2, scale(u2, s2[1]))
  d2v = scale(u2, 2 * s2[1])
  r = sub(a1, a2)
  a = dot(d1v, d1v)
  e = dot(d2v, d2v)
  f = dot(d2v, r)
  c = dot(d1v, r)
  b = dot(d1v, d2v)
  denom = a * e - b * b
  ok = denom > _EPS
  s = torch.clamp(torch.where(
      ok, (b * f - c * e) / torch.where(ok, denom, torch.ones_like(denom)),
      torch.zeros_like(denom)), 0.0, 1.0)
  t = (b * s + f) / torch.clamp_min(e, _EPS)
  t_cl = torch.clamp(t, 0.0, 1.0)
  s = torch.clamp((b * t_cl - c) / torch.clamp_min(a, _EPS), 0.0, 1.0)
  pa = add(a1, scale(d1v, s))
  pb = add(a2, scale(d2v, t_cl))
  delta = sub(pb, pa)
  n, dist0 = normalize(delta)
  d = dist0 - s1[0] - s2[0]
  pos = add(pa, scale(n, s1[0] + 0.5 * d))
  return _single(d, pos, n)


def capsule_box(p1, m1, s1, p2, m2, s2):
  axis = col(m1, 2)
  e0 = sub(p1, scale(axis, s1[1]))
  e1 = add(p1, scale(axis, s1[1]))
  mid = _closest_on_segment(e0, e1, p2)
  ds, ps, ns = [], [], []
  for cand in (e0, e1, mid):
    d, pos, n = _sphere_box_core(cand, s1[0], p2, m2, s2)
    ds.append(d)
    ps.append(pos)
    ns.append(n)
  d3 = _stack(ds)                                        # (*B, 3, m)
  # Keep the 2 deepest of 3: gather-free masked-min selection.
  payloads = ([_stack([p[i] for p in ps]) for i in range(3)]
              + [_stack([n[i] for n in ns]) for i in range(3)])
  out_d, sel = masked_topk_select(d3, payloads, 2)
  out_pos = tuple(sel[0:3])
  out_n = tuple(sel[3:6])
  # Dedupe coincident points (double-force guard).
  same = (torch.abs(out_pos[0][..., 0, :] - out_pos[0][..., 1, :])
          + torch.abs(out_pos[1][..., 0, :] - out_pos[1][..., 1, :])
          + torch.abs(out_pos[2][..., 0, :] - out_pos[2][..., 1, :])) < 1e-7
  out_d = out_d.clone()
  out_d[..., 1, :] = torch.where(same, _BIG, out_d[..., 1, :])
  return out_d, out_pos, out_n


# ---------------------------------------------------------------------------
# Box-box: SAT + branch-free overlap-polygon candidates.
# ---------------------------------------------------------------------------

_EDGE_TOL = 1.05


def box_box(p1, m1, s1, p2, m2, s2):
  # r = m1^T m2 (box2 in box1 frame): r[3i+j] = sum_k m1[k,i] m2[k,j].
  r = tuple(
      m1[0 + i] * m2[0 + j] + m1[3 + i] * m2[3 + j] + m1[6 + i] * m2[6 + j]
      for i in range(3) for j in range(3))
  t = matTvec(m1, sub(p2, p1))
  absr = tuple(torch.abs(x) + _EPS for x in r)

  def R(i, j):
    return r[3 * i + j]

  def A(i, j):
    return absr[3 * i + j]

  # Face separations.
  sep1 = [torch.abs(t[i]) - (s1[i] + A(i, 0) * s2[0] + A(i, 1) * s2[1]
                             + A(i, 2) * s2[2]) for i in range(3)]
  t2 = tuple(R(0, j) * t[0] + R(1, j) * t[1] + R(2, j) * t[2]
             for j in range(3))
  sep2 = [torch.abs(t2[j]) - (s2[j] + A(0, j) * s1[0] + A(1, j) * s1[1]
                              + A(2, j) * s1[2]) for j in range(3)]
  face_seps = _stack(sep1 + sep2)                          # (*B, 6, m)
  best_face_sep = torch.amax(face_seps, dim=-2)
  best_face = torch.argmax(face_seps, dim=-2)

  # Edge separations.
  edge_sep_list = []
  edge_axis_list = []
  s1l = [s1[0], s1[1], s1[2]]
  s2l = [s2[0], s2[1], s2[2]]
  for i in range(3):
    for j in range(3):
      i1, i2 = (i + 1) % 3, (i + 2) % 3
      j1, j2 = (j + 1) % 3, (j + 2) % 3
      # axis = e_i x r_col_j in box1 frame.
      v = (R(0, j), R(1, j), R(2, j))
      zero = torch.zeros_like(v[0])
      if i == 0:
        ax = (zero, -v[2], v[1])
      elif i == 1:
        ax = (v[2], zero, -v[0])
      else:
        ax = (-v[1], v[0], zero)
      l = torch.sqrt(torch.clamp_min(ax[0] ** 2 + ax[1] ** 2 + ax[2] ** 2,
                                     _EPS * _EPS))
      proj1 = s1l[i1] * A(i2, j) + s1l[i2] * A(i1, j)
      proj2 = s2l[j1] * A(i, j2) + s2l[j2] * A(i, j1)
      sep = torch.abs(t[0] * ax[0] + t[1] * ax[1] + t[2] * ax[2]) - (
          proj1 + proj2)
      ok = l > 1e-6
      edge_sep_list.append(torch.where(ok, sep / l, -_BIG))
      edge_axis_list.append(tuple(a / l for a in ax))
  edge_seps = _stack(edge_sep_list)                        # (*B, 9, m)
  best_edge_sep = torch.amax(edge_seps, dim=-2)
  best_edge = torch.argmax(edge_seps, dim=-2)

  separated = torch.maximum(best_face_sep, best_edge_sep) > 0
  use_edge = best_edge_sep * _EDGE_TOL > best_face_sep

  # ---- face manifold -----------------------------------------------------
  ref_is_1 = best_face < 3
  axis_idx = torch.where(ref_is_1, best_face, best_face - 3)

  def sel_mat(c, ma, mb_):
    return tuple(torch.where(c, ma[i], mb_[i]) for i in range(9))

  m_ref = sel_mat(ref_is_1, m1, m2)
  m_inc = sel_mat(ref_is_1, m2, m1)
  s_ref = where_v3(ref_is_1, s1, s2)
  s_inc = where_v3(ref_is_1, s2, s1)
  p_ref = where_v3(ref_is_1, p1, p2)
  p_inc = where_v3(ref_is_1, p2, p1)

  def col_dyn(mm, idx):
    """Column idx (per lane) of mat tuple."""
    c0, c1, c2 = col(mm, 0), col(mm, 1), col(mm, 2)
    is0 = idx == 0
    is1 = idx == 1
    return tuple(torch.where(is0, c0[i], torch.where(is1, c1[i], c2[i]))
                 for i in range(3))

  def comp_dyn(v, idx):
    return torch.where(idx == 0, v[0], torch.where(idx == 1, v[1], v[2]))

  def nz_sign(x):
    s = _sign(x)
    return torch.where(s == 0, torch.ones_like(s), s)

  n_uns = col_dyn(m_ref, axis_idx)
  towards = nz_sign(dot(sub(p_inc, p_ref), n_uns))
  n_world = scale(n_uns, towards)

  dots_ = tuple(dot(col(m_inc, j), n_world) for j in range(3))
  absd = _stack([torch.abs(d) for d in dots_])
  inc_axis = torch.argmax(absd, dim=-2)
  inc_dot = comp_dyn(dots_, inc_axis)
  inc_sign = nz_sign(-_sign(inc_dot))

  e1_idx = (inc_axis + 1) % 3
  e2_idx = (inc_axis + 2) % 3
  inc_n = col_dyn(m_inc, inc_axis)
  inc_e1 = col_dyn(m_inc, e1_idx)
  inc_e2 = col_dyn(m_inc, e2_idx)
  s_inc_n = comp_dyn(s_inc, inc_axis)
  s_inc_1 = comp_dyn(s_inc, e1_idx)
  s_inc_2 = comp_dyn(s_inc, e2_idx)

  u_idx = (axis_idx + 1) % 3
  v_idx = (axis_idx + 2) % 3
  u_world = col_dyn(m_ref, u_idx)
  v_world = col_dyn(m_ref, v_idx)
  su = comp_dyn(s_ref, u_idx)
  sv = comp_dyn(s_ref, v_idx)
  s_axis = comp_dyn(s_ref, axis_idx)

  # Incident quad (4 verts) in ref 2D + heights.
  quad_u, quad_v, quad_h = [], [], []
  for c1_, c2_ in ((1, 1), (1, -1), (-1, -1), (-1, 1)):
    vert = add(p_inc, add(scale(inc_n, inc_sign * s_inc_n),
                          add(scale(inc_e1, c1_ * s_inc_1),
                              scale(inc_e2, c2_ * s_inc_2))))
    rel = sub(vert, p_ref)
    quad_u.append(dot(rel, u_world))
    quad_v.append(dot(rel, v_world))
    quad_h.append(dot(rel, n_world))
  qu = quad_u
  qv = quad_v
  qh = quad_h

  # Candidates: 4 quad verts, 4 rect corners, 16 edge intersections.
  cand_u = [qu[i] for i in range(4)]
  cand_v = [qv[i] for i in range(4)]
  cand_ok = [(torch.abs(qu[i]) <= su + _EPS) & (torch.abs(qv[i]) <= sv + _EPS)
             for i in range(4)]

  # Rect corners inside quad (consistent cross signs).
  eu = _stack([qu[(i + 1) % 4] - qu[i] for i in range(4)])  # (*B, 4, m)
  ev = _stack([qv[(i + 1) % 4] - qv[i] for i in range(4)])
  qu_s = _stack(qu)
  qv_s = _stack(qv)
  for cu_, cv_ in ((1, 1), (1, -1), (-1, -1), (-1, 1)):
    pu = cu_ * su
    pv = cv_ * sv
    crosses = eu * (_one(pv) - qv_s) - ev * (_one(pu) - qu_s)  # (*B, 4, m)
    inside = (torch.all(crosses >= -_EPS, dim=-2)
              | torch.all(crosses <= _EPS, dim=-2))
    cand_u.append(pu.expand(inside.shape))
    cand_v.append(pv.expand(inside.shape))
    cand_ok.append(inside)

  # Edge x rect-line intersections.
  for i in range(4):
    a_u, a_v = qu[i], qv[i]
    d_u, d_v = qu[(i + 1) % 4] - qu[i], qv[(i + 1) % 4] - qv[i]
    for axis, bound, other_bound, du_ in (
        (0, su, sv, d_u), (0, -su, sv, d_u),
        (1, sv, su, d_v), (1, -sv, su, d_v)):
      a_axis = a_u if axis == 0 else a_v
      big_d = torch.abs(du_) > _EPS
      denom = torch.where(big_d, du_, torch.full_like(du_, _EPS))
      tt = (bound - a_axis) / denom
      pu_ = a_u + tt * d_u
      pv_ = a_v + tt * d_v
      other = pv_ if axis == 0 else pu_
      ok = ((tt >= -_EPS) & (tt <= 1 + _EPS) & big_d
            & (torch.abs(other) <= other_bound + _EPS))
      cand_u.append(pu_)
      cand_v.append(pv_)
      cand_ok.append(ok)

  cu_all = _stack(cand_u)                                  # (*B, 24, m)
  cv_all = _stack(cand_v)
  ok_all = _stack(cand_ok)

  # Height interpolation on the incident plane.
  a00 = qu[1] - qu[0]
  a01 = qv[1] - qv[0]
  a10 = qu[2] - qu[0]
  a11 = qv[2] - qv[0]
  h0 = qh[1] - qh[0]
  h1 = qh[2] - qh[0]
  det = a00 * a11 - a01 * a10
  det = torch.where(torch.abs(det) > _EPS, det, torch.full_like(det, _EPS))
  gu = (a11 * h0 - a01 * h1) / det
  gv = (-a10 * h0 + a00 * h1) / det
  h_points = (_one(qh[0]) + (cu_all - _one(qu[0])) * _one(gu)
              + (cv_all - _one(qv[0])) * _one(gv))
  depth = h_points - _one(s_axis)
  dist_cand = torch.where(ok_all, depth, _BIG)             # (*B, 24, m)

  # Top-8 deepest by gather-free masked-min selection.
  dist_face, (pu8, pv8) = masked_topk_select(
      dist_cand, [cu_all, cv_all], 8)                      # (*B, 8, m) each

  # Dedupe coincident selections: slot i is a dup of any earlier valid
  # slot j < i.
  close = ((torch.abs(pu8.unsqueeze(-3) - pu8.unsqueeze(-2))
            + torch.abs(pv8.unsqueeze(-3) - pv8.unsqueeze(-2))) < 1e-7)
  earlier = torch.ones(8, 8, dtype=torch.bool,
                       device=pu8.device).tril(-1)[..., None]
  dup = torch.any(close & earlier & (dist_face.unsqueeze(-3) < _BIG * 0.5),
                  dim=-2)
  dist_face = torch.where(dup, _BIG, dist_face)

  mid_h = _one(s_axis) + 0.5 * torch.clamp_max(dist_face, 0.0)  # (*B, 8, m)
  pts = tuple(
      _one(p_ref[i]) + pu8 * _one(u_world[i]) + pv8 * _one(v_world[i])
      + mid_h * _one(n_world[i]) for i in range(3))
  n_face = tuple(torch.where(ref_is_1, n_world[i], -n_world[i])
                 for i in range(3))

  # ---- edge contact ------------------------------------------------------
  ax_sel = tuple(
      sum(torch.where(best_edge == k, edge_axis_list[k][i], 0.0)
          for k in range(9)) for i in range(3))
  axis_world = matvec(m1, ax_sel)
  sign_e = nz_sign(dot(sub(p2, p1), axis_world))
  n_edge = scale(axis_world, sign_e)
  ei = torch.div(best_edge, 3, rounding_mode='floor')
  ej = best_edge % 3
  n1l = matTvec(m1, n_edge)
  off1 = tuple(torch.where(ei == k, 0.0, _sign(n1l[k]) * s1l[k])
               for k in range(3))
  c1p = add(p1, matvec(m1, off1))
  d1d = col_dyn(m1, ei)
  n2l = matTvec(m2, n_edge)
  off2 = tuple(torch.where(ej == k, 0.0, -_sign(n2l[k]) * s2l[k])
               for k in range(3))
  c2p = add(p2, matvec(m2, off2))
  d2d = col_dyn(m2, ej)
  w0 = sub(c1p, c2p)
  aa = dot(d1d, d1d)
  bb = dot(d1d, d2d)
  cc = dot(d2d, d2d)
  dd_ = dot(d1d, w0)
  ee = dot(d2d, w0)
  den = aa * cc - bb * bb
  den_ok = torch.abs(den) > _EPS
  den_safe = torch.where(den_ok, den, torch.ones_like(den))
  zero = torch.zeros_like(den)
  sc = torch.where(den_ok, (bb * ee - cc * dd_) / den_safe, zero)
  tc = torch.where(den_ok, (aa * ee - bb * dd_) / den_safe, zero)
  s1e = comp_dyn(s1, ei)
  s2e = comp_dyn(s2, ej)
  sc = _clip(sc, -s1e, s1e)
  tc = _clip(tc, -s2e, s2e)
  pa = add(c1p, scale(d1d, sc))
  pb = add(c2p, scale(d2d, tc))
  pos_edge = scale(add(pa, pb), 0.5)

  # ---- combine -----------------------------------------------------------
  slot0 = (torch.arange(8, device=pu8.device) == 0)[:, None]
  best_sep = torch.maximum(best_face_sep, best_edge_sep)
  use_edge_k = _one(use_edge)
  dist = torch.where(use_edge_k,
                     torch.where(slot0, _one(best_edge_sep), _BIG),
                     dist_face)
  pos = tuple(torch.where(use_edge_k,
                          torch.where(slot0, _one(pos_edge[i]), 0.0),
                          pts[i]) for i in range(3))
  normal = tuple(torch.where(use_edge_k, _one(n_edge[i]),
                             _one(n_face[i])).expand(dist.shape)
                 for i in range(3))
  dist = torch.where(_one(separated),
                     torch.where(slot0, _one(best_sep), _BIG), dist)
  return dist, pos, normal


KERNELS = {
    (GeomType.PLANE, GeomType.SPHERE): (plane_sphere, 1),
    (GeomType.PLANE, GeomType.CAPSULE): (plane_capsule, 2),
    (GeomType.PLANE, GeomType.BOX): (plane_box, 8),
    (GeomType.SPHERE, GeomType.SPHERE): (sphere_sphere, 1),
    (GeomType.SPHERE, GeomType.CAPSULE): (sphere_capsule, 1),
    (GeomType.SPHERE, GeomType.BOX): (sphere_box, 1),
    (GeomType.CAPSULE, GeomType.CAPSULE): (capsule_capsule, 1),
    (GeomType.CAPSULE, GeomType.BOX): (capsule_box, 2),
    (GeomType.BOX, GeomType.BOX): (box_box, 8),
}
