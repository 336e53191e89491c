"""Box-box narrow phase: SAT with reference-face clipping
(port of dexterity_tpu/physics/collision/box_box.py).

Separating-axis test over 6 face normals and 9 edge cross products; for a
face axis the incident face is clipped against the reference face's
rectangle (the overlap polygon's vertices enumerated branch-free), for an
edge axis the single closest-point contact is used.  The AoS form of
soa.box_box: the refresh path reaches soa.box_box through
primitives.collide_planes; this form is the pair test of
primitives._KERNELS.

Every argument carries any leading batch shape: positions and sizes
(..., 3), rotations (..., 3, 3).  Returns 8 contact slots (dist = +BIG for
unused ones).
"""

from __future__ import annotations

import torch

from reference.dex.physics import math as tmath

_BIG = 1e10
_EPS = 1e-10
# Prefer face axes over edge axes unless the edge separation is clearly
# larger (standard SAT tie-breaking; ODE uses 1.05 relative margin).
_EDGE_TOL = 1.05


def _dot(u, v):
  return (u * v).sum(-1)


def _mv(m, v):
  """m (..., 3, 3) @ v (..., 3)."""
  return (m @ v[..., None])[..., 0]


def _take(x, idx):
  """x (..., n) at idx (...,) -> (...,)."""
  return torch.gather(x, -1, idx[..., None])[..., 0]


def _sign1(x):
  """sign(x), with 1 at 0."""
  s = torch.sign(x)
  return torch.where(s == 0, torch.ones_like(s), s)


def _overlap_polygon_candidates(poly, su, sv):
  """Vertices of the intersection of the convex quad `poly` (..., 4, 2)
  with the rectangle |u| <= su, |v| <= sv, enumerated branch-free.

  Every vertex of the overlap polygon is one of: a quad vertex inside the
  rectangle, a rectangle corner inside the quad, or a quad-edge x
  rect-edge intersection.  Returns (cands (..., 24, 2), valid (..., 24)).
  """
  su_, sv_ = su[..., None], sv[..., None]
  # (1) Quad vertices inside the rectangle.
  in_rect = ((poly[..., 0].abs() <= su_ + _EPS)
             & (poly[..., 1].abs() <= sv_ + _EPS))

  # (2) Rectangle corners inside the quad (consistent cross-product sign).
  corners = torch.stack([torch.stack([su, sv], -1),
                         torch.stack([su, -sv], -1),
                         torch.stack([-su, -sv], -1),
                         torch.stack([-su, sv], -1)], -2)       # (..., 4, 2)
  b = torch.roll(poly, -1, dims=-2)
  d = b - poly                                                   # edges
  rel = corners[..., :, None, :] - poly[..., None, :, :]        # (.., 4c, 4e, 2)
  cross = (d[..., None, :, 0] * rel[..., 1]
           - d[..., None, :, 1] * rel[..., 0])
  in_quad = (cross >= -_EPS).all(-1) | (cross <= _EPS).all(-1)

  # (3) Quad-edge x rect-edge intersections (16 candidates).
  def axis_hits(axis, bound, other_bound):
    # Intersection of each quad edge with the line coord[axis] = bound.
    dax = d[..., axis]
    denom = torch.where(dax.abs() > _EPS, dax, torch.full_like(dax, _EPS))
    tt = (bound[..., None] - poly[..., axis]) / denom
    pt = poly + tt[..., None] * d
    ok = ((tt >= -_EPS) & (tt <= 1 + _EPS) & (dax.abs() > _EPS)
          & (pt[..., 1 - axis].abs() <= other_bound[..., None] + _EPS))
    return pt, ok

  pts, oks = [poly, corners], [in_rect, in_quad]
  for axis, bound, other in ((0, su, sv), (0, -su, sv),
                             (1, sv, su), (1, -sv, su)):
    pt, ok = axis_hits(axis, bound, other)
    pts.append(pt)
    oks.append(ok)
  return torch.cat(pts, -2), torch.cat(oks, -1)


def box_box(p1, m1, s1, p2, m2, s2):
  """Returns (dist (..., 8), pos (..., 8, 3), normal (..., 8, 3)); the
  normal points 1 -> 2."""
  dtype, dev = p1.dtype, p1.device
  eye = torch.eye(3, dtype=dtype, device=dev)
  m1t = m1.transpose(-1, -2)
  r = m1t @ m2                           # box2 orientation in box1 frame
  t = _mv(m1t, p2 - p1)                  # box2 centre in box1 frame
  absr = r.abs() + _EPS

  # Face axes of box1 and box2.
  sep1 = t.abs() - (s1 + _mv(absr, s2))                        # (..., 3)
  t2 = _mv(r.transpose(-1, -2), t)
  sep2 = t2.abs() - (s2 + _mv(absr.transpose(-1, -2), s1))

  # Edge cross axes a_i x b_j (box1 frame).
  def edge_sep(i, j):
    axis = tmath.cross(eye[i], r[..., :, j])
    norm = torch.linalg.norm(axis, dim=-1)
    proj1 = (s1[..., (i + 1) % 3] * absr[..., (i + 2) % 3, j]
             + s1[..., (i + 2) % 3] * absr[..., (i + 1) % 3, j])
    proj2 = (s2[..., (j + 1) % 3] * absr[..., i, (j + 2) % 3]
             + s2[..., (j + 2) % 3] * absr[..., i, (j + 1) % 3])
    sep = _dot(t, axis).abs() - (proj1 + proj2)
    # Degenerate (parallel) axes report no separation information.
    sep_n = torch.where(norm > 1e-6, sep / norm.clamp_min(1e-6),
                        torch.full_like(sep, -_BIG))
    return sep_n, axis / norm.clamp_min(1e-6)[..., None]

  edges = [edge_sep(i, j) for i in range(3) for j in range(3)]
  edge_seps = torch.stack([e[0] for e in edges], -1)           # (..., 9)
  edge_axes = torch.stack([e[1] for e in edges], -2)           # (..., 9, 3)

  face_seps = torch.cat([sep1, sep2], -1)                      # (..., 6)
  best_face = torch.argmax(face_seps, -1)
  best_face_sep = _take(face_seps, best_face)
  best_edge = torch.argmax(edge_seps, -1)
  best_edge_sep = _take(edge_seps, best_edge)

  separated = torch.maximum(best_face_sep, best_edge_sep) > 0
  use_edge = best_edge_sep * _EDGE_TOL > best_face_sep

  # ---- face-contact manifold ---------------------------------------------
  # Reference box = box1 if best_face < 3 else box2.
  ref_is_1 = best_face < 3
  axis_idx = torch.where(ref_is_1, best_face, best_face - 3)
  r1v, r1m = ref_is_1[..., None], ref_is_1[..., None, None]
  m_ref = torch.where(r1m, m1, m2)
  m_inc = torch.where(r1m, m2, m1)
  s_ref = torch.where(r1v, s1, s2)
  s_inc = torch.where(r1v, s2, s1)
  p_ref = torch.where(r1v, p1, p2)
  p_inc = torch.where(r1v, p2, p1)

  # Normal: the reference face's axis, oriented towards the incident box.
  n_world_unsigned = _mv(m_ref, eye[axis_idx])
  towards = _sign1(_dot(p_inc - p_ref, n_world_unsigned))
  n_world = n_world_unsigned * towards[..., None]               # ref -> inc

  # Incident face: the incident box's face most anti-parallel to n.
  dots = _mv(m_inc.transpose(-1, -2), n_world)
  inc_axis = torch.argmax(dots.abs(), -1)
  inc_sign = _sign1(-torch.sign(_take(dots, inc_axis)))

  # Incident face quad (4 vertices, world).
  e1_idx = (inc_axis + 1) % 3
  e2_idx = (inc_axis + 2) % 3
  inc_n = eye[inc_axis] * inc_sign[..., None]
  corners2d = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, -1.0],
                            [-1.0, 1.0]], dtype=dtype, device=dev)
  quad_local = (
      (inc_n * _take(s_inc, inc_axis)[..., None])[..., None, :]
      + corners2d[:, :1] * (eye[e1_idx] * _take(s_inc, e1_idx)[..., None]
                            )[..., None, :]
      + corners2d[:, 1:] * (eye[e2_idx] * _take(s_inc, e2_idx)[..., None]
                            )[..., None, :])                      # (..., 4, 3)
  quad_world = p_inc[..., None, :] + quad_local @ m_inc.transpose(-1, -2)

  # Reference-face plane frame: tangents u, v; the face at +s_ref[axis].
  u_idx = (axis_idx + 1) % 3
  v_idx = (axis_idx + 2) % 3
  u_world = _mv(m_ref, eye[u_idx])
  v_world = _mv(m_ref, eye[v_idx])
  rel = quad_world - p_ref[..., None, :]
  poly = torch.stack([_dot(rel, u_world[..., None, :]),
                      _dot(rel, v_world[..., None, :])], -1)  # (..., 4, 2)
  cands, valid = _overlap_polygon_candidates(poly, _take(s_ref, u_idx),
                                             _take(s_ref, v_idx))

  # Depths: height along the outward normal, interpolated on the incident
  # face plane: height = h0 + grad . (uv - uv0).
  heights = _dot(rel, n_world[..., None, :])                    # (..., 4)
  a_mat = torch.stack([poly[..., 1, :] - poly[..., 0, :],
                       poly[..., 2, :] - poly[..., 0, :]], -2)  # (..., 2, 2)
  h_vec = torch.stack([heights[..., 1] - heights[..., 0],
                       heights[..., 2] - heights[..., 0]], -1)
  a00, a01 = a_mat[..., 0, 0], a_mat[..., 0, 1]
  a10, a11 = a_mat[..., 1, 0], a_mat[..., 1, 1]
  det = a00 * a11 - a01 * a10
  det = torch.where(det.abs() > _EPS, det, torch.full_like(det, _EPS))
  inv = torch.stack([torch.stack([a11, -a01], -1),
                     torch.stack([-a10, a00], -1)], -2) / det[..., None, None]
  grad = _mv(inv, h_vec)                                        # d h / d uv
  h_points = heights[..., 0:1] + _dot(cands - poly[..., 0:1, :],
                                      grad[..., None, :])       # (..., 24)

  ref_face_h = _take(s_ref, axis_idx)
  depth = h_points - ref_face_h[..., None]                      # < 0: inside
  dist_cand = torch.where(valid, depth, torch.full_like(depth, _BIG))

  # Keep the 8 deepest candidates (first index first among ties, as
  # lax.top_k); drop duplicates (a polygon vertex can appear both as a
  # quad vertex and as an edge intersection).
  sel8 = torch.sort(dist_cand, dim=-1, stable=True).indices[..., :8]
  dist_face = torch.gather(dist_cand, -1, sel8)
  pts2d = torch.gather(cands, -2, sel8[..., None].expand(
      sel8.shape + (2,)))                                       # (..., 8, 2)
  dup = [torch.zeros_like(dist_face[..., 0], dtype=torch.bool)]
  for i in range(1, 8):
    close = torch.linalg.norm(pts2d[..., :i, :] - pts2d[..., i:i + 1, :],
                              dim=-1) < 1e-7
    dup.append((close & (dist_face[..., :i] < _BIG * 0.5)).any(-1))
  dist_face = torch.where(torch.stack(dup, -1),
                          torch.full_like(dist_face, _BIG), dist_face)

  pts_world = (p_ref[..., None, :]
               + pts2d[..., :1] * u_world[..., None, :]
               + pts2d[..., 1:] * v_world[..., None, :]
               + (ref_face_h[..., None] + 0.5 * dist_face.clamp_max(0.0)
                  )[..., None] * n_world[..., None, :])
  # The normal must point geom1 -> geom2.
  n_face_out = torch.where(r1v, n_world, -n_world)

  # ---- edge contact -------------------------------------------------------
  ei = torch.div(best_edge, 3, rounding_mode='floor')
  ej = best_edge % 3
  axis_e = _mv(m1, torch.gather(edge_axes, -2, best_edge[..., None, None]
                                .expand(best_edge.shape + (1, 3)))[..., 0, :])
  n_edge = axis_e * _sign1(_dot(p2 - p1, axis_e))[..., None]    # 1 -> 2
  # Supporting edge on box1: direction e_i; centre offset = support of the
  # other two axes along +n (box1 frame).
  k3 = torch.arange(3, device=dev)
  zero = torch.zeros_like(s1)
  off1 = torch.where(k3 == ei[..., None], zero,
                     torch.sign(_mv(m1t, n_edge)) * s1)
  c1 = p1 + _mv(m1, off1)
  d1 = _mv(m1, eye[ei])
  off2 = torch.where(k3 == ej[..., None], zero,
                     -torch.sign(_mv(m2.transpose(-1, -2), n_edge)) * s2)
  c2 = p2 + _mv(m2, off2)
  d2 = _mv(m2, eye[ej])
  # Closest points between the two (infinite) edge lines.
  w0 = c1 - c2
  a, b_, c = _dot(d1, d1), _dot(d1, d2), _dot(d2, d2)
  d_, e_ = _dot(d1, w0), _dot(d2, w0)
  den = a * c - b_ * b_
  ok = den.abs() > _EPS
  sc = torch.where(ok, (b_ * e_ - c * d_) / den, torch.zeros_like(den))
  tc = torch.where(ok, (a * e_ - b_ * d_) / den, torch.zeros_like(den))
  h1, h2 = _take(s1, ei), _take(s2, ej)
  sc = torch.minimum(torch.maximum(sc, -h1), h1)
  tc = torch.minimum(torch.maximum(tc, -h2), h2)
  pos_edge = 0.5 * ((c1 + sc[..., None] * d1) + (c2 + tc[..., None] * d2))

  # ---- combine ------------------------------------------------------------
  slot0 = torch.arange(8, device=dev) == 0
  big = torch.full_like(dist_face, _BIG)
  ue = use_edge[..., None]
  dist = torch.where(ue, torch.where(slot0, best_edge_sep[..., None], big),
                     dist_face)
  pos = torch.where(ue[..., None],
                    torch.where(slot0[:, None], pos_edge[..., None, :],
                                torch.zeros_like(pts_world)), pts_world)
  normal = torch.where(ue[..., None], n_edge[..., None, :],
                       n_face_out[..., None, :]).expand(pos.shape)
  # Fully separated pairs keep the best-axis distance in slot 0, so the
  # top-K scoring still sees how close the pair is.
  best_sep = torch.maximum(best_face_sep, best_edge_sep)
  dist = torch.where(separated[..., None],
                     torch.where(slot0, best_sep[..., None], big), dist)
  return dist, pos, normal
