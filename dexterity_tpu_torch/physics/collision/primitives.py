"""Vectorized primitive narrow phase over the static candidate pairs
(port of dexterity_tpu/physics/collision/primitives.py).

Candidate pairs are static (Model.pair_*).  Pairs are grouped by collision
type pair; each group runs one SoA kernel (collision/soa.py) over its pair
axis and fills a fixed block of contact slots.  Everything is static-shape:
inactive contacts report positive distance and are masked by the
constraint stage.  `collide_group_planes` returns the groups (the hot
substep's form); `collide_planes` / `collide_all` concatenate them into a
Contact (the refresh path).  The AoS pair tests of `_KERNELS` (and
`box_box`) are conformance forms only: no runtime path calls them, and
the tests hold them to the JAX package's and to the SoA kernels.

Layout: geom planes are (*B, ngeom) with any leading batch shape; with
B = () every function computes what its JAX per-env counterpart computes.
The TPU's one-hot MXU selections (`onehot_select`) are exact index gathers
here, and the midphase's top-m is an exact stable sort (first-index ties),
as in the JAX package's CPU path.

Conventions (MuJoCo-compatible): contact normal points from geom1 into
geom2; dist < 0 means penetration; frame rows are [normal, tangent1,
tangent2].
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from dexterity_tpu_torch.core import types as T
from dexterity_tpu_torch.core.types import Contact, Data, GeomType, Model
from dexterity_tpu_torch.core.types import collision_type, num_contact_points
from dexterity_tpu_torch.physics import math as tmath
from dexterity_tpu_torch.physics.collision import box_box, soa
from dexterity_tpu_torch.utils import profiling

_BIG = 1e10


def _tangent_frame(normal: torch.Tensor) -> torch.Tensor:
  """(..., 3) normal -> (..., 3, 3) frame rows [n, t1, t2]."""
  n = normal
  # The axis least aligned with n gives a stable tangent.
  ex = n.new_tensor([1.0, 0.0, 0.0])
  ey = n.new_tensor([0.0, 1.0, 0.0])
  ref = torch.where(n[..., 0:1].abs() < 0.5, ex, ey)
  t1 = tmath.cross(n, ref)
  t1 = t1 / torch.linalg.norm(t1, dim=-1, keepdim=True).clamp_min(1e-12)
  t2 = tmath.cross(n, t1)
  return torch.stack([n, t1, t2], dim=-2)


# ---------------------------------------------------------------------------
# AoS pair tests.  Each takes world-frame (pos (..., 3), mat (..., 3, 3),
# size (..., 3)) for both geoms and returns (dist (..., k), pos (..., k, 3),
# normal (..., k, 3)) with a fixed point count k.
# ---------------------------------------------------------------------------


def _dot(u, v):
  return (u * v).sum(-1)


def _norm(u):
  return torch.linalg.norm(u, dim=-1)


def _one_point(d, pos, n):
  return d[..., None], pos[..., None, :], n[..., None, :]


def _plane_sphere(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  d = _dot(p2 - p1, n) - s2[..., 0]
  pos = p2 - n * (s2[..., 0] + 0.5 * d)[..., None]
  return _one_point(d, pos, n)


def _plane_capsule(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  half = m2[..., :, 2] * s2[..., 1:2]
  ends = torch.stack([p2 + half, p2 - half], -2)              # (..., 2, 3)
  d = (_dot(ends, n[..., None, :]) - _dot(p1, n)[..., None]
       - s2[..., 0:1])
  pos = ends - n[..., None, :] * (s2[..., 0:1] + 0.5 * d)[..., None]
  return d, pos, n[..., None, :].expand(pos.shape)


_BOX_CORNERS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                for sz in (-1, 1)]


def _plane_box(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  # All 8 corners as candidates (sort-free; non-penetrating slots inactive).
  corners = p2.new_tensor(_BOX_CORNERS)
  pts = p2[..., None, :] + (corners * s2[..., None, :]) @ m2.transpose(-1,
                                                                       -2)
  d = _dot(pts, n[..., None, :]) - _dot(p1, n)[..., None]
  pos = pts - n[..., None, :] * (0.5 * d)[..., None]
  return d, pos, n[..., None, :].expand(pos.shape)


def _sphere_sphere(p1, m1, s1, p2, m2, s2):
  delta = p2 - p1
  dist = _norm(delta)
  n = delta / dist.clamp_min(1e-12)[..., None]
  d = dist - s1[..., 0] - s2[..., 0]
  pos = p1 + n * (s1[..., 0] + 0.5 * d)[..., None]
  return _one_point(d, pos, n)


def _closest_on_segment(a, b, p):
  ab = b - a
  t = torch.clamp(_dot(p - a, ab) / _dot(ab, ab).clamp_min(1e-12), 0, 1)
  return a + t[..., None] * ab


def _sphere_capsule(p1, m1, s1, p2, m2, s2):
  half = m2[..., :, 2] * s2[..., 1:2]
  c = _closest_on_segment(p2 - half, p2 + half, p1)
  delta = c - p1
  dist = _norm(delta)
  n = delta / dist.clamp_min(1e-12)[..., None]
  d = dist - s1[..., 0] - s2[..., 0]
  pos = p1 + n * (s1[..., 0] + 0.5 * d)[..., None]
  return _one_point(d, pos, n)


def _capsule_capsule(p1, m1, s1, p2, m2, s2):
  h1 = m1[..., :, 2] * s1[..., 1:2]
  h2 = m2[..., :, 2] * s2[..., 1:2]
  a1, b1 = p1 - h1, p1 + h1
  a2, b2 = p2 - h2, p2 + h2
  # Closest points between the segments (the standard clamped solve).
  d1, d2, r = b1 - a1, b2 - a2, a1 - a2
  a, e, f = _dot(d1, d1), _dot(d2, d2), _dot(d2, r)
  c, b = _dot(d1, r), _dot(d1, d2)
  denom = a * e - b * b
  s = torch.clamp(torch.where(denom > 1e-12, (b * f - c * e) / denom,
                              torch.zeros_like(denom)), 0, 1)
  t = torch.clamp((b * s + f) / e.clamp_min(1e-12), 0, 1)
  s = torch.clamp((b * t - c) / a.clamp_min(1e-12), 0, 1)
  pa = a1 + d1 * s[..., None]
  pb = a2 + d2 * t[..., None]
  delta = pb - pa
  dist = _norm(delta)
  n = delta / dist.clamp_min(1e-12)[..., None]
  d = dist - s1[..., 0] - s2[..., 0]
  pos = pa + n * (s1[..., 0] + 0.5 * d)[..., None]
  return _one_point(d, pos, n)


def _sphere_box(p1, m1, s1, p2, m2, s2):
  local = (m2.transpose(-1, -2) @ (p1 - p2)[..., None])[..., 0]
  clamped = torch.minimum(torch.maximum(local, -s2), s2)
  inside = (local.abs() < s2).all(-1)
  # Outside: the closest surface point; inside: out through the nearest
  # face.
  face_dist = s2 - local.abs()
  ax = torch.argmin(face_dist, -1)
  onehot = torch.nn.functional.one_hot(ax, 3).bool()
  sign = torch.sign(torch.gather(local, -1, ax[..., None]))
  sign = torch.where(sign == 0, torch.ones_like(sign), sign)
  inside_pt = torch.where(onehot, sign * s2, clamped)
  surf_local = torch.where(inside[..., None], inside_pt, clamped)
  surf = p2 + (m2 @ surf_local[..., None])[..., 0]
  delta = surf - p1
  dist_out = _norm(delta)
  n_out = delta / dist_out.clamp_min(1e-12)[..., None]
  n_in = -(m2 @ (onehot.to(p1.dtype) * sign)[..., None])[..., 0]
  n = torch.where(inside[..., None], n_in, n_out)
  face = torch.gather(face_dist, -1, ax[..., None])[..., 0]
  d = torch.where(inside, -face - s1[..., 0], dist_out - s1[..., 0])
  pos = p1 + n * (s1[..., 0] + 0.5 * d)[..., None]
  return _one_point(d, pos, n)


def _capsule_box(p1, m1, s1, p2, m2, s2):
  # Sphere-box tests at the capsule's two ends and at the segment point
  # closest to the box centre; the 2 deepest are kept.
  half = m1[..., :, 2] * s1[..., 1:2]
  ends = [p1 - half, p1 + half]
  cands = ends + [_closest_on_segment(ends[0], ends[1], p2)]
  res = [_sphere_box(c, m1, s1, p2, m2, s2) for c in cands]
  d = torch.cat([r[0] for r in res], -1)                       # (..., 3)
  p = torch.cat([r[1] for r in res], -2)                       # (..., 3, 3)
  n = torch.cat([r[2] for r in res], -2)
  idx = torch.argsort(d, dim=-1, stable=True)[..., :2]
  d_sel = torch.gather(d, -1, idx)
  idx3 = idx[..., None].expand(idx.shape + (3,))
  p_sel = torch.gather(p, -2, idx3)
  n_sel = torch.gather(n, -2, idx3)
  # Candidates can coincide (the segment's closest point at an end); a
  # duplicated point would double its contact force.
  dup = _norm(p_sel[..., 1, :] - p_sel[..., 0, :]) < 1e-7
  d_sel = torch.stack([d_sel[..., 0],
                       torch.where(dup, torch.full_like(d_sel[..., 1], _BIG),
                                   d_sel[..., 1])], -1)
  return d_sel, p_sel, n_sel


def _box_box(p1, m1, s1, p2, m2, s2):
  """SAT + reference-face clipping manifold (see box_box)."""
  return box_box.box_box(p1, m1, s1, p2, m2, s2)


_KERNELS = {
    (GeomType.PLANE, GeomType.SPHERE): (_plane_sphere, 1),
    (GeomType.PLANE, GeomType.CAPSULE): (_plane_capsule, 2),
    (GeomType.PLANE, GeomType.BOX): (_plane_box, 8),
    (GeomType.SPHERE, GeomType.SPHERE): (_sphere_sphere, 1),
    (GeomType.SPHERE, GeomType.CAPSULE): (_sphere_capsule, 1),
    (GeomType.SPHERE, GeomType.BOX): (_sphere_box, 1),
    (GeomType.CAPSULE, GeomType.CAPSULE): (_capsule_capsule, 1),
    (GeomType.CAPSULE, GeomType.BOX): (_capsule_box, 2),
    (GeomType.BOX, GeomType.BOX): (_box_box, 8),
}


def _host(t: torch.Tensor) -> np.ndarray:
  return t.detach().cpu().numpy()


def _pair_groups(model: Model):
  """Groups candidate pairs by ordered type pair; returns static tables
  with the midphase cap applied: each group occupies
  min(n_pairs, cap) * k rows starting at 'row'."""
  groups: Dict[Tuple[int, int], Dict[str, List[int]]] = {}
  for i in range(model.npair):
    g1, g2 = model.pair_geom1[i], model.pair_geom2[i]
    t1 = collision_type(model.geom_type[g1])
    t2 = collision_type(model.geom_type[g2])
    if t1 > t2:
      g1, g2 = g2, g1
      t1, t2 = t2, t1
    key = (GeomType(t1), GeomType(t2))
    grp = groups.setdefault(key, {'pair': [], 'g1': [], 'g2': []})
    grp['pair'].append(i)
    grp['g1'].append(g1)
    grp['g2'].append(g2)
  cap = model.opt.midphase_cap
  cap_plane = model.opt.midphase_cap_plane or cap
  row = 0
  for key in groups:
    grp = groups[key]
    n = len(grp['pair'])
    gcap = cap_plane if (cap and key[0] == GeomType.PLANE) else cap
    m = n if cap == 0 else min(n, gcap)
    if key not in soa.KERNELS:
      raise NotImplementedError(f'no collision kernel for {key[0]} vs '
                                f'{key[1]}')
    _, k = soa.KERNELS[key]
    grp['m'] = m
    grp['k'] = k
    grp['row'] = row
    row += m * k
  return groups, row


def pair_kernel_geoms(model: Model):
  """Static per-pair geom ids in KERNEL order (type1 <= type2)."""
  g1_out = np.zeros(model.npair, np.int64)
  g2_out = np.zeros(model.npair, np.int64)
  for i in range(model.npair):
    g1, g2 = model.pair_geom1[i], model.pair_geom2[i]
    if (collision_type(model.geom_type[g1])
        > collision_type(model.geom_type[g2])):
      g1, g2 = g2, g1
    g1_out[i] = g1
    g2_out[i] = g2
  return g1_out, g2_out


def collision_size(model: Model) -> np.ndarray:
  """Static per-geom sizes as seen by the narrow phase (cylinders collide
  as capsules whose half-length is shortened by the radius)."""
  size = np.array(_host(model.geom_size), dtype=np.float64)
  for g in range(model.ngeom):
    if model.geom_type[g] == int(GeomType.CYLINDER):
      size[g, 1] = max(size[g, 1] - size[g, 0], 1e-6)
  return size


def _bounding_radius(model: Model) -> np.ndarray:
  """Static bounding-sphere radius per geom (planes get 0)."""
  size = _host(model.geom_size)
  out = np.zeros(model.ngeom)
  for g in range(model.ngeom):
    t = model.geom_type[g]
    s = size[g]
    if t == int(GeomType.SPHERE):
      out[g] = s[0]
    elif t in (int(GeomType.CAPSULE), int(GeomType.CYLINDER)):
      out[g] = s[0] + s[1]
    elif t == int(GeomType.BOX):
      out[g] = float(np.linalg.norm(s))
    elif t == int(GeomType.ELLIPSOID):
      out[g] = float(np.max(s))
  return out


def _tangent_frame_soa(n):
  """Normal planes -> (t1, t2) plane triples (|nx| < 0.5 picks x else y
  as the reference axis)."""
  nx, ny, nz = n
  cond = torch.abs(nx) < 0.5
  refx = cond.to(nx.dtype)
  refy = 1.0 - refx
  refz = torch.zeros_like(nx)
  t1 = soa.cross(n, (refx, refy, refz))
  inv = 1.0 / torch.clamp_min(torch.sqrt(torch.clamp_min(soa.dot(t1, t1),
                                                         0.0)), 1e-12)
  t1 = soa.scale(t1, inv)
  t2 = soa.cross(n, t1)
  return t1, t2


def _pair_param_planes(model: Model, pair_idx: np.ndarray) -> np.ndarray:
  """Static (NPARAM, n) parameter table for candidate pairs `pair_idx`, in
  KERNEL geom order (margin, solref, solimp, friction, condim, body ids,
  invweight sum)."""
  pg1, pg2 = pair_kernel_geoms(model)
  gb = np.asarray(model.geom_bodyid)
  b1 = gb[pg1[pair_idx]]
  b2 = gb[pg2[pair_idx]]
  iw0 = _host(model.body_invweight0)
  out = np.zeros((T.NPARAM, len(pair_idx)))
  out[T.PARAM_MARGIN] = _host(model.pair_margin)[pair_idx]
  out[T.PARAM_SOLREF] = _host(model.pair_solref)[pair_idx].T
  out[T.PARAM_SOLIMP] = _host(model.pair_solimp)[pair_idx].T
  out[T.PARAM_FRICTION] = _host(model.pair_friction)[pair_idx].T
  out[T.PARAM_CONDIM] = np.asarray(model.pair_condim)[pair_idx]
  out[T.PARAM_BODY1] = b1
  out[T.PARAM_BODY2] = b2
  out[T.PARAM_IW] = iw0[b1, 0] + iw0[b2, 0]
  return out


def _group_tables(model: Model, dtype):
  """Per-group device constants: geom index tensors, sizes, radii, the
  (n, 8) static slot payload table [size1, size2, pair id, margin]."""
  def build():
    groups, total = _pair_groups(model)
    radius = _bounding_radius(model)
    size_np = collision_size(model)
    margin_np = _host(model.pair_margin).astype(np.float64)
    dev = model.device
    out = []
    for key, grp in groups.items():
      g1 = np.asarray(grp['g1'], np.int64)
      g2 = np.asarray(grp['g2'], np.int64)
      pair_np = np.asarray(grp['pair'], np.int64)

      def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=dev)

      stat = np.concatenate([size_np[g1].T, size_np[g2].T,
                             pair_np[None].astype(np.float64),
                             margin_np[pair_np][None]])          # (8, n)
      out.append(dict(
          key=key, m=grp['m'], k=grp['k'], n=len(g1),
          g1_np=g1, g2_np=g2,
          g1=torch.as_tensor(g1, device=dev),
          g2=torch.as_tensor(g2, device=dev),
          r1=f(radius[g1]), r2=f(radius[g2]),
          s1=tuple(f(size_np[g1, c]) for c in range(3)),
          s2=tuple(f(size_np[g2, c]) for c in range(3)),
          pair=torch.as_tensor(pair_np, device=dev),
          margin=f(margin_np[pair_np]),
          stat_t=f(stat.T)))                                     # (n, 8)
    return out, total
  return model.cached(('collision_group_tables', dtype), build)


def onehot_select(sel: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
  """Selects columns of `planes` (*B, p, n) at indices `sel` (*B, k) ->
  (*B, p, k); planes without the batch axes are shared by every batch
  entry.  The TPU's one-hot contraction (an exact copy of each selected
  column) as the index gather it computes."""
  bshape = sel.shape[:-1]
  idx = sel.unsqueeze(-2).expand(bshape + (planes.shape[-2], sel.shape[-1]))
  return torch.gather(planes.expand(bshape + planes.shape[-2:]), -1, idx)


def _midphase_select(tab, all_planes, dtype):
  """Top-m candidates of a capped group by conservative pair distance."""
  p1 = tuple(all_planes[r][..., tab['g1']] for r in range(3))
  p2 = tuple(all_planes[r][..., tab['g2']] for r in range(3))
  delta = soa.sub(p2, p1)
  if tab['key'][0] == GeomType.PLANE:
    nrm1 = tuple(all_planes[r][..., tab['g1']] for r in (5, 8, 11))
    score = soa.dot(delta, nrm1) - tab['r2']
  else:
    score = (torch.sqrt(torch.clamp_min(soa.dot(delta, delta), 0.0))
             - tab['r1'] - tab['r2'])
  # Exact top-m smallest scores, first index first among ties.
  order = torch.sort(score, dim=-1, stable=True).indices
  return order[..., :tab['m']]


def midphase_selinfo(model: Model, gpos, gmat, dtype):
  """Midphase slot selection, hoisted out of the substep loop.

  For each capped group, the top-m candidate indices `sel` (*B, m) and the
  static per-slot payload `stat` (*B, 8, m) (sizes of both geoms, pair id,
  margin) from the CURRENT geom frames.  Returns a list over groups (None
  for uncapped groups)."""
  with profiling.trace_annotation('collision.midphase'):
    tabs, _ = _group_tables(model, dtype)
    all_planes = list(gpos) + list(gmat)
    out = []
    for tab in tabs:
      if tab['m'] >= tab['n']:
        out.append(None)
        continue
      sel = _midphase_select(tab, all_planes, dtype)
      stat = tab['stat_t'][sel].transpose(-1, -2)          # (*B, 8, m)
      out.append(dict(sel=sel, stat=stat))
    return out


def collide_group_planes(model: Model, gpos, gmat, dtype, selinfo=None):
  """Narrow phase over candidate pairs, optionally midphase-capped.

  Args:
    gpos: 3-tuple of (*B, ngeom) world-position planes.
    gmat: row-major 9-tuple of (*B, ngeom) rotation planes.
    selinfo: optional midphase_selinfo output reused across substeps.

  Returns the per-kernel-group results, not concatenated: a list of dicts
  with keys dist/pos/frame/pair/margin, planes of shape (*B, k*m)
  (slot-major), in the fixed group order.
  """
  with profiling.trace_annotation('collision.narrowphase'):
    tabs, total_rows = _group_tables(model, dtype)
    all_planes = list(gpos) + list(gmat)
    bshape = torch.broadcast_shapes(*(p.shape[:-1] for p in all_planes))

    out = []
    for gi, tab in enumerate(tabs):
      m, k, n = tab['m'], tab['k'], tab['n']
      if m < n:
        if selinfo is not None:
          sel, stat = selinfo[gi]['sel'], selinfo[gi]['stat']
        else:
          sel = _midphase_select(tab, all_planes, dtype)
          stat = tab['stat_t'][sel].transpose(-1, -2)

        def side(gids_np, gids):
          uniq = np.unique(gids_np)
          if len(uniq) == 1:
            # A side that is one geom (the free prop, the floor) broadcasts
            # that geom's planes.
            gc = int(uniq[0])
            return tuple(p[..., gc:gc + 1].expand(bshape + (m,))
                         for p in all_planes)
          stack = torch.stack([p[..., gids] for p in all_planes], dim=-2)
          return tuple(onehot_select(sel, stack).unbind(-2))

        d1 = side(tab['g1_np'], tab['g1'])
        d2 = side(tab['g2_np'], tab['g2'])
        s1 = tuple(stat[..., c, :] for c in range(3))
        s2 = tuple(stat[..., 3 + c, :] for c in range(3))
        pid = torch.round(stat[..., 6, :]).to(torch.int64)
        mar = stat[..., 7, :]
      else:
        d1 = tuple(p[..., tab['g1']] for p in all_planes)
        d2 = tuple(p[..., tab['g2']] for p in all_planes)
        s1, s2 = tab['s1'], tab['s2']
        pid = tab['pair'].expand(bshape + (m,))
        mar = tab['margin'].expand(bshape + (m,))
      p1, m1_ = d1[0:3], d1[3:12]
      p2, m2_ = d2[0:3], d2[3:12]

      sfn, _ = soa.KERNELS[tab['key']]
      d, p, nrm = sfn(p1, m1_, s1, p2, m2_, s2)            # (*B, k, m) planes
      tt1, tt2 = _tangent_frame_soa(nrm)

      def flat(x):
        return x.expand(bshape + (k, m)).flatten(-2)

      out.append(dict(
          dist=flat(d),
          pos=tuple(flat(c) for c in p),
          frame=tuple(flat(c) for c in nrm + tt1 + tt2),
          pair=torch.cat([pid] * k, dim=-1),
          margin=torch.cat([mar] * k, dim=-1)))
    if out:
      assert sum(g['dist'].shape[-1] for g in out) == total_rows \
          == num_contact_points(model)
    return out


def collide_planes(model: Model, gpos, gmat, dtype) -> Contact:
  """The narrow phase's groups concatenated into a Contact (the refresh
  path): dist/pair/margin (*B, npoint), pos (*B, 3, npoint), frame
  (*B, 9, npoint).  With no candidate pairs, one unused slot."""
  out = collide_group_planes(model, gpos, gmat, dtype)
  if not out:
    bshape = torch.broadcast_shapes(*(p.shape[:-1] for p in gpos + gmat))
    kw = dict(dtype=dtype, device=gpos[0].device)
    return Contact(
        dist=torch.full(bshape + (1,), _BIG, **kw),
        pos=torch.zeros(bshape + (3, 1), **kw),
        frame=torch.eye(3, **kw).reshape(9, 1).expand(bshape + (9, 1)),
        pair=torch.full(bshape + (1,), -1, dtype=torch.int64,
                        device=gpos[0].device),
        margin=torch.zeros(bshape + (1,), **kw))

  def cat(key):
    return torch.cat([g[key] for g in out], -1)

  def cat_planes(key, n):
    return torch.stack([torch.cat([g[key][c] for g in out], -1)
                        for c in range(n)], -2)

  return Contact(dist=cat('dist'), pos=cat_planes('pos', 3),
                 frame=cat_planes('frame', 9), pair=cat('pair'),
                 margin=cat('margin'))


def collide_all(model: Model, data: Data) -> Data:
  """Narrow phase from the AoS geom frames of a forward pass (refresh
  path), for a Data with any leading batch shape."""
  gpos = tuple(data.geom_xpos[..., c] for c in range(3))
  gmat = tuple(data.geom_xmat[..., i, j] for i in range(3) for j in range(3))
  return data.replace(contact=collide_planes(model, gpos, gmat,
                                             data.qpos.dtype))
