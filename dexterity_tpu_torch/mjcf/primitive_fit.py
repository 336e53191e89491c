"""Fits collision primitives (box / capsule / sphere) to mesh vertex clouds
(port of dexterity_tpu/mjcf/primitive_fit.py, numpy only).

TPU-first design decision (SURVEY.md §7 "hard parts" #1): mesh-mesh convex
collision does not map well onto static-shape XLA kernels, so collision
meshes (e.g. the Shadow hand's decomposed convex pieces) are approximated at
import time with best-fit primitives.  Each fitted primitive minimizes the
symmetric surface error among the candidate shapes on the mesh's PCA frame.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from dexterity_tpu_torch.core.types import GeomType


@dataclasses.dataclass
class FittedPrimitive:
  type: GeomType
  pos: np.ndarray          # (3,) in mesh frame
  quat: np.ndarray         # (4,)
  size: np.ndarray         # (3,)
  fit_error: float         # mean abs surface distance of hull verts


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
  tr = np.trace(m)
  if tr > 0:
    s = np.sqrt(tr + 1.0) * 2
    q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
         (m[1, 0] - m[0, 1]) / s]
  else:
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k]) * 2
    q = [0.0, 0.0, 0.0, 0.0]
    q[0] = (m[k, j] - m[j, k]) / s
    q[i + 1] = 0.25 * s
    q[j + 1] = (m[j, i] + m[i, j]) / s
    q[k + 1] = (m[k, i] + m[i, k]) / s
  q = np.asarray(q)
  return q / np.linalg.norm(q)


def fit_primitive(verts: np.ndarray, scale=1.0) -> FittedPrimitive:
  """Fits the best of {box, capsule, sphere} to a vertex cloud."""
  verts = np.asarray(verts, dtype=np.float64) * scale
  center = verts.mean(axis=0)
  centered = verts - center
  cov = centered.T @ centered / max(len(verts), 1)
  evals, evecs = np.linalg.eigh(cov)
  # Sort axes by decreasing variance; right-handed frame.
  order = np.argsort(evals)[::-1]
  axes = evecs[:, order]
  if np.linalg.det(axes) < 0:
    axes[:, 2] *= -1
  local = centered @ axes                       # (n, 3) in PCA frame

  lo, hi = local.min(axis=0), local.max(axis=0)
  box_center_local = (lo + hi) / 2
  half = np.maximum((hi - lo) / 2, 1e-5)
  local_c = local - box_center_local
  pos = center + axes @ box_center_local
  quat = _mat_to_quat(axes)

  candidates = []

  # Box: error = distance of each vertex to the box surface.
  dbox = np.abs(np.abs(local_c) - half).min(axis=1)
  # Penalize verts well inside every face (hollow fit is fine for convex
  # pieces; min-face distance is the right surface metric).
  candidates.append(FittedPrimitive(GeomType.BOX, pos, quat,
                                    half, float(dbox.mean())))

  # Capsule along major axis: radius from transverse extent.
  r_cap = float(np.sqrt((local_c[:, 1] ** 2 + local_c[:, 2] ** 2).max()))
  r_cap = max(r_cap, 1e-5)
  hl = max(float(half[0] - r_cap), 1e-5)
  t = np.clip(local_c[:, 0], -hl, hl)
  d_axis = np.sqrt((local_c[:, 0] - t) ** 2 + local_c[:, 1] ** 2
                   + local_c[:, 2] ** 2)
  dcap = np.abs(d_axis - r_cap)
  # Capsule axis is z in MuJoCo convention: rotate PCA x-axis to z.
  axes_cap = axes[:, [1, 2, 0]]
  if np.linalg.det(axes_cap) < 0:
    axes_cap[:, 0] *= -1
  candidates.append(FittedPrimitive(
      GeomType.CAPSULE, pos, _mat_to_quat(axes_cap),
      np.array([r_cap, hl, 0.0]), float(dcap.mean())))

  # Sphere.
  r_sph = float(np.linalg.norm(local_c, axis=1).max())
  dsph = np.abs(np.linalg.norm(local_c, axis=1) - r_sph)
  candidates.append(FittedPrimitive(
      GeomType.SPHERE, pos, np.array([1.0, 0, 0, 0]),
      np.array([max(r_sph, 1e-5), 0.0, 0.0]), float(dsph.mean())))

  return min(candidates, key=lambda c: c.fit_error)


def fit_primitives(verts: np.ndarray, scale=1.0, max_parts: int = 4,
                   err_threshold: float = 1.5e-3) -> list:
  """Multi-primitive decomposition of a mesh vertex cloud.

  Fits one primitive; when its mean surface error exceeds `err_threshold`
  (meters) the cloud is split at the median of its major PCA axis and each
  half is fitted recursively, accepting the split only when it clearly
  reduces the vertex-weighted mean error.  Bounded by `max_parts`.
  Motivation: single-primitive fits leave ~3-5 mm error on the MPL
  palm/wrist meshes (VERDICT round-1 item 8); two to four parts bring the
  worst meshes into the ~1 mm class without giving up the static-shape
  primitive narrow phase.
  """
  verts = np.asarray(verts, dtype=np.float64) * scale
  fit = fit_primitive(verts)
  if fit.fit_error <= err_threshold or max_parts <= 1 or len(verts) < 32:
    return [fit]
  center = verts.mean(axis=0)
  centered = verts - center
  cov = centered.T @ centered / len(verts)
  _, evecs = np.linalg.eigh(cov)
  parts_a = max(1, max_parts // 2)
  parts_b = max(1, max_parts - parts_a)

  best = None
  # Candidate splits: median cut along each PCA axis.
  for ax in range(3):
    proj = centered @ evecs[:, 2 - ax]
    mask = proj <= np.median(proj)
    a, b = verts[mask], verts[~mask]
    if min(len(a), len(b)) < 16:
      continue
    fa = fit_primitives(a, 1.0, parts_a, err_threshold)
    fb = fit_primitives(b, 1.0, parts_b, err_threshold)
    err_a = sum(f.fit_error for f in fa) / len(fa)
    err_b = sum(f.fit_error for f in fb) / len(fb)
    split_err = (err_a * len(a) + err_b * len(b)) / (len(a) + len(b))
    if best is None or split_err < best[0]:
      best = (split_err, fa + fb)
  if best is not None and best[0] < 0.95 * fit.fit_error:
    return best[1]
  return [fit]
