"""Quaternion / rotation / spatial-algebra primitives
(port of dexterity_tpu/physics/math.py).

AoS helpers act on the trailing axis of tensors with any leading batch
shape.  Plane helpers act on tuples of same-shape tensors: a quaternion is a
4-tuple of planes (w, x, y, z), a vector a 3-tuple, a rotation a row-major
9-tuple.  Quaternions use MuJoCo's (w, x, y, z) convention.
"""

from __future__ import annotations

import torch

from reference.dex.core import types


def quat_identity(dtype: torch.dtype = torch.float32,
                  device=None) -> torch.Tensor:
  """The identity quaternion (1, 0, 0, 0) on `device` (cuda unless
  given)."""
  return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                      device=types.resolve_device(device))


def _ones_like_w(q):
  return torch.eye(1, 4, dtype=q.dtype, device=q.device)[0]


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  """Normalizes to unit quaternion (identity when near zero)."""
  norm = torch.linalg.norm(q, dim=-1, keepdim=True)
  return torch.where(norm > eps, q / norm.clamp_min(eps), _ones_like_w(q))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Hamilton product a ⊗ b."""
  aw, ax, ay, az = a.unbind(-1)
  bw, bx, by, bz = b.unbind(-1)
  return torch.stack([
      aw * bw - ax * bx - ay * by - az * bz,
      aw * bx + ax * bw + ay * bz - az * by,
      aw * by - ax * bz + ay * bw + az * bx,
      aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
  return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
  """Inverse for unit quaternions (= conjugate)."""
  return quat_conj(q)


def cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Cross product over the last axis, broadcasting the leading ones
  (jnp.cross's contract)."""
  return torch.cross(*torch.broadcast_tensors(u, v), dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotates vector v by unit quaternion q (R(q) @ v)."""
  w = q[..., :1]
  u = q[..., 1:]
  u, v = torch.broadcast_tensors(u, v)
  c = torch.cross(u, v, dim=-1)
  return v + 2.0 * (w * c + torch.cross(u, c, dim=-1))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotates v by the inverse of q (R(q)^T @ v)."""
  return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Unit quaternion -> 3x3 rotation matrix."""
  rows = quat_to_mat_p(q.unbind(-1))
  return torch.stack(rows, dim=-1).unflatten(-1, (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
  """3x3 rotation matrix -> unit quaternion (branch-free Shepperd)."""
  m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
  m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
  m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
  tr = m00 + m11 + m22

  s0 = torch.sqrt((tr + 1.0).clamp_min(1e-12)) * 2.0
  c0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                    (m10 - m01) / s0], dim=-1)
  s1 = torch.sqrt((1.0 + m00 - m11 - m22).clamp_min(1e-12)) * 2.0
  c1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                    (m02 + m20) / s1], dim=-1)
  s2 = torch.sqrt((1.0 + m11 - m00 - m22).clamp_min(1e-12)) * 2.0
  c2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                    (m12 + m21) / s2], dim=-1)
  s3 = torch.sqrt((1.0 + m22 - m00 - m11).clamp_min(1e-12)) * 2.0
  c3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                    0.25 * s3], dim=-1)

  cond0 = (tr > 0.0)[..., None]
  cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
  cond2 = (m11 >= m22)[..., None]
  q = torch.where(cond0, c0, torch.where(cond1, c1, torch.where(cond2, c2,
                                                                 c3)))
  q = quat_normalize(q)
  return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor):
  """Unit axis + angle -> quaternion."""
  half = angle * 0.5
  s = torch.sin(half)
  return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def quat_to_axis_angle(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  """Unit quaternion -> rotation vector (axis * angle)."""
  q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
  w = q[..., 0].clamp(-1.0, 1.0)
  vec = q[..., 1:]
  sin_half = torch.linalg.norm(vec, dim=-1)
  angle = 2.0 * torch.atan2(sin_half, w)
  axis = vec / sin_half.clamp_min(eps)[..., None]
  small = sin_half < eps
  return torch.where(small[..., None], torch.zeros_like(vec),
                     axis * angle[..., None])


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
  """Integrates quaternion q by angular velocity omega over dt."""
  norm = torch.linalg.norm(omega, dim=-1)
  angle = norm * dt
  axis = omega / norm.clamp_min(1e-12)[..., None]
  dq = axis_angle_to_quat(axis, angle)
  return quat_normalize(quat_mul(q, dq))


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """Velocity (rotation vector) that takes qb to qa: log(qb^-1 ⊗ qa)."""
  return quat_to_axis_angle(quat_mul(quat_inv(qb), qa))


def pose_mul(pos_a, quat_a, pos_b, quat_b):
  """Composition of frames: world_T_a * a_T_b."""
  return pos_a + quat_rotate(quat_a, pos_b), quat_mul(quat_a, quat_b)


def transform_point(pos, quat, point):
  return pos + quat_rotate(quat, point)


def inertia_world(mass, diag_inertia: torch.Tensor,
                  ximat: torch.Tensor) -> torch.Tensor:
  """Rotates a principal-axis inertia into the world frame:
  (..., 3) moments, (..., 3, 3) frames -> (..., 3, 3)."""
  del mass
  d = diag_inertia[..., None, :] * ximat
  return torch.einsum('...ij,...kj->...ik', d, ximat)


def l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12):
  return x / (torch.linalg.norm(x, dim=axis, keepdim=True) + eps)


# ---------------------------------------------------------------------------
# Plane forms.
# ---------------------------------------------------------------------------


def quat_mul_p(a, b):
  """Hamilton product on quaternion planes."""
  aw, ax, ay, az = a
  bw, bx, by, bz = b
  return (aw * bw - ax * bx - ay * by - az * bz,
          aw * bx + ax * bw + ay * bz - az * by,
          aw * by - ax * bz + ay * bw + az * bx,
          aw * bz + ax * by - ay * bx + az * bw)


def quat_rotate_p(q, v):
  """Rotates vector planes v by unit quaternion planes q."""
  w, ux, uy, uz = q
  vx, vy, vz = v
  cx = uy * vz - uz * vy
  cy = uz * vx - ux * vz
  cz = ux * vy - uy * vx
  dx = uy * cz - uz * cy
  dy = uz * cx - ux * cz
  dz = ux * cy - uy * cx
  return (vx + 2.0 * (w * cx + dx),
          vy + 2.0 * (w * cy + dy),
          vz + 2.0 * (w * cz + dz))


def quat_to_mat_p(q):
  """Unit quaternion planes -> row-major rotation 9-tuple."""
  w, x, y, z = q
  return (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
          2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
          2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y))


def quat_normalize_p(q, eps: float = 1e-12):
  """Plane-form quat_normalize (identity when near zero)."""
  w, x, y, z = q
  n = torch.sqrt(w * w + x * x + y * y + z * z)
  big = n > eps
  inv = 1.0 / n.clamp_min(eps)
  return (torch.where(big, w * inv, 1.0), torch.where(big, x * inv, 0.0),
          torch.where(big, y * inv, 0.0), torch.where(big, z * inv, 0.0))


def cross_p(u, v):
  ux, uy, uz = u
  vx, vy, vz = v
  return (uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx)
