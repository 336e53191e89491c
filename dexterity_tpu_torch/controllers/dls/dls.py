"""Damped least-squares mapper (port of
dexterity_tpu/controllers/dls/dls.py; reference:
dexterity/controllers/dls/dls.py).

Stacks each object's 3 x nv translational Jacobian and solves
(JᵀJ + λI) q̇ = Jᵀv by Cholesky, as the JAX package's
`jax.scipy.linalg.solve(assume_a='pos')` does; with λ = 0 it takes the
minimum-norm least-squares solution through the pseudoinverse, whose
default cutoff (eps · max(m, n) · σ₁) is `jnp.linalg.lstsq`'s.
(`torch.linalg.lstsq` on CUDA has only the `gels` routine, which assumes
full rank: a site on a body no joint moves gives J a zero column.)  Any
leading batch shape: one solve per row.
"""

from __future__ import annotations

import dataclasses

import torch

from dexterity_tpu_torch.controllers import mapper
from dexterity_tpu_torch.core.types import ObjType
from dexterity_tpu_torch.physics import kinematics


@dataclasses.dataclass(frozen=True)
class DampedLeastSquaresParameters(mapper.Parameters):
  regularization_weight: float = 0.0

  def __post_init__(self):
    super().__post_init__()
    if self.regularization_weight < 0:
      raise ValueError(
          '`regularization_weight` must be non-negative, but was '
          f'{self.regularization_weight}.')


@dataclasses.dataclass(frozen=True)
class DampedLeastSquaresMapper(mapper.CartesianVelocitytoJointVelocityMapper):
  params: DampedLeastSquaresParameters

  def stacked_jacobian(self, data):
    """(..., 3k, nv) stacked translational Jacobians at the objects' points
    (site and geom origins, body frames), for Data after fwd_position."""
    model = self.params.model
    jacs = []
    for otype, oid in zip(self.params.object_types,
                          self.params.object_ids()):
      otype = ObjType(otype)
      if otype == ObjType.SITE:
        bodyid, point = model.site_bodyid[oid], data.site_xpos[..., oid, :]
      elif otype == ObjType.GEOM:
        bodyid, point = model.geom_bodyid[oid], data.geom_xpos[..., oid, :]
      else:
        bodyid, point = oid, data.xpos[..., oid, :]
      jacs.append(kinematics.jac_point(model, data, bodyid, point)[0])
    return torch.cat(jacs, dim=-2)

  def compute_joint_velocities(self, data, target_velocities,
                               nullspace_bias=None):
    """Args:
      data: Data after fwd_position, any leading batch shape.
      target_velocities: (..., k, 3) or (..., 3k) linear target velocities.

    Returns: (..., nv) joint velocities.
    """
    del nullspace_bias  # parity: unused by the reference mapper
    jac = self.stacked_jacobian(data)
    v = torch.as_tensor(target_velocities, dtype=jac.dtype,
                        device=jac.device).reshape(jac.shape[:-1])
    lam = self.params.regularization_weight
    jac_t = jac.transpose(-1, -2)
    if lam > 0:
      eye = torch.eye(jac.shape[-1], dtype=jac.dtype, device=jac.device)
      factor, info = torch.linalg.cholesky_ex(jac_t @ jac + lam * eye)
      qdot = torch.cholesky_solve((jac_t @ v[..., None]), factor)[..., 0]
      # A failed factorization gives NaN, as JAX's Cholesky does.
      return torch.where(info[..., None] == 0, qdot, torch.nan)
    return (torch.linalg.pinv(jac) @ v[..., None])[..., 0]
