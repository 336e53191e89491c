"""Hand and prop observables (port of dexterity_tpu/models/observables.py;
reference: dexterity/models/hands/dexterous_hand.py:245-372).

Each observable is a function of (model, data) over any leading batch
shape; a HandObservables instance resolves its static index tables at
after_compile and produces the enabled subset as a dict, with
dm_control-style '{entity}/{name}' keys.  Vector observables are
flattened over their last axes, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from reference.dex.core.types import JointType, Model
from reference.dex.physics import kinematics
from reference.dex.physics import math as tmath


def _validate_spec(name: str, spec) -> None:
  """Rejects ObservableSpec features the environment does not realize.

  The reference's composer observables support ring-buffering, delays and
  corruptors; every reference preset uses buffer_size=1 / delay=0 /
  corruptor=None.  Accepting-and-ignoring other values would silently
  change semantics, so raise instead."""
  get = (spec.get if isinstance(spec, dict)
         else lambda k, d=None: getattr(spec, k, d))
  buffer_size = get('buffer_size', 1)
  delay = get('delay', 0)
  corruptor = get('corruptor', None)
  if buffer_size not in (None, 1):
    raise NotImplementedError(
        f'observable {name!r}: buffer_size={buffer_size} is not supported '
        '(only buffer_size=1); stack observations outside the environment')
  if delay not in (None, 0):
    raise NotImplementedError(
        f'observable {name!r}: delay={delay} is not supported')
  if corruptor is not None:
    raise NotImplementedError(
        f'observable {name!r}: corruptors are not supported; transform '
        'observations outside the environment')


def _enabled_names(all_names, options) -> Sequence[str]:
  names = []
  for name in all_names:
    spec = options.get(name)
    if spec is not None and (spec['enabled'] if isinstance(spec, dict)
                             else spec.enabled):
      names.append(name)
  return names


class HandObservables:
  """Observables for a hand attached under `prefix` in the task model."""

  ALL = ('joint_positions', 'joint_positions_sin_cos', 'joint_velocities',
         'joint_torques', 'fingertip_positions', 'fingertip_orientations',
         'fingertip_linear_velocities', 'fingertip_angular_velocities',
         'fingertip_positions_ego')

  def __init__(self, hand, prefix: str, options: Optional[dict] = None):
    self.hand = hand
    self.prefix = prefix
    # options: {observable_name: ObservableSpec-or-dict}; unlisted
    # observables are disabled.
    self.options = options or {}
    for name, spec in self.options.items():
      _validate_spec(name, spec)
    self._model = None

  def enabled_names(self) -> Sequence[str]:
    return _enabled_names(self.ALL, self.options)

  def after_compile(self, model: Model):
    if self._model is model:
      return
    jn = [self.prefix + n for n in self.hand.joint_names]
    jids = [model.jnt_names.index(n) for n in jn]
    self.qpos_adr = np.asarray([model.jnt_qposadr[j] for j in jids], np.int64)
    self.dof_adr = np.asarray([model.jnt_dofadr[j] for j in jids], np.int64)
    self.jnt_ids = np.asarray(jids, np.int64)
    self.site_ids = np.asarray(
        [model.site_names.index(self.prefix + n)
         for n in self.hand.fingertip_site_names], np.int64)
    self.site_body = np.asarray(
        [model.site_bodyid[s] for s in self.site_ids], np.int64)
    # Root body: first body of the attached hand subtree.
    root_name = self.prefix + self.hand.spec.worldbody.children[0].name
    self.root_body = model.body_names.index(root_name)
    self.body_ids = np.asarray(
        [i for i, n in enumerate(model.body_names)
         if n.startswith(self.prefix)], np.int64)
    self._model = model

  def _idx(self, model, name):
    return model.index(('hand_obs', self.prefix, name), getattr(self, name))

  # -- individual observables -------------------------------------------------

  def joint_positions(self, model, data):
    return data.qpos[..., self._idx(model, 'qpos_adr')]

  def joint_positions_sin_cos(self, model, data):
    qpos = data.qpos[..., self._idx(model, 'qpos_adr')]
    return torch.stack([torch.sin(qpos), torch.cos(qpos)], -1).flatten(-2)

  def joint_velocities(self, model, data):
    return data.qvel[..., self._idx(model, 'dof_adr')]

  def joint_torques(self, model, data):
    """Torque transmitted through each joint, projected on its axis:
    actuation + passive + applied + the dof-space constraint forces
    (qfrc_constraint_axis) minus the armature inertia torque, as the JAX
    package computes the reference's joint torque sensors."""
    tau = (data.qfrc_actuator + data.qfrc_passive + data.qfrc_applied
           + data.qfrc_constraint_axis - model.dof_armature * data.qacc)
    return tau[..., self._idx(model, 'dof_adr')]

  def fingertip_positions(self, model, data):
    return data.site_xpos[..., self._idx(model, 'site_ids'), :].flatten(-2)

  def fingertip_orientations(self, model, data):
    mats = data.site_xmat[..., self._idx(model, 'site_ids'), :, :]
    return tmath.mat_to_quat(mats).flatten(-2)

  def _site_vels(self, model, data):
    return kinematics.point_velocity(
        data, data.cvel[..., self._idx(model, 'site_body'), :],
        data.site_xpos[..., self._idx(model, 'site_ids'), :])

  def fingertip_linear_velocities(self, model, data):
    return self._site_vels(model, data)[0].flatten(-2)

  def fingertip_angular_velocities(self, model, data):
    return self._site_vels(model, data)[1].flatten(-2)

  def fingertip_positions_ego(self, model, data):
    """Fingertip positions in the hand root body frame (framepos sensors
    in the reference, dexterous_hand.py:327-350)."""
    root_pos = data.xpos[..., self.root_body, :]
    root_mat = tmath.quat_to_mat(data.xquat[..., self.root_body, :])
    rel = (data.site_xpos[..., self._idx(model, 'site_ids'), :]
           - root_pos[..., None, :])
    return torch.einsum('...ji,...sj->...si', root_mat, rel).flatten(-2)

  # -- collection -------------------------------------------------------------

  def as_dict(self, model, data) -> Dict[str, torch.Tensor]:
    self.after_compile(model)
    return {f'{self.hand.name}/{name}': getattr(self, name)(model, data)
            for name in self.enabled_names()}


class FreePropObservables:
  """Pose/velocity observables for a free prop (dm_control Primitive
  observables used by the reference's reorient.py:81-86)."""

  ALL = ('position', 'orientation', 'linear_velocity', 'angular_velocity')

  def __init__(self, prop, prefix: str, options: Optional[dict] = None):
    self.prop = prop
    self.prefix = prefix
    self.options = options or {}
    for name, spec in self.options.items():
      _validate_spec(name, spec)
    self._model = None

  def after_compile(self, model: Model):
    if self._model is model:
      return
    root_name = self.prefix + self.prop.spec.worldbody.children[0].name
    self.body_id = model.body_names.index(root_name)
    jid = model.body_jntadr[self.body_id]
    if model.jnt_type[jid] != int(JointType.FREE):
      raise ValueError(f'{root_name} has no free joint')
    self.qpos_adr = model.jnt_qposadr[jid]
    self.dof_adr = model.jnt_dofadr[jid]
    self._model = model

  def enabled_names(self) -> Sequence[str]:
    return _enabled_names(self.ALL, self.options)

  def position(self, model, data):
    return data.xpos[..., self.body_id, :]

  def orientation(self, model, data):
    return data.xquat[..., self.body_id, :]

  def linear_velocity(self, model, data):
    cvel = data.cvel[..., self.body_id, :]
    return cvel[..., 3:] + tmath.cross(cvel[..., :3],
                                       data.xpos[..., self.body_id, :])

  def angular_velocity(self, model, data):
    return data.cvel[..., self.body_id, :3]

  def as_dict(self, model, data) -> Dict[str, torch.Tensor]:
    self.after_compile(model)
    return {f'{self.prop.name}/{name}': getattr(self, name)(model, data)
            for name in self.enabled_names()}
