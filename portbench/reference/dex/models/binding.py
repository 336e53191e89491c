"""Static index binding of an attached hand into a compiled task model
(port of dexterity_tpu/models/binding.py).

Replaces dm_control's physics.bind(...): all index tables are resolved
once per compiled model, as numpy arrays.
"""

from __future__ import annotations

import numpy as np

from reference.dex.core.types import Model


class HandBinding:

  def __init__(self, hand, prefix: str):
    self.hand = hand
    self.prefix = prefix
    self._model = None

  def resolve(self, model: Model) -> 'HandBinding':
    if self._model is model:
      return self
    jn = [self.prefix + n for n in self.hand.joint_names]
    self.jnt_ids = np.asarray([model.jnt_names.index(n) for n in jn],
                              np.int32)
    self.qpos_adr = np.asarray(
        [model.jnt_qposadr[j] for j in self.jnt_ids], np.int32)
    self.dof_adr = np.asarray(
        [model.jnt_dofadr[j] for j in self.jnt_ids], np.int32)
    self.act_ids = np.asarray(
        [model.actuator_names.index(self.prefix + n)
         for n in self.hand.actuator_names], np.int32)
    self.site_ids = np.asarray(
        [model.site_names.index(self.prefix + n)
         for n in self.hand.fingertip_site_names], np.int32)
    self.body_ids = np.asarray(
        [i for i, n in enumerate(model.body_names)
         if n.startswith(self.prefix)], np.int32)
    self.geom_ids = np.asarray(
        [i for i, n in enumerate(model.geom_names)
         if n.startswith(self.prefix)], np.int32)
    self.jnt_range = model.jnt_range.detach().cpu().double().numpy()[
        self.jnt_ids]
    self._model = model
    return self
