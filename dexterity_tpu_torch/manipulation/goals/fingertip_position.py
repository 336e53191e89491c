"""Fingertip-position goals (port of
dexterity_tpu/manipulation/goals/fingertip_position.py).

Only `compensate_gravity` is ported: reorient's `initialize_episode`
needs it.  The `FingertipCartesianPosition` goal generator comes with the
reach task.
"""

from __future__ import annotations

import numpy as np


def compensate_gravity(model, data, body_ids: np.ndarray):
  """Sets xfrc_applied to cancel gravity on the given bodies, for data
  with any leading batch shape (reference:
  dexterity/utils/mujoco_utils.py:91-99)."""
  ids = model.index(('compensate_gravity', tuple(int(b) for b in body_ids)),
                    body_ids)
  forces = -model.body_mass[ids][:, None] * model.opt.gravity[None, :]
  xfrc = data.xfrc_applied.clone()
  xfrc[..., ids, :3] = forces.to(xfrc.dtype)
  return data.replace(xfrc_applied=xfrc)
