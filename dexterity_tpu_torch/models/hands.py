"""Dexterous hand entities (port of dexterity_tpu/models/hands.py).

Only Shadow Hand E is ported.  The JAX hand also joins its geoms' mesh
provenance with the packaged render meshes (`meshes.attach_mesh_assets`);
that supplies render-only data and changes no Model field, so the port
leaves it out.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from dexterity_tpu_torch.core import serialization

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'assets')

# Palm-upright pose shared by the Shadow-derived hands.
_PALM_UPRIGHT_POS = (0.0, 0.2, 0.1)
_PALM_UPRIGHT_QUAT = (0.0, 0.0, 0.707106781186, -0.707106781186)


class HandPose:
  def __init__(self, xpos, xquat):
    self.xpos = np.asarray(xpos, np.float64)
    self.xquat = np.asarray(xquat, np.float64) / np.linalg.norm(xquat)


class DexterousHand:
  """Base hand entity wrapping a ModelSpec."""

  asset: str = ''
  palm_upright_pose = HandPose(_PALM_UPRIGHT_POS, _PALM_UPRIGHT_QUAT)

  def __init__(self, name: Optional[str] = None):
    self.spec = serialization.load_spec(os.path.join(_ASSETS, self.asset))
    self.name = name or self.spec.name
    self.spec.name = self.name
    self._setup()
    self.joint_names = tuple(self.spec.joint_names())
    self.actuator_names = tuple(a.name for a in self.spec.actuators)

  def _setup(self):
    """Adds fingertip sites / model edits before compilation."""

  @property
  def fingertip_site_names(self) -> Tuple[str, ...]:
    raise NotImplementedError


class ShadowHandSeriesE(DexterousHand):
  """Shadow Dexterous Hand E: 24 joints / 20 actuators, tendon-coupled
  distal pairs."""

  asset = 'shadow_hand_e.json'

  def _setup(self):
    # Fingertip sites at the tip body origins.
    for tip in ('fftip', 'mftip', 'rftip', 'lftip', 'thtip'):
      body = self.spec.find_body(tip)
      body.add_site(f'{tip}_site', pos=np.zeros(3),
                    size=np.full(3, 0.001), rgba=(1.0, 0.0, 0.0, 1.0),
                    group=4)

  @property
  def fingertip_site_names(self) -> Tuple[str, ...]:
    return ('fftip_site', 'mftip_site', 'rftip_site', 'lftip_site',
            'thtip_site')
