"""Hand effector (port of dexterity_tpu/effectors/hand_effector.py).

Binds a hand's actuators with action prefix '{hand_name}_joint'.
"""

from __future__ import annotations

from reference.dex.effectors import mujoco_actuation


class HandEffector(mujoco_actuation.ActuatorEffector):

  def __init__(self, hand, hand_name: str, attach_prefix: str = ''):
    """Args:
      hand: a models.hands.DexterousHand.
      hand_name: name used for the action prefix.
      attach_prefix: the prefix under which the hand was attached into the
        task arena (actuator names in the compiled model carry it).
    """
    names = [attach_prefix + n for n in hand.actuator_names]
    super().__init__(actuator_names=names, prefix=f'{hand_name}_joint')
    self.hand = hand
