from dexterity_tpu_torch.effectors.hand_effector import HandEffector
from dexterity_tpu_torch.effectors.mujoco_actuation import (
    ActuatorEffector, MujocoEffector)
