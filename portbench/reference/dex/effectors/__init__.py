from reference.dex.effectors.hand_effector import HandEffector
from reference.dex.effectors.mujoco_actuation import (
    ActuatorEffector, MujocoEffector)
