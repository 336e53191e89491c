"""Type aliases (port of dexterity_tpu/hints.py)."""

from typing import Tuple, Union

import numpy as np
import torch

from dexterity_tpu_torch.core.spec import BodySpec, GeomSpec, JointSpec, SiteSpec
from dexterity_tpu_torch.core.types import Data, Model  # noqa: F401

FloatArray = Union[np.ndarray, torch.Tensor]
RgbaColor = Tuple[float, float, float, float]
# Spec elements play the role of the reference's MjcfElement handles.
SpecElement = Union[BodySpec, JointSpec, GeomSpec, SiteSpec]
