from dexterity_tpu_torch.controllers.dls.dls import (
    DampedLeastSquaresMapper, DampedLeastSquaresParameters)
