"""PyTorch/CUDA port of dexterity_tpu for NVIDIA Hopper (H100).

Module paths mirror `dexterity_tpu/` one to one, so each port module names
the JAX module it reproduces.  The port imports torch and numpy only: it
never imports jax or the JAX package.  Entry points place tensors on
`cuda` unless the caller passes `device='cpu'`, and raise when no card is
present and no device was given.

TF32 is disabled for every float32 matrix product and convolution: the
CRB / RNE / constraint contractions feed a Cholesky factorisation, and
TF32's ~1e-3 input rounding exceeds qM's smallest eigenvalues (the
fingertip inertias), which breaks positive-definiteness.
"""

import torch

from dexterity_tpu_torch import exception  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
