"""A frozen copy of the program's plain path, the benchmark's reference.

Copied from the PyTorch package's modules that the reorient and juggle
environments, the batched environment and the sampling planner load,
with their imports rewritten to this package.  Its Cholesky solves are
the plain loops of `physics/linalg_plain.py`; it builds and launches no
kernel, and it compiles its models from its own copies of the hand
assets.  Nothing here imports the program: the benchmark judges the
program against this copy, which later changes to the program do not
touch.

TF32 is off for every float32 product, as in the program.
"""

import torch

from reference.dex import exception  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
