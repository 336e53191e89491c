"""TF32 products for the control: the reference in float32 with every
matrix product's operands rounded to TF32's 10-bit mantissa (to nearest,
ties to even), as a TF32 tensor-core product rounds them.

Rounding the operands in a TorchFunctionMode makes every product TF32,
whatever cuBLAS would pick for a small inner size (it keeps some small
products in FP32 when TF32 is merely allowed), and works on the CPU too.
"""

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {
    torch.matmul, torch.mm, torch.bmm, torch.mv, torch.einsum,
    torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
    torch.Tensor.mm, torch.Tensor.bmm, torch.Tensor.mv,
    torch.nn.functional.linear,
}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
  """float32 x rounded to TF32 (other dtypes pass unchanged)."""
  if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
    return x
  i = x.contiguous().view(torch.int32)
  return ((i + 0xFFF + ((i >> 13) & 1)) & -8192).view(torch.float32)


class TF32Products(TorchFunctionMode):
  """Within the mode, every float32 matrix product takes TF32 operands."""

  def __torch_function__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    if func in _PRODUCTS:
      args = tuple(tf32_round(a) for a in args)
      kwargs = {k: tf32_round(v) for k, v in kwargs.items()}
    return func(*args, **kwargs)
