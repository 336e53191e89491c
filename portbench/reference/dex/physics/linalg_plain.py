"""The Cholesky solves of the reference, in plain PyTorch.

The same right-looking loop, clamp and packed layout (strict lower = L,
diagonal = 1/L_kk) as the program's plain versions, under the names the
physics calls, on whatever device and dtype the operands have: no kernel
is built or launched here.
"""

import torch


def factor_plain(h: torch.Tensor) -> torch.Tensor:
  """(..., n, n) SPD -> packed factor (strict lower = L, diag = 1/L_kk)."""
  a = h.clone()
  n = a.shape[-1]
  for k in range(n):
    inv = torch.rsqrt(torch.clamp_min(a[..., k, k], 1e-12))
    a[..., k, k] = inv
    if k + 1 < n:
      col = a[..., k + 1:, k] * inv[..., None]
      a[..., k + 1:, k + 1:] -= col[..., :, None] * col[..., None, :]
      a[..., k + 1:, k] = col
  return a


def resolve_plain(fac: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Forward and back substitution against a packed factor."""
  n = fac.shape[-1]
  y = g.clone()
  for k in range(n):
    yk = y[..., k] * fac[..., k, k]
    if k + 1 < n:
      y[..., k + 1:] -= fac[..., k + 1:, k] * yk[..., None]
    y[..., k] = yk
  x = torch.empty_like(y)
  for k in reversed(range(n)):
    xk = y[..., k] * fac[..., k, k]
    if k:
      y[..., :k] -= fac[..., k, :k] * xk[..., None]
    x[..., k] = xk
  return x


def cholesky_solve_factor(h, g):
  """Solves H x = g and returns (x, packed factor)."""
  fac = factor_plain(h)
  return resolve_plain(fac, g), fac


def cholesky_resolve_const(fac, g):
  return resolve_plain(fac, g)


def cholesky_factor(h):
  return factor_plain(h)


def cholesky_resolve(fac, g):
  return resolve_plain(fac, g)


def cholesky_solve(h, g):
  return resolve_plain(factor_plain(h), g)
