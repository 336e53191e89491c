"""Batched small-matrix Cholesky kernels: hand-written CUDA kernels for
Hopper (port of dexterity_tpu/physics/linalg_pallas.py).

Four kernels in three sources (`csrc/cholesky_regs.cu`,
`csrc/cholesky_wide.cu`, `csrc/cholesky.cu`), each beside its plain
PyTorch version:

  cholesky_solve_factor   <- linalg_pallas._solve_factor_kernel (K1)
  cholesky_resolve_const  <- linalg_pallas._resolve_kernel      (K2)
  cholesky_resolve        <- linalg_pallas._resolve_kernel      (K2)
  cholesky_solve          <- linalg_pallas._kernel              (K3)
  cholesky_factor         <- linalg_pallas._factor_kernel       (K4)

All take batch-leading (..., n, n) matrices and (..., n) right-hand sides;
every leading axis is a batch axis.  A tensor on the CPU goes to the plain
version; a CUDA tensor goes to the kernel or the call raises.  The packed
factor of K1 and K4 (consumed by K2) is: strict lower triangle = L,
diagonal = 1 / L_kk, upper triangle unspecified.  Every pivot is clamped
as rsqrt(max(a_kk, 1e-12)), so a near-singular matrix gives a finite
result.

`cholesky_factor` / `cholesky_resolve` are the pair of linalg_pallas's
public names.  There the "factor" is backend-dependent (the packed Pallas
factor on a TPU, the matrix itself elsewhere); here it is the packed
factor on both devices.  What the two packages agree on is the pair's
solution.

Bound on the card: at the planner's shapes (B = 1024, n = 30, float32) K1
moves 2·B·n²·4 bytes (~7.4 MB, ~2.2 us at 3.35 TB/s), K4 the same less
the two vectors; K2 and K3 read about half that.  Their ~n³/3 FMAs per
matrix are far below the FP32 rate, so the bound is memory, but the
kernels are latency-bound along the n-step serial pivot chain.  At the
suite's (4096, 62, 62) K3's FMAs set the bound instead.  Three designs
(see the sources' headers):

  'registers'  `csrc/cholesky_regs.cu`: K1-K4 at n <= 32, one warp per
               matrix, a row per lane in registers, the pivot loop
               unrolled with no branch; the main path (n = 30, float32),
               the environment step (n = 30) and `cholesky_factor` on their
               Hessians run it.
  'wide'       `csrc/cholesky_wide.cu`: K1-K4 at 32 < n <= 64, two
               warps per matrix, a row per thread in registers, one
               64-thread named barrier per pivot (K1, K3, K4) or two per
               solve (K2, substitutions blocked by warp); the juggle
               environment's and the suite's K3 (n = 62) run it, and K2
               wherever a refactoring Newton solve meets the juggle model.
  'shared'     `csrc/cholesky.cu`: one warp per matrix, the matrix in
               shared memory, one __syncwarp() per pivot: every mode
               beyond n = 64 (no model of the repository reaches it), and
               the in-run yardstick at any n (`_launch(...,
               design='shared')`).

`_design(n, dtype, mode)` picks every kernel's design from the shape, type
and mode alone (every design has every mode, so today n and the type
decide); no switch overrides it on the public wrappers.
`_launch(..., design=...)` runs any design at the inputs it takes, so a
card run can time the shared design beside the one `_design` picks.

The kernels are built at first use by `cuda_build` (nvcc, sm_90a, ctypes).

Derivatives follow the JAX package's rules, forward (`jvp`) and reverse
(`backward`), each a `torch.autograd.Function` that serves the plain
version on the CPU and the kernel on the card alike:

  cholesky_solve_factor   linalg_pallas.py:242-259 (custom_jvp): the
                          packed factor is a constant preconditioner;
                          dx = K2(fac, dg), dH dropped, no derivative on
                          the factor (callers detach H, as the JAX package
                          stops its gradient)
  cholesky_resolve_const  :458-481 (custom_jvp): dx = K2(fac, dg), dfac
                          dropped
  cholesky_solve          :525-540 (custom_linear_solve, symmetric):
                          dx = K3(H, dg - dH x); cotangents gbar = K3(H,
                          xbar), Hbar = -gbar x^T
  cholesky_resolve,       no rule in the JAX package: a tangent or a
  cholesky_factor         gradient reaching them raises

So the tangents of K1 and K2 run through K2, K3's through K3 (the rules'
own entries `_rule_resolve` and `_rule_solve`), and the launch counts
include them.  Operands with no derivative skip the Function
(`Function.apply` costs ~50 us of host time per call, and the planner's
path is host-bound).  `_launch` refuses an operand that carries a
forward-mode tangent or requires grad: no launch drops a derivative.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd import forward_ad

from dexterity_tpu_torch.physics import cuda_build

_MODE_SOLVE = 0
_MODE_SOLVE_FACTOR = 1
_MODE_RESOLVE = 2
_MODE_FACTOR = 3

# Largest n of the register design: one row per lane.  (Its code with two
# rows per lane, n <= 64, spills K1 in both types; see cholesky_regs.cu.)
_REG_MAX_N = 32
# Largest n of the wide design (a row per thread over two warps).  Every
# design has every mode; the shared design has every n.
_WIDE_MAX_N = 64

# Shared memory one block may use on Hopper (227 KB).
_MAX_SMEM = 232448
# Matrices per block: a warp each, up to four as fit ('registers',
# 'shared'); two warps each, exactly two ('wide': kWideGroups in
# cholesky_wide.cu; ptxas reserves all 16 named barriers for its kernel,
# which caps an SM at 4 blocks).
_PER_BLOCK = {'registers': 4, 'shared': 4, 'wide': 2}

# Launch counts per kernel: one added per kernel launch, nowhere else (the
# plain versions on CPU tensors do not count).  K2 counts under
# 'cholesky_resolve_const' whichever wrapper launched it.
launches = {'cholesky_solve_factor': 0, 'cholesky_resolve_const': 0,
            'cholesky_solve': 0, 'cholesky_factor': 0}

# The C entry of each design, bound after the first build.
_fns: dict = {}


def reset_launches() -> None:
  for k in launches:
    launches[k] = 0


def build() -> dict:
  """Builds (if a source changed) and loads the three kernel libraries;
  later calls return their entry points without a lock (cuda_build holds
  one over the build).  'shared': csrc/cholesky.cu, 'registers':
  csrc/cholesky_regs.cu, 'wide': csrc/cholesky_wide.cu; the three take
  the same arguments."""
  if not _fns:
    fns = {'shared': cuda_build.library('cholesky').dex_cholesky,
           'registers': cuda_build.library('cholesky_regs').dex_cholesky_regs,
           'wide': cuda_build.library('cholesky_wide').dex_cholesky_wide}
    for fn in fns.values():
      fn.restype = ctypes.c_int
      fn.argtypes = [
          ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
          ctypes.c_int, ctypes.c_void_p]
    _fns.update(fns)
  return _fns


def _design(n: int, dtype: torch.dtype, mode: int) -> str:
  """The design kernel `mode` runs at (n, dtype): 'registers', 'wide' or
  'shared'."""
  if dtype in (torch.float32, torch.float64):
    if 1 <= n <= _REG_MAX_N:
      return 'registers'
    if _REG_MAX_N < n <= _WIDE_MAX_N:
      return 'wide'
  return 'shared'


def _matrix_smem_bytes(n: int, elem_bytes: int, design: str,
                       mode: int) -> int:
  # Mirrors regs_warp_smem_bytes (cholesky_regs.cu), wide_group_smem_bytes
  # (cholesky_wide.cu) and warp_smem_elems (cholesky.cu).  Were they to
  # differ, the launch would fail and the wrapper raise.
  if design == 'registers':
    cols = 32 * (32 + 16 // elem_bytes) * elem_bytes
    return 16 + cols + ((n * n + 32) * elem_bytes + 15) // 16 * 16
  if design == 'wide':
    cols = (0 if mode == _MODE_RESOLVE
            else 64 * (64 + 16 // elem_bytes) * elem_bytes)
    stage = (0 if mode == _MODE_SOLVE
             else ((n * n + 64) * elem_bytes + 15) // 16 * 16)
    return 16 + cols + 32 * elem_bytes + stage
  return (n * (n | 1) + n) * elem_bytes


def _carries_derivative(t) -> bool:
  """True if t holds a forward-mode tangent, or requires grad while
  autograd records."""
  if t is None:
    return False
  if t.requires_grad and torch.is_grad_enabled():
    return True
  return forward_ad.unpack_dual(t).tangent is not None


def _differentiating(*ts) -> bool:
  return any(_carries_derivative(t) for t in ts)


def _refuse_derivative(name: str, *ts) -> None:
  if _differentiating(*ts):
    raise RuntimeError(f'{name}: an operand carries a derivative, which '
                       'this function has no rule for')


def _launch(mode: int, name: str, a: torch.Tensor, g=None,
            want_factor: bool = False, design: str | None = None):
  """Checks the operands and launches one kernel on the current stream.
  Returns x, (x, factor) or, with no rhs, the factor alone.  `design`
  None takes `_design`; the public wrappers never pass it.  An operand
  with a derivative raises: the derivative rules above call this on
  plain tensors."""
  _refuse_derivative(name, a, g)
  if a.dtype not in (torch.float32, torch.float64):
    raise TypeError(f'{name}: dtype {a.dtype} is not float32/float64')
  if a.dim() < 2 or a.shape[-2] != a.shape[-1]:
    raise ValueError(f'{name}: shape {tuple(a.shape)} is not (..., n, n)')
  n = a.shape[-1]
  if g is not None:
    if g.dtype != a.dtype or g.device != a.device:
      raise TypeError(f'{name}: matrix and rhs differ in dtype or device')
    if g.shape[-1:] != (n,) or a.shape[:-2] != g.shape[:-1]:
      raise ValueError(f'{name}: shapes {tuple(a.shape)} / '
                       f'{tuple(g.shape)}')
  if design is None:
    design = _design(n, a.dtype, mode)
  elif design == 'registers' and not 1 <= n <= _REG_MAX_N:
    raise ValueError(f'{name}: no register design at n={n}, {a.dtype}')
  elif design == 'wide' and not 1 <= n <= _WIDE_MAX_N:
    raise ValueError(f'{name}: no wide design at n={n}')
  elem = a.element_size()
  per_matrix = _matrix_smem_bytes(n, elem, design, mode)
  per_block = min(_PER_BLOCK[design], _MAX_SMEM // per_matrix)
  if per_block < (_PER_BLOCK[design] if design == 'wide' else 1):
    raise ValueError(f'{name}: n={n} needs {per_matrix} B of shared memory '
                     f'per matrix (limit {_MAX_SMEM} a block)')
  fn = _fns.get(design) or build()[design]
  # Host work per call is what the host-bound path pays: one (B, n, n)
  # batch (the path's shape) is taken as it is, with no reshape in or out,
  # and contiguous() returns a dense operand itself, uncopied.
  flat = a.dim() == 3
  a2 = (a if flat else a.reshape(-1, n, n)).contiguous()
  g2 = None if g is None else (g if flat else g.reshape(-1, n)).contiguous()
  x = torch.empty_like(g2) if g is not None else None
  fac = torch.empty_like(a2) if want_factor else None
  err = cuda_build.launch(
      fn, a.device, mode, elem, a2.data_ptr(),
      None if g2 is None else g2.data_ptr(),
      None if x is None else x.data_ptr(),
      None if fac is None else fac.data_ptr(), a2.shape[0], n, per_block)
  if err != 0:
    raise RuntimeError(f'{name}: kernel launch failed (cudaError {err})')
  launches[name] += 1
  if not flat:
    x = None if x is None else x.reshape(a.shape[:-1])
    fac = None if fac is None else fac.reshape(a.shape)
  if x is None:
    return fac
  return (x, fac) if want_factor else x


def _check_device(name: str, t: torch.Tensor) -> None:
  if t.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'{name}: unsupported device {t.device}')


# ---------------------------------------------------------------------------
# Plain PyTorch versions (same right-looking loop, clamp and packed layout)
# ---------------------------------------------------------------------------


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


def solve_factor_plain(h, g):
  fac = factor_plain(h)
  return resolve_plain(fac, g), fac


def solve_plain(h, g):
  return resolve_plain(factor_plain(h), g)


# ---------------------------------------------------------------------------
# Derivative rules (linalg_pallas.py's custom_jvp / custom_linear_solve)
# ---------------------------------------------------------------------------


def _resolve(fac, g):
  """K2 on the card, its plain version on the CPU."""
  if fac.device.type == 'cuda':
    return _launch(_MODE_RESOLVE, 'cholesky_resolve_const', fac, g)
  return resolve_plain(fac, g)


def _solve(h, g):
  """K3 on the card, its plain version on the CPU."""
  if h.device.type == 'cuda':
    return _launch(_MODE_SOLVE, 'cholesky_solve', h, g)
  return solve_plain(h, g)


def _rule_resolve(fac, g):
  """K2 for the derivative rules' tangents and cotangents: one entry,
  so that their launches can be told from the primal ones."""
  return _resolve(fac, g)


def _rule_solve(h, g):
  """K3 for the derivative rules' tangents and cotangents."""
  return _solve(h, g)


class _SolveFactor(torch.autograd.Function):
  """K1: x and the packed factor.  dx = K2(fac, dg); dH and the factor
  carry nothing (linalg_pallas.py:253-259)."""

  @staticmethod
  def forward(h, g):
    if h.device.type == 'cuda':
      return _launch(_MODE_SOLVE_FACTOR, 'cholesky_solve_factor', h, g,
                     want_factor=True)
    return solve_factor_plain(h, g)

  @staticmethod
  def setup_context(ctx, inputs, output):
    fac = output[1]
    ctx.mark_non_differentiable(fac)
    ctx.save_for_forward(fac)
    ctx.save_for_backward(fac)

  @staticmethod
  def jvp(ctx, dh, dg):
    del dh
    fac, = ctx.saved_tensors
    return _rule_resolve(fac, dg), None

  @staticmethod
  def backward(ctx, gx, gfac):
    del gfac
    fac, = ctx.saved_tensors
    return None, _rule_resolve(fac, gx)


class _ResolveConst(torch.autograd.Function):
  """K2 under a constant preconditioner: dx = K2(fac, dg), dfac dropped
  (linalg_pallas.py:476-481)."""

  @staticmethod
  def forward(fac, g):
    return _resolve(fac, g)

  @staticmethod
  def setup_context(ctx, inputs, output):
    fac = inputs[0].detach()
    ctx.save_for_forward(fac)
    ctx.save_for_backward(fac)

  @staticmethod
  def jvp(ctx, dfac, dg):
    del dfac
    fac, = ctx.saved_tensors
    return _rule_resolve(fac, dg)

  @staticmethod
  def backward(ctx, gx):
    fac, = ctx.saved_tensors
    return None, _rule_resolve(fac, gx)


class _Solve(torch.autograd.Function):
  """K3 with implicit differentiation (lax.custom_linear_solve,
  symmetric; linalg_pallas.py:525-540): dx = K3(H, dg - dH x); gbar =
  K3(H, xbar), Hbar = -gbar x^T."""

  @staticmethod
  def forward(h, g):
    return _solve(h, g)

  @staticmethod
  def setup_context(ctx, inputs, output):
    h = inputs[0].detach()
    ctx.save_for_forward(h, output)
    ctx.save_for_backward(h, output)

  @staticmethod
  def jvp(ctx, dh, dg):
    h, x = ctx.saved_tensors
    return _rule_solve(h, dg - torch.einsum('...ij,...j->...i', dh, x))

  @staticmethod
  def backward(ctx, gx):
    h, x = ctx.saved_tensors
    gg = _rule_solve(h, gx)
    return -gg[..., :, None] * x[..., None, :], gg


# ---------------------------------------------------------------------------
# Public wrappers (names mirror linalg_pallas)
# ---------------------------------------------------------------------------


def cholesky_solve_factor(h: torch.Tensor, g: torch.Tensor):
  """Solves H x = g and returns (x, packed factor) for
  cholesky_resolve_const (K1)."""
  _check_device('cholesky_solve_factor', h)
  if _differentiating(h, g):
    return _SolveFactor.apply(h, g)
  return _SolveFactor.forward(h, g)


def cholesky_resolve_const(fac: torch.Tensor, g: torch.Tensor):
  """Solves H x = g given the packed factor of H (K2)."""
  _check_device('cholesky_resolve_const', fac)
  if _differentiating(fac, g):
    return _ResolveConst.apply(fac, g)
  return _ResolveConst.forward(fac, g)


def cholesky_factor(h: torch.Tensor) -> torch.Tensor:
  """(..., n, n) SPD -> packed factor (..., n, n) for cholesky_resolve
  (K4)."""
  _check_device('cholesky_factor', h)
  _refuse_derivative('cholesky_factor', h)
  if h.device.type == 'cuda':
    return _launch(_MODE_FACTOR, 'cholesky_factor', h, want_factor=True)
  return factor_plain(h)


def cholesky_resolve(fac: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Solves H x = g given fac = cholesky_factor(H): (..., n, n), (..., n)
  -> (..., n) (K2)."""
  _check_device('cholesky_resolve', fac)
  _refuse_derivative('cholesky_resolve', fac, g)
  return _resolve(fac, g)


def cholesky_solve(h: torch.Tensor, g: torch.Tensor):
  """Solves H x = g for SPD H, without emitting the factor (K3)."""
  _check_device('cholesky_solve', h)
  if _differentiating(h, g):
    return _Solve.apply(h, g)
  return _Solve.forward(h, g)
