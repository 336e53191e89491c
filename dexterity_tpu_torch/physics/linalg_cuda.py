"""Batched small-matrix Cholesky solves: hand-written CUDA kernels for
Hopper (port of dexterity_tpu/physics/linalg_pallas.py).

Three kernels, one source (`csrc/cholesky.cu`), each beside its plain
PyTorch version:

  cholesky_solve_factor   <- linalg_pallas._solve_factor_kernel (K1)
  cholesky_resolve_const  <- linalg_pallas._resolve_kernel      (K2)
  cholesky_solve          <- linalg_pallas._kernel              (K3)

All take batch-leading (..., n, n) matrices and (..., n) right-hand sides.
A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel or the call raises.  The packed factor of K1 (consumed by K2) is:
strict lower triangle = L, diagonal = 1 / L_kk, upper triangle unspecified.
Every pivot is clamped as rsqrt(max(a_kk, 1e-12)), so a near-singular
matrix gives a finite result.

Bound on the card: at the planner's shapes (B = 1024, n = 30, float32) K1
moves 2·B·n²·4 bytes (~7.4 MB, ~2.2 us at 3.35 TB/s); K2 and K3 read about
half that.  Their ~n³/3 FMAs per matrix are far below the FP32 rate, so the
bound is memory, but the kernels are latency-bound along the n-step serial
pivot chain.  The design keeps each matrix in one warp's shared memory
(see the source's header) so a pivot costs a warp barrier, not a block
barrier.

The kernels are built with nvcc for sm_90a at first use, into
`build/dexterity_tpu_torch/` at the repository root, and loaded with
ctypes; the build is redone when the source changes.  No gradients are
defined here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parents[1] / 'csrc' / 'cholesky.cu'
_BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / \
    'dexterity_tpu_torch'

_MODE_SOLVE = 0
_MODE_SOLVE_FACTOR = 1
_MODE_RESOLVE = 2

# Shared memory one block may use on Hopper (227 KB).
_MAX_SMEM = 232448
_WARPS_PER_BLOCK = 4

# Launch counts per kernel wrapper: one added per kernel launch, nowhere
# else (the plain versions on CPU tensors do not count).
launches = {'cholesky_solve_factor': 0, 'cholesky_resolve_const': 0,
            'cholesky_solve': 0}

# Build record: library path, seconds spent in nvcc (0 when cached) and
# nvcc's output.
build_info = {}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
  for k in launches:
    launches[k] = 0


def _nvcc() -> str:
  for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def build() -> ctypes.CDLL:
  """Builds (if the source changed) and loads the kernel library."""
  global _lib
  with _lock:
    if _lib is not None:
      return _lib
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / f'libdex_cholesky_{digest}.so'
    t0 = time.perf_counter()
    log = ''
    if not so.exists():
      tmp = so.with_suffix(f'.{os.getpid()}.tmp')
      cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
             '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
             '-o', str(tmp), str(_SRC)]
      proc = subprocess.run(cmd, capture_output=True, text=True)
      log = proc.stdout + proc.stderr
      if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{log}')
      os.replace(tmp, so)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      log=log)
    lib = ctypes.CDLL(str(so))
    lib.dex_cholesky.restype = ctypes.c_int
    lib.dex_cholesky.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    _lib = lib
    return lib


def _warp_smem_bytes(n: int, elem_bytes: int) -> int:
  # Mirrors warp_smem_elems in the source: odd-stride matrix plus the rhs.
  # Were the two to differ, the launch would fail and the wrapper raise.
  return (n * (n | 1) + n) * elem_bytes


def _launch(mode: int, name: str, a: torch.Tensor, g: torch.Tensor,
            want_factor: bool = False):
  """Checks the operands and launches one kernel on the current stream."""
  if a.dtype not in (torch.float32, torch.float64):
    raise TypeError(f'{name}: dtype {a.dtype} is not float32/float64')
  if g.dtype != a.dtype or g.device != a.device:
    raise TypeError(f'{name}: matrix and rhs differ in dtype or device')
  n = a.shape[-1]
  if a.shape[-2] != n or g.shape[-1] != n or a.shape[:-2] != g.shape[:-1]:
    raise ValueError(f'{name}: shapes {tuple(a.shape)} / {tuple(g.shape)}')
  elem = a.element_size()
  per_warp = _warp_smem_bytes(n, elem)
  if per_warp > _MAX_SMEM:
    raise ValueError(f'{name}: n={n} needs {per_warp} B of shared memory '
                     f'per matrix (limit {_MAX_SMEM})')
  lib = build()
  wpb = max(1, min(_WARPS_PER_BLOCK, _MAX_SMEM // per_warp))
  batch_shape = a.shape[:-2]
  a2 = a.reshape(-1, n, n).contiguous()
  g2 = g.reshape(-1, n).contiguous()
  b = a2.shape[0]
  x = torch.empty_like(g2)
  fac = torch.empty_like(a2) if want_factor else None
  stream = torch.cuda.current_stream(a.device).cuda_stream
  with torch.cuda.device(a.device):
    err = lib.dex_cholesky(mode, elem, a2.data_ptr(), g2.data_ptr(),
                           x.data_ptr(),
                           fac.data_ptr() if fac is not None else None,
                           b, n, wpb, stream)
  if err != 0:
    raise RuntimeError(f'{name}: kernel launch failed (cudaError {err})')
  launches[name] += 1
  x = x.reshape(batch_shape + (n,))
  if want_factor:
    return x, fac.reshape(batch_shape + (n, n))
  return x


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
# Public wrappers (names mirror linalg_pallas)
# ---------------------------------------------------------------------------


def cholesky_solve_factor(h: torch.Tensor, g: torch.Tensor):
  """Solves H x = g and returns (x, packed factor) for
  cholesky_resolve_const (K1)."""
  _check_device('cholesky_solve_factor', h)
  if h.device.type == 'cuda':
    return _launch(_MODE_SOLVE_FACTOR, 'cholesky_solve_factor', h, g,
                   want_factor=True)
  return solve_factor_plain(h, g)


def cholesky_resolve_const(fac: torch.Tensor, g: torch.Tensor):
  """Solves H x = g given the packed factor of H (K2)."""
  _check_device('cholesky_resolve_const', fac)
  if fac.device.type == 'cuda':
    return _launch(_MODE_RESOLVE, 'cholesky_resolve_const', fac, g)
  return resolve_plain(fac, g)


def cholesky_solve(h: torch.Tensor, g: torch.Tensor):
  """Solves H x = g for SPD H, without emitting the factor (K3)."""
  _check_device('cholesky_solve', h)
  if h.device.type == 'cuda':
    return _launch(_MODE_SOLVE, 'cholesky_solve', h, g)
  return solve_plain(h, g)
