"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

This file imports neither jax nor the JAX package, so on a machine with a
card and no jax it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dexterity_tpu_torch import manipulation
from dexterity_tpu_torch.physics import linalg_cuda as LC
from dexterity_tpu_torch.physics import tree_cuda


def _spd(seed, batch, n):
  rng = np.random.RandomState(seed)
  a = rng.randn(batch, n, n)
  return np.einsum('bij,bkj->bik', a, a) + 3 * np.eye(n), rng.randn(batch, n)


def _cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (run on the card)')


# Float32: the kernel and the plain version round differently along the
# same O(n) chain of a well-conditioned (cond ~ 10) matrix.
_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
        torch.float64: dict(rtol=1e-10, atol=1e-12)}


@pytest.mark.cuda
@pytest.mark.parametrize('n', [30, 80])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_kernels_match_plain_on_card(dtype, n):
  """Each kernel against its plain version on the same card inputs."""
  _cuda()
  h, g = _spd(7, 1024, n)
  hc = torch.as_tensor(h, dtype=dtype, device='cuda')
  gc = torch.as_tensor(g, dtype=dtype, device='cuda')
  tol = _TOL[dtype]
  LC.reset_launches()
  x, fac = LC.cholesky_solve_factor(hc, gc)
  x_ref, fac_ref = LC.solve_factor_plain(hc, gc)
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  torch.testing.assert_close(x, x_ref, **tol)
  torch.testing.assert_close(fac[..., low], fac_ref[..., low], **tol)
  torch.testing.assert_close(LC.cholesky_resolve_const(fac, gc),
                             LC.resolve_plain(fac, gc), **tol)
  torch.testing.assert_close(LC.cholesky_solve(hc, gc),
                             LC.solve_plain(hc, gc), **tol)
  torch.cuda.synchronize()
  assert LC.launches == {'cholesky_solve_factor': 1,
                         'cholesky_resolve_const': 1, 'cholesky_solve': 1,
                         'cholesky_factor': 0}


@pytest.mark.cuda
@pytest.mark.parametrize('n', [30, 80])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_factor_kernel_matches_plain_on_card(dtype, n):
  """K4 against the plain factor, and the K4 + K2 pair's solution."""
  _cuda()
  h, g = _spd(9, 1024, n)
  hc = torch.as_tensor(h, dtype=dtype, device='cuda')
  gc = torch.as_tensor(g, dtype=dtype, device='cuda')
  tol = _TOL[dtype]
  LC.reset_launches()
  fac = LC.cholesky_factor(hc)
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  torch.testing.assert_close(fac[..., low], LC.factor_plain(hc)[..., low],
                             **tol)
  x = LC.cholesky_resolve(fac, gc)
  torch.testing.assert_close(x, LC.solve_plain(hc, gc), **tol)
  torch.cuda.synchronize()
  assert LC.launches['cholesky_factor'] == 1
  assert LC.launches['cholesky_resolve_const'] == 1


@pytest.mark.cuda
def test_kernel_batch_shapes_and_odd_batch():
  """Leading batch dims fold into one launch; a batch that does not fill
  the last block is handled."""
  _cuda()
  h, g = _spd(8, 3 * 7, 12)
  hc = torch.as_tensor(h, device='cuda').float().reshape(3, 7, 12, 12)
  gc = torch.as_tensor(g, device='cuda').float().reshape(3, 7, 12)
  x = LC.cholesky_solve(hc, gc)
  assert x.shape == (3, 7, 12)
  torch.testing.assert_close(x, LC.solve_plain(hc, gc), **_TOL[torch.float32])


# The sizes that cover the designs of K1/K2 and their boundaries: a row
# per lane in registers (n <= 32), a row per thread over two warps
# (n <= 64) and over three (up to 80), the shared-memory design beyond.
_DESIGN_NS = [1, 17, 30, 31, 32, 33, 62, 64, 65, 80, 81, 96]


@pytest.mark.cuda
@pytest.mark.parametrize('n', _DESIGN_NS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_k1_k2_match_plain_at_design_boundaries(dtype, n):
  """K1 and K2, in the design `_design` picks, against their plain
  versions on (3, 7) leading batch dims (21 matrices: the last block of 4
  warps is not full).  K2 reads only the packed layout: garbage in the
  upper triangle gives an identical result."""
  _cuda()
  h, g = _spd(11, 21, n)
  hc = torch.as_tensor(h, dtype=dtype, device='cuda').reshape(3, 7, n, n)
  gc = torch.as_tensor(g, dtype=dtype, device='cuda').reshape(3, 7, n)
  tol = _TOL[dtype]
  LC.reset_launches()
  x, fac = LC.cholesky_solve_factor(hc, gc)
  x_ref, fac_ref = LC.solve_factor_plain(hc, gc)
  assert x.shape == (3, 7, n) and fac.shape == (3, 7, n, n)
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  torch.testing.assert_close(x, x_ref, **tol)
  torch.testing.assert_close(fac[..., low], fac_ref[..., low], **tol)
  x2 = LC.cholesky_resolve_const(fac, gc)
  torch.testing.assert_close(x2, LC.resolve_plain(fac, gc), **tol)
  upper = torch.triu(torch.full_like(fac, 1e6), 1)
  assert torch.equal(LC.cholesky_resolve_const(fac + upper, gc), x2)
  torch.cuda.synchronize()
  assert LC.launches == {'cholesky_solve_factor': 1,
                         'cholesky_resolve_const': 2, 'cholesky_solve': 0,
                         'cholesky_factor': 0}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_register_and_shared_designs_agree(dtype):
  """At the main path's shape the register design and the shared-memory
  design (the in-run yardstick) give the same solutions and factors."""
  _cuda()
  n = 30
  h, g = _spd(12, 1024, n)
  hc = torch.as_tensor(h, dtype=dtype, device='cuda')
  gc = torch.as_tensor(g, dtype=dtype, device='cuda')
  tol = _TOL[dtype]
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  out = {}
  for design in ('registers', 'shared'):
    x, fac = LC._launch(LC._MODE_SOLVE_FACTOR, 'cholesky_solve_factor', hc,
                        gc, want_factor=True, design=design)
    x2 = LC._launch(LC._MODE_RESOLVE, 'cholesky_resolve_const', fac, gc,
                    design=design)
    out[design] = (x, fac[:, low], x2)
  for got, want in zip(out['registers'], out['shared']):
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize('n,dtype', [(30, torch.float32),
                                     (33, torch.float32),
                                     (80, torch.float32),
                                     (32, torch.float64),
                                     (33, torch.float64),
                                     (80, torch.float64),
                                     (96, torch.float32)])
def test_design_picks_the_kernel_that_runs(n, dtype):
  """The kernel the card runs for K1, K2, K3 and K4 is the one `_design`
  names; above n = 64 the wide design's kernels are its 80-row
  instances, K2's and K3's too."""
  _cuda()
  from torch.profiler import ProfilerActivity, profile
  h, g = _spd(13, 8, n)
  hc = torch.as_tensor(h, dtype=dtype, device='cuda')
  gc = torch.as_tensor(g, dtype=dtype, device='cuda')
  want = {mode: LC._design(n, dtype, mode)
          for mode in (LC._MODE_SOLVE_FACTOR, LC._MODE_RESOLVE,
                       LC._MODE_SOLVE, LC._MODE_FACTOR)}
  assert want == {m: 'registers' if n <= 32 else
                  'wide' if n <= 80 else 'shared' for m in want}
  # A profiling pass has come back from the card without a kernel in it
  # (chip_smoke.py's _device_profile retries too): up to three passes.
  for _ in range(3):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      _, fac = LC.cholesky_solve_factor(hc, gc)
      LC.cholesky_resolve_const(fac, gc)
      LC.cholesky_solve(hc, gc)
      LC.cholesky_factor(hc)
      torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if 'cholesky' in e.key]
    if len(names) == 4:
      break
  assert len(names) == 4, names
  # Kernel names by design: cholesky_regs_*, cholesky_wide_*,
  # cholesky_kernel<T, MODE>.
  tag = {'registers': 'cholesky_regs', 'wide': 'cholesky_wide',
         'shared': 'cholesky_kernel'}
  ran = sorted(d for name in names for d, t in tag.items() if t in name)
  assert ran == sorted(want.values()), names
  # The layout's template arguments, demangled or mangled, of every wide
  # kernel (cholesky_wide_solve_factor and cholesky_wide_resolve).
  rows, warps = (80, 3) if n > 64 else (64, 2)
  wide = [name for name in names if 'cholesky_wide_' in name]
  assert len(wide) == sum(d == 'wide' for d in want.values()), names
  assert all(f', {rows}, {warps}' in name or f'Li{rows}ELi{warps}E' in name
             for name in wide), names


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 17, 30, 31, 32, 33, 62])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_k3_matches_plain_at_design_boundaries(dtype, n):
  """K3 (cholesky_solve), in the design `_design` picks, against its plain
  version on (3, 7) leading batch dims (the last block of 4 warps is not
  full)."""
  _cuda()
  h, g = _spd(14, 21, n)
  hc = torch.as_tensor(h, dtype=dtype, device='cuda').reshape(3, 7, n, n)
  gc = torch.as_tensor(g, dtype=dtype, device='cuda').reshape(3, 7, n)
  LC.reset_launches()
  x = LC.cholesky_solve(hc, gc)
  assert x.shape == (3, 7, n)
  torch.testing.assert_close(x, LC.solve_plain(hc, gc), **_TOL[dtype])
  torch.cuda.synchronize()
  assert LC.launches['cholesky_solve'] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_k3_register_and_shared_designs_agree(dtype):
  """At the environment step's shape K3's register design and the
  shared-memory design (the in-run yardstick) give the same solutions."""
  _cuda()
  n = 30
  h, g = _spd(15, 256, n)
  hc = torch.as_tensor(h, dtype=dtype, device='cuda')
  gc = torch.as_tensor(g, dtype=dtype, device='cuda')
  x = {d: LC._launch(LC._MODE_SOLVE, 'cholesky_solve', hc, gc, design=d)
       for d in ('registers', 'shared')}
  torch.testing.assert_close(x['registers'], x['shared'], **_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 17, 30, 31, 32, 33, 62])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_k4_matches_plain_at_design_boundaries(dtype, n):
  """K4 (cholesky_factor), in the design `_design` picks, against the
  plain factor on the lower triangle, on (3, 7) leading batch dims (the
  last block of 4 warps is not full)."""
  _cuda()
  h, _ = _spd(17, 21, n)
  hc = torch.as_tensor(h, dtype=dtype, device='cuda').reshape(3, 7, n, n)
  LC.reset_launches()
  fac = LC.cholesky_factor(hc)
  assert fac.shape == (3, 7, n, n)
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  torch.testing.assert_close(fac[..., low], LC.factor_plain(hc)[..., low],
                             **_TOL[dtype])
  torch.cuda.synchronize()
  assert LC.launches['cholesky_factor'] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_k4_register_and_shared_designs_agree(dtype):
  """At the entry point's shape K4's register design and the
  shared-memory design (the in-run yardstick) give the same factor."""
  _cuda()
  n = 30
  h, _ = _spd(18, 1024, n)
  hc = torch.as_tensor(h, dtype=dtype, device='cuda')
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  fac = {d: LC._launch(LC._MODE_FACTOR, 'cholesky_factor', hc,
                       want_factor=True, design=d)[:, low]
         for d in ('registers', 'shared')}
  torch.testing.assert_close(fac['registers'], fac['shared'], **_TOL[dtype])


# The wide design's sizes (32 < n <= 64 over two warps, up to 80 over
# three) and the first beyond each layout, at one matrix, a block that is
# not full, and the suite's batch.
_WIDE_NS = [33, 48, 62, 63, 64, 65, 72, 80, 81]


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1, 37, 4096])
@pytest.mark.parametrize('n', _WIDE_NS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_k1_k3_match_plain_at_wide_sizes(dtype, n, b):
  """K1 (x and the packed factor's lower triangle) and K3, in the design
  `_design` picks (wide up to 80, shared beyond), against their plain
  versions on the same card inputs."""
  _cuda()
  h, g = _spd(19 + n, b, n)
  hc = torch.as_tensor(h, dtype=dtype, device='cuda')
  gc = torch.as_tensor(g, dtype=dtype, device='cuda')
  tol = _TOL[dtype]
  for mode in (LC._MODE_SOLVE, LC._MODE_SOLVE_FACTOR):
    assert LC._design(n, dtype, mode) == ('wide' if n <= 80 else 'shared')
  LC.reset_launches()
  x, fac = LC.cholesky_solve_factor(hc, gc)
  x3 = LC.cholesky_solve(hc, gc)
  x_ref, fac_ref = LC.solve_factor_plain(hc, gc)
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  torch.testing.assert_close(x, x_ref, **tol)
  torch.testing.assert_close(fac[..., low], fac_ref[..., low], **tol)
  torch.testing.assert_close(x3, x_ref, **tol)
  torch.cuda.synchronize()
  assert LC.launches == {'cholesky_solve_factor': 1,
                         'cholesky_resolve_const': 0, 'cholesky_solve': 1,
                         'cholesky_factor': 0}


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1, 37, 4096])
@pytest.mark.parametrize('n', _WIDE_NS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_k2_k4_match_plain_at_wide_sizes(dtype, n, b):
  """K4 (the packed factor's lower triangle) and K2 (on the plain
  factor, and the K4 + K2 pair), in the design `_design` picks (wide up
  to 80, shared beyond), against their plain versions on the same card
  inputs; K2 reads only the packed layout."""
  _cuda()
  h, g = _spd(29 + n, b, n)
  hc = torch.as_tensor(h, dtype=dtype, device='cuda')
  gc = torch.as_tensor(g, dtype=dtype, device='cuda')
  tol = _TOL[dtype]
  for mode in (LC._MODE_RESOLVE, LC._MODE_FACTOR):
    assert LC._design(n, dtype, mode) == ('wide' if n <= 80 else 'shared')
  LC.reset_launches()
  fac = LC.cholesky_factor(hc)
  fac_ref = LC.factor_plain(hc)
  x2 = LC.cholesky_resolve_const(fac_ref, gc)
  x42 = LC.cholesky_resolve(fac, gc)
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  torch.testing.assert_close(fac[..., low], fac_ref[..., low], **tol)
  torch.testing.assert_close(x2, LC.resolve_plain(fac_ref, gc), **tol)
  torch.testing.assert_close(x42, LC.solve_plain(hc, gc), **tol)
  upper = torch.triu(torch.full_like(fac_ref, 1e6), 1)
  assert torch.equal(LC.cholesky_resolve_const(fac_ref + upper, gc), x2)
  torch.cuda.synchronize()
  assert LC.launches == {'cholesky_solve_factor': 0,
                         'cholesky_resolve_const': 3, 'cholesky_solve': 0,
                         'cholesky_factor': 1}


def _cond_tol(h, x_ref, eps):
  """100 cond eps of the solution's scale: two backward-stable Choleskys
  may part by ~cond eps."""
  ev = torch.linalg.eigvalsh(h.double())
  cond = (ev[..., -1] / ev[..., 0]).max().item()
  return 100 * cond * eps * x_ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize('n', [62, 80])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_wide_and_shared_designs_agree(dtype, n):
  """At juggle's n = 62 and at n = 80 (the 80-row layout) the wide design
  and the shared-memory design (the in-run yardstick) give the same K1,
  K2 and K3 solutions and K1 and K4 factors, within 100 cond eps; and
  every packed factor, K1's or K4's of either design, resolved by each
  design's K2, gives K1's x."""
  _cuda()
  gen = torch.Generator().manual_seed(20 + n)
  a = torch.randn(1024, n, n, generator=gen, dtype=torch.float64)
  h = (a @ a.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64)).to(
      'cuda', dtype)
  g = torch.randn(1024, n, generator=gen, dtype=torch.float64).to(
      'cuda', dtype)
  eps = torch.finfo(dtype).eps
  x64 = torch.linalg.solve(h.double(), g.double())
  tol = _cond_tol(h, x64, eps)
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  out, facs = {}, {}
  for design in ('wide', 'shared'):
    x1, fac = LC._launch(LC._MODE_SOLVE_FACTOR, 'cholesky_solve_factor', h,
                         g, want_factor=True, design=design)
    fac4 = LC._launch(LC._MODE_FACTOR, 'cholesky_factor', h,
                      want_factor=True, design=design)
    x3 = LC._launch(LC._MODE_SOLVE, 'cholesky_solve', h, g, design=design)
    x2 = LC._launch(LC._MODE_RESOLVE, 'cholesky_resolve_const', fac, g,
                    design=design)
    out[design] = (x1, x3, x2)
    facs[('K1', design)], facs[('K4', design)] = fac, fac4
  for got, want in zip(out['wide'], out['shared']):
    assert (got - want).abs().max().item() <= tol
  fac_s = facs[('K1', 'shared')]
  for fac in facs.values():
    assert ((fac - fac_s)[:, low].abs().max().item()
            <= 100 * eps * fac_s[:, low].abs().max().item() * n)
  assert LC._design(n, dtype, LC._MODE_RESOLVE) == 'wide'
  for design in ('wide', 'shared'):
    for fac in facs.values():
      x2 = LC._launch(LC._MODE_RESOLVE, 'cholesky_resolve_const', fac, g,
                      design=design)
      assert (x2 - out['wide'][0]).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_shared_design_at_the_top_of_the_pallas_range(dtype):
  """At n = 80, the largest n of the JAX package's Pallas kernels, K1-K4
  run the wide design (three warps a matrix; the shared one starts above
  80); each is held against its plain version on the same card inputs
  within 100 cond eps of the solution's scale (the packed factors on
  their lower triangles, to 100 n eps of their max-abs), with one launch
  each through the entry points."""
  _cuda()
  n = 80
  gen = torch.Generator().manual_seed(22)
  a = torch.randn(64, n, n, generator=gen, dtype=torch.float64)
  h = (a @ a.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64)).to(
      'cuda', dtype)
  g = torch.randn(64, n, generator=gen, dtype=torch.float64).to(
      'cuda', dtype)
  for mode in (LC._MODE_SOLVE_FACTOR, LC._MODE_RESOLVE, LC._MODE_SOLVE,
               LC._MODE_FACTOR):
    assert LC._design(n, dtype, mode) == 'wide'
    assert LC._design(n + 1, dtype, mode) == 'shared'
  eps = torch.finfo(dtype).eps
  tol = _cond_tol(h, torch.linalg.solve(h.double(), g.double()), eps)
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  LC.reset_launches()
  x1, fac1 = LC.cholesky_solve_factor(h, g)
  x3 = LC.cholesky_solve(h, g)
  fac4 = LC.cholesky_factor(h)
  x_p, fac_p = LC.solve_factor_plain(h, g)
  x2 = LC.cholesky_resolve_const(fac_p, g)
  torch.cuda.synchronize()
  assert LC.launches == {'cholesky_solve_factor': 1,
                         'cholesky_resolve_const': 1, 'cholesky_solve': 1,
                         'cholesky_factor': 1}
  for got, want in ((x1, x_p), (x3, x_p),
                    (x2, LC.resolve_plain(fac_p, g))):
    assert (got - want).abs().max().item() <= tol
  fac_tol = 100 * n * eps * fac_p[:, low].abs().max().item()
  for fac in (fac1, fac4):
    assert (fac - fac_p)[:, low].abs().max().item() <= fac_tol


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_shared_design_above_the_wide_range(dtype):
  """At n = 96, past every mode's wide design, K1-K4 run the shared
  design; each is held against its plain version on the same card inputs
  (tolerances as at n = 80), with one launch each."""
  _cuda()
  n = 96
  gen = torch.Generator().manual_seed(23)
  a = torch.randn(37, n, n, generator=gen, dtype=torch.float64)
  h = (a @ a.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64)).to(
      'cuda', dtype)
  g = torch.randn(37, n, generator=gen, dtype=torch.float64).to(
      'cuda', dtype)
  for mode in (LC._MODE_SOLVE_FACTOR, LC._MODE_RESOLVE, LC._MODE_SOLVE,
               LC._MODE_FACTOR):
    assert LC._design(n, dtype, mode) == 'shared'
  eps = torch.finfo(dtype).eps
  tol = _cond_tol(h, torch.linalg.solve(h.double(), g.double()), eps)
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  LC.reset_launches()
  x1, fac1 = LC.cholesky_solve_factor(h, g)
  x3 = LC.cholesky_solve(h, g)
  fac4 = LC.cholesky_factor(h)
  x_p, fac_p = LC.solve_factor_plain(h, g)
  x2 = LC.cholesky_resolve_const(fac_p, g)
  torch.cuda.synchronize()
  assert LC.launches == {'cholesky_solve_factor': 1,
                         'cholesky_resolve_const': 1, 'cholesky_solve': 1,
                         'cholesky_factor': 1}
  for got, want in ((x1, x_p), (x3, x_p),
                    (x2, LC.resolve_plain(fac_p, g))):
    assert (got - want).abs().max().item() <= tol
  fac_tol = 100 * n * eps * fac_p[:, low].abs().max().item()
  for fac in (fac1, fac4):
    assert (fac - fac_p)[:, low].abs().max().item() <= fac_tol


@pytest.mark.cuda
@pytest.mark.parametrize('n', [62, 80])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_wide_design_on_a_rank_deficient_batch(dtype, n):
  """K1, K3, K4 and the K4 + K2 pair in the design `_design` picks (all
  four wide, at n = 62 and at n = 80) on SPD matrices with every
  third dof's row and column zeroed: those pivots are exact zeros, the
  clamp gives 1e6 in kernel and plain version alike, and x and K1's and
  K4's factors agree with the plain versions on the kept and on the
  zeroed dofs, each part to 1e-4 of its own max-abs (chip_smoke's
  rank-deficient check at n = 30)."""
  _cuda()
  gen = torch.Generator().manual_seed(21 + n)
  a = torch.randn(256, n, n, generator=gen, dtype=torch.float64)
  h = a @ a.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64)
  keep = torch.arange(n) % 3 != 1
  k = keep.double()
  h = (h * k[:, None] * k[None, :]).to('cuda', dtype)
  g = torch.randn(256, n, generator=gen, dtype=torch.float64).to(
      'cuda', dtype)
  for mode in (LC._MODE_SOLVE_FACTOR, LC._MODE_RESOLVE, LC._MODE_SOLVE,
               LC._MODE_FACTOR):
    assert LC._design(n, dtype, mode) == 'wide'
  x, fac = LC.cholesky_solve_factor(h, g)
  x3 = LC.cholesky_solve(h, g)
  fac4 = LC.cholesky_factor(h)
  x42 = LC.cholesky_resolve(fac4, g)
  x_p, fac_p = LC.solve_factor_plain(h, g)
  kept = keep.to('cuda')
  low = torch.tril(torch.ones(n, n, dtype=torch.bool, device='cuda'))
  fac_kept = low & kept[:, None] & kept[None, :]
  parts = {'K1 x': (x, kept, ~kept), 'K3 x': (x3, kept, ~kept),
           'K4 + K2 x': (x42, kept, ~kept),
           'K1 factor': (fac, fac_kept, low & ~fac_kept),
           'K4 factor': (fac4, fac_kept, low & ~fac_kept)}
  for what, (got, m_kept, m_zeroed) in parts.items():
    want = fac_p if what.endswith('factor') else x_p
    assert bool(torch.isfinite(got).all()), what
    for part, m in (('kept', m_kept), ('zeroed', m_zeroed)):
      err = (got[:, m] - want[:, m]).abs().max().item()
      scale = want[:, m].abs().max().item()
      assert err <= 1e-4 * scale, (what, part, err, scale)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
  _cuda()
  h = torch.eye(4, device='cuda', dtype=torch.float16)[None]
  with pytest.raises(TypeError):
    LC.cholesky_solve(h, torch.ones(1, 4, device='cuda',
                                    dtype=torch.float16))
  big = torch.eye(300, device='cuda')[None]
  with pytest.raises(ValueError):
    LC.cholesky_solve(big, torch.ones(1, 300, device='cuda'))


def _tree_inputs(model, b, seed):
  gen = torch.Generator().manual_seed(seed)
  dt = model.dtype
  qpos = (model.qpos0.cpu()[:, None]
          + 0.3 * torch.randn(model.nq, b, generator=gen, dtype=dt))
  qvel = torch.randn(model.nv, b, generator=gen, dtype=dt)
  mp = torch.randn(3 * model.nmocap, b, generator=gen, dtype=dt)
  mq = torch.randn(4 * model.nmocap, b, generator=gen, dtype=dt)
  return [x.to(model.device) for x in (qpos, qvel, mp, mq)]


@pytest.mark.cuda
@pytest.mark.parametrize('b', [64, 37])
def test_tree_sweep_kernels_match_plain_on_card(b):
  """K5 + K6 against the plain version in float64, on a batch that fills
  its last tile and one that does not."""
  _cuda()
  task = manipulation.build_task('reorient', 'state_dense')
  model = task.compile(device='cuda', dtype=torch.float64)
  ins = _tree_inputs(model, b, 10)
  tree_cuda.reset_launches()
  out = tree_cuda.build_tree_sweep(model)(*ins)
  ref = tree_cuda.tree_sweep_plain(model, *ins)
  torch.cuda.synchronize()
  assert tree_cuda.launches == {'tree_sweep_fk': 1, 'tree_sweep_dyn': 1}
  assert sorted(out) == sorted(ref)
  for key in ref:
    torch.testing.assert_close(out[key], ref[key], rtol=1e-10, atol=1e-12,
                               msg=key)


@pytest.mark.cuda
def test_small_solve_batch_on_card():
  """A small solve_batch on the card: K1/K2 launch counts per solve,
  finite in-range actions."""
  _cuda()
  from dexterity_tpu_torch.core import types
  from dexterity_tpu_torch.manipulation.goals import prop_orientation
  from dexterity_tpu_torch.planners import predictive_sampling as ps
  task = manipulation.build_task('reorient', 'state_dense')
  cfg = ps.PredictiveSamplingConfig(horizon=2, num_samples=8, iterations=2,
                                    plan_substeps=3)
  planner = ps.PredictiveSampling(task, cfg)
  gen = torch.Generator(device='cuda').manual_seed(0)
  data = types.make_data(planner.model, (2,))
  goals = prop_orientation.uniform_quaternion(gen, (2,))
  LC.reset_launches()
  tree_cuda.reset_launches()
  actions, state = planner.solve_batch(data, goals,
                                       planner.init_state(streams=2), gen)
  torch.cuda.synchronize()
  per_solve = cfg.iterations * cfg.horizon * planner.n_plan_substeps * 2
  assert LC.launches['cholesky_solve_factor'] == per_solve
  assert LC.launches['cholesky_resolve_const'] == per_solve
  assert LC.launches['cholesky_solve'] == LC.launches['cholesky_factor'] == 0
  assert tree_cuda.launches == {'tree_sweep_fk': 0, 'tree_sweep_dyn': 0}
  assert actions.shape == (2, planner.nu) and actions.is_cuda
  assert bool(torch.isfinite(actions).all())
  assert bool(((actions >= planner._lo) & (actions <= planner._hi)).all())
  assert bool(torch.isfinite(state.best_return).all())


@pytest.mark.cuda
def test_sharded_solve_batch_at_one_nccl_rank_is_solve_batch(tmp_path):
  """sharded_solve_batch on a world of one NCCL rank (FileStore) is
  solve_batch bit for bit from the same generator seed, with solve_batch's
  K1/K2 launches."""
  _cuda()
  import torch.distributed as dist
  from dexterity_tpu_torch.core import types
  from dexterity_tpu_torch.manipulation.goals import prop_orientation
  from dexterity_tpu_torch.parallel import sharding
  from dexterity_tpu_torch.planners import distributed
  from dexterity_tpu_torch.planners import predictive_sampling as ps
  task = manipulation.build_task('reorient', 'state_dense')
  cfg = ps.PredictiveSamplingConfig(horizon=2, num_samples=8, iterations=2,
                                    plan_substeps=3)
  planner = ps.PredictiveSampling(task, cfg)
  data = types.make_data(planner.model, (2,))
  goals = prop_orientation.uniform_quaternion(
      torch.Generator(device='cuda').manual_seed(1), (2,))
  assert sharding.initialize_distributed(f'file://{tmp_path}/store', 1, 0)
  try:
    assert dist.get_backend() == 'nccl'
    mesh = sharding.make_mesh()
    LC.reset_launches()
    sharded = distributed.sharded_solve_batch(
        planner, mesh, data, goals, planner.init_state(streams=2),
        torch.Generator(device='cuda').manual_seed(0))
    torch.cuda.synchronize()
    launches = dict(LC.launches)
  finally:
    dist.destroy_process_group()
  plain = planner.solve_batch(data, goals, planner.init_state(streams=2),
                              torch.Generator(device='cuda').manual_seed(0))
  for got, want in ((sharded[0], plain[0]),
                    (sharded[1].nominal, plain[1].nominal),
                    (sharded[1].best_return, plain[1].best_return)):
    assert torch.equal(got, want)
  per_solve = cfg.iterations * cfg.horizon * planner.n_plan_substeps * 2
  assert launches['cholesky_solve_factor'] == per_solve
  assert launches['cholesky_resolve_const'] == per_solve


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1, 7, 1000, 1024])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_tree_dyn_matches_plain_on_card(dtype, b):
  """K6 against dyn_plain on the same card inputs (cdof and body10 from the
  plain FK), relative to each output's max-abs: 1e-4 in float32 (the sums
  run in another order), 1e-10 in float64; batches that fill their last
  tile of 8 rollouts and ones that do not."""
  _cuda()
  task = manipulation.build_task('reorient', 'state_dense')
  model = task.compile(device='cuda', dtype=dtype)
  ins = _tree_inputs(model, b, 16)
  fk = tree_cuda.fk_plain(model, *ins)
  tree_cuda.reset_launches()
  out = tree_cuda.tree_dyn(model, fk['cdof'], fk['body10'], ins[1])
  ref = tree_cuda.dyn_plain(model, fk['cdof'], fk['body10'], ins[1])
  torch.cuda.synchronize()
  assert tree_cuda.launches == {'tree_sweep_fk': 0, 'tree_sweep_dyn': 1}
  rel = 1e-4 if dtype == torch.float32 else 1e-10
  for key in ('qm', 'qfrc_bias'):
    assert out[key].shape == ref[key].shape
    scale = max(ref[key].abs().max().item(), 1.0)
    err = (out[key] - ref[key]).abs().max().item()
    assert err <= rel * scale, (key, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1, 7, 37, 1000, 1024])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_tree_fk_matches_plain_on_card(dtype, b):
  """K5 against fk_plain on the same card inputs, relative to each
  output's max-abs: 1e-4 in float32, 1e-10 in float64; batches whose rows
  are not whole 16-byte chunks (1, 7, 37) take the element stores, and
  every batch but 1024 ends in a partial tile."""
  _cuda()
  task = manipulation.build_task('reorient', 'state_dense')
  model = task.compile(device='cuda', dtype=dtype)
  ins = _tree_inputs(model, b, 19)
  ref = tree_cuda.fk_plain(model, *ins)
  rel = 1e-4 if dtype == torch.float32 else 1e-10
  tree_cuda.reset_launches()
  out = tree_cuda.tree_fk(model, *ins)
  torch.cuda.synchronize()
  assert tree_cuda.launches == {'tree_sweep_fk': 1, 'tree_sweep_dyn': 0}
  assert sorted(out) == sorted(ref)
  for key in ref:
    assert out[key].shape == ref[key].shape, key
    assert out[key].is_contiguous(), key
    scale = max(ref[key].abs().max().item(), 1.0)
    err = (out[key] - ref[key]).abs().max().item()
    assert err <= rel * scale, (key, err, scale)


def _env_inputs(model, b, seed):
  """Seeded reorient states on `model`'s device: the cube at the spawn
  workspace centre with a random orientation, the hand at qpos0, controls
  in the middle of their ranges."""
  from dexterity_tpu_torch.core import types
  gen = torch.Generator().manual_seed(seed)
  qpos = model.qpos0.double().cpu().expand(b, model.nq).clone()
  free = [j for j in range(model.njnt)
          if model.jnt_type[j] == int(types.JointType.FREE)][0]
  qa = model.jnt_qposadr[free]
  qpos[:, qa:qa + 3] = torch.tensor([0.0, -0.13, 0.16], dtype=torch.float64)
  q = torch.randn(b, 4, generator=gen, dtype=torch.float64)
  qpos[:, qa + 3:qa + 7] = q / q.norm(dim=1, keepdim=True)
  ctrl = model.actuator_ctrlrange.double().cpu().mean(-1).expand(b, -1)
  return types.make_data(model, (b,)).replace(
      qpos=qpos.to(model.device, model.dtype),
      ctrl=ctrl.to(model.device, model.dtype))


@pytest.mark.cuda
def test_forward_and_step_n_on_card_match_cpu_float64():
  """forward and one control step of step_n(refresh='full') on the
  environment model at B = 4 in float32, against the port on the CPU in
  float64 (PERF.md §2's limits: qpos 1e-4, qvel 1e-2, frames 1e-4 of
  their max-abs); K3 launched 8 times in forward and 45 in the step."""
  _cuda()
  from dexterity_tpu_torch.physics import step
  task = manipulation.build_task('reorient', 'state_dense')
  model = task.compile(device='cuda')
  cpu = task.compile(device='cpu', dtype=torch.float64)
  n = task.n_substeps
  data = _env_inputs(model, 4, 23)
  LC.reset_launches()
  fwd = step.forward(model, data)
  torch.cuda.synchronize()
  assert LC.launches['cholesky_solve'] == model.opt.solver_iterations == 8
  out = step.step_n(model, fwd, n, refresh='full')
  torch.cuda.synchronize()
  assert LC.launches['cholesky_solve'] == 8 + n * (8 + 1)
  assert sum(LC.launches.values()) == LC.launches['cholesky_solve']
  ref_fwd = step.forward(cpu, _env_inputs(cpu, 4, 23))
  ref = step.step_n(cpu, ref_fwd, n, refresh='full')
  for f in ('xpos', 'geom_xpos', 'cdof', 'qM'):
    want = getattr(ref_fwd, f)
    err = (getattr(fwd, f).double().cpu() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), (f, err)
  assert bool(torch.isfinite(fwd.qacc).all())
  assert (out.qpos.double().cpu() - ref.qpos).abs().max().item() < 1e-4
  assert (out.qvel.double().cpu() - ref.qvel).abs().max().item() < 1e-2
  for f in ('xpos', 'geom_xpos'):
    want = getattr(ref, f)
    err = (getattr(out, f).double().cpu() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), (f, err)
  assert out.contact.dist.shape == (4, ref.contact.dist.shape[-1])
  assert bool(torch.isfinite(out.cvel).all())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_solve_m_unbatched_on_card(dtype):
  """K3 through smooth.solve_m on one (30, 30) inertia without a batch
  axis: the wrapper runs it as a batch of one."""
  _cuda()
  from dexterity_tpu_torch.core import types
  from dexterity_tpu_torch.physics import smooth
  h, g = _spd(29, 1, 30)
  data = types.make_data(
      manipulation.build_task('reorient', 'state_dense').compile(
          device='cuda', dtype=dtype)).replace(
              qM=torch.as_tensor(h[0], dtype=dtype, device='cuda'))
  vec = torch.as_tensor(g[0], dtype=dtype, device='cuda')
  LC.reset_launches()
  x = smooth.solve_m(data, vec)
  torch.cuda.synchronize()
  assert LC.launches['cholesky_solve'] == 1
  assert x.shape == (30,) and x.is_cuda
  torch.testing.assert_close(x, LC.solve_plain(data.qM, vec), **_TOL[dtype])


@pytest.mark.cuda
def test_environment_reset_and_step_on_card():
  """manipulation.load on the card: reset and one step of 4 environments.
  K3 runs 8 times in reset's forward (one per exact Newton iteration) and
  45 times in the step (5 substeps x (8 + 1)); the goals are the CPU
  generator's draws; the state after the step is finite."""
  _cuda()
  env = manipulation.load('reorient', 'state_dense')
  assert env.model.device.type == 'cuda'
  LC.reset_launches()
  state, ts = env.reset(torch.Generator().manual_seed(4), (4,))
  torch.cuda.synchronize()
  assert LC.launches['cholesky_solve'] == 8
  assert sum(LC.launches.values()) == 8
  cpu = manipulation.load('reorient', 'state_dense', device='cpu',
                          dtype=torch.float64)
  ref, _ = cpu.reset(torch.Generator().manual_seed(4), (4,))
  assert (state.task.goal.double().cpu() - ref.task.goal).abs().max() < 1e-6
  spec = env.action_spec()
  act = torch.as_tensor((spec.minimum + spec.maximum) / 2, device='cuda')
  LC.reset_launches()
  state, ts = env.step(state, act.expand(4, -1), torch.Generator())
  torch.cuda.synchronize()
  assert LC.launches['cholesky_solve'] == 45
  assert sum(LC.launches.values()) == 45
  assert ts.step_type.shape == (4,) and ts.reward.is_cuda
  assert bool(torch.isfinite(state.data.qpos).all())
  assert bool(torch.isfinite(state.data.qvel).all())
  for key, obs in ts.observation.items():
    assert obs.shape[0] == 4 and bool(torch.isfinite(obs).all()), key


def _first_newton_hessian(fn):
  """Runs fn with cholesky_solve's inputs captured; returns the first
  (H, g) the Newton iteration passed it."""
  seen, real = {}, LC.cholesky_solve

  def capture(h, g):
    seen.setdefault('hg', (h.detach().clone(), g.detach().clone()))
    return real(h, g)
  LC.cholesky_solve = capture
  try:
    fn()
  finally:
    LC.cholesky_solve = real
  return seen['hg']


@pytest.mark.cuda
@pytest.mark.parametrize('domain,variant,n,design',
                         [('juggle', 'state_sparse', 62, 'wide'),
                          ('reach', 'state_dense', 24, 'registers')])
def test_k3_on_the_new_tasks_newton_hessians(domain, variant, n, design):
  """K3 on a step's own first Newton Hessian of the juggle (n = 62, the
  wide design, 20 equality rows) and reach (n = 24, the register
  design) environments on the card, for 4 episodes (4, n, n) and for one
  without a batch axis (1, n, n), against its plain version and a float64
  solve: within 100 cond eps of the solution's scale (at least 1e-4),
  backward error under 1e-4."""
  from dexterity_tpu_torch.utils import structs
  _cuda()
  assert LC._design(n, torch.float32, LC._MODE_SOLVE) == design
  env = manipulation.load(domain, variant)
  state, _ = env.reset(torch.Generator().manual_seed(2), (4,))
  act = torch.zeros(4, env.model.nu, device='cuda')
  one = structs.tree_map(lambda x: x[0], state)
  for st, a, rows in ((state, act, 4), (one, act[0], 1)):
    h, g = _first_newton_hessian(lambda: env.step(st, a, torch.Generator()))
    assert h.shape == (rows, n, n)
    LC.reset_launches()
    x = LC.cholesky_solve(h, g)
    torch.cuda.synchronize()
    assert LC.launches['cholesky_solve'] == 1
    h64, g64 = h.double(), g.double()
    x64 = torch.linalg.solve(h64, g64)
    ev = torch.linalg.eigvalsh(h64)
    cond = (ev[:, -1] / ev[:, 0]).max().item()
    tol = max(1e-4, 100 * cond * 6e-8) * x64.abs().max().item()
    assert (x - LC.solve_plain(h, g)).abs().max().item() <= tol
    assert (x.double() - x64).abs().max().item() <= tol
    res = (h64 @ x.double()[..., None])[..., 0] - g64
    bwd = (res.abs().amax(-1) / (n * h64.abs().amax((-2, -1))
                                 * x.double().abs().amax(-1)
                                 + g64.abs().amax(-1))).max().item()
    assert bwd <= 1e-4


def _jvp_and_grad(fn, first, g, dfirst, dg, xbar):
  """fn's forward-mode tangent (x's) and its gradients under xbar."""
  from torch.autograd import forward_ad
  with forward_ad.dual_level():
    out = fn(forward_ad.make_dual(first, dfirst),
             forward_ad.make_dual(g, dg))
    out = out[0] if isinstance(out, tuple) else out
    tangent = forward_ad.unpack_dual(out).tangent
  a, b = first.clone().requires_grad_(), g.clone().requires_grad_()
  out = fn(a, b)
  out = out[0] if isinstance(out, tuple) else out
  grads = torch.autograd.grad(out, (a, b), xbar, allow_unused=True)
  return tangent, grads


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1024, 8])
@pytest.mark.parametrize('name', ['cholesky_solve_factor',
                                  'cholesky_resolve_const', 'cholesky_solve'])
def test_derivative_rules_on_card_match_cpu(name, b):
  """K1/K2/K3's tangents and gradients on the card (float32, the
  kernels) against the same Functions on the CPU in float64 (the plain
  versions), at (b, 30, 30); the tangents launch K2 (K1's and K2's) and
  K3 (K3's), counted under their own names."""
  _cuda()
  n = 30
  h, g = _spd(11, b, n)
  rng = np.random.RandomState(12)
  dh, dg, xbar = rng.randn(b, n, n), rng.randn(b, n), rng.randn(b, n)
  if name == 'cholesky_resolve_const':
    h = LC.factor_plain(torch.as_tensor(h)).numpy()
  fn = getattr(LC, name)
  dev = [torch.as_tensor(a, dtype=torch.float32, device='cuda')
         for a in (h, g, dh, dg, xbar)]
  cpu = [torch.as_tensor(a, dtype=torch.float64) for a in (h, g, dh, dg, xbar)]
  LC.reset_launches()
  t_card, g_card = _jvp_and_grad(fn, *dev)
  torch.cuda.synchronize()
  counts = dict(LC.launches)
  t_cpu, g_cpu = _jvp_and_grad(fn, *cpu)
  tol = dict(rtol=1e-3, atol=1e-3 * float(t_cpu.abs().max()))
  torch.testing.assert_close(t_card.double().cpu(), t_cpu, **tol)
  for a, c in zip(g_card, g_cpu):
    assert (a is None) == (c is None)
    if c is not None:
      torch.testing.assert_close(a.double().cpu(), c, rtol=1e-3,
                                 atol=1e-3 * float(c.abs().max()))
  # Forward mode: the primal launch and the tangent's; reverse mode: the
  # primal launch and the cotangent's.
  want = {'cholesky_solve_factor': {'cholesky_solve_factor': 2,
                                    'cholesky_resolve_const': 2},
          'cholesky_resolve_const': {'cholesky_resolve_const': 4},
          'cholesky_solve': {'cholesky_solve': 4}}[name]
  assert {k: v for k, v in counts.items() if v} == want


@pytest.mark.cuda
def test_dual_tensor_reaching_launch_raises_on_card():
  """No launch drops a derivative: a dual or grad-requiring operand at
  `_launch` raises."""
  from torch.autograd import forward_ad
  _cuda()
  h, g = _spd(13, 4, 30)
  hc = torch.as_tensor(h, dtype=torch.float32, device='cuda')
  gc = torch.as_tensor(g, dtype=torch.float32, device='cuda')
  with forward_ad.dual_level():
    with pytest.raises(RuntimeError, match='derivative'):
      LC._launch(LC._MODE_SOLVE, 'cholesky_solve', hc,
                 forward_ad.make_dual(gc, torch.ones_like(gc)))
  with pytest.raises(RuntimeError, match='derivative'):
    LC._launch(LC._MODE_SOLVE, 'cholesky_solve', hc.requires_grad_(), gc)
  with pytest.raises(RuntimeError, match='derivative'):
    LC.cholesky_factor(hc)


@pytest.mark.cuda
def test_ilqr_solve_runs_on_card_with_tangent_launches():
  """One ILQR.solve at H = 2 (1 iteration, 2 line-search steps) on the
  reorient planning model for 2 goals from reset: finite actions within
  the bounds, and the K1/K2 launches the configuration gives: per
  substep, the rollout and the line search launch 1 K1 + 3 K2 each, the
  linearization 1 K1 + 3 K2 primal and 4 K2 tangent."""
  from dexterity_tpu_torch.planners import ilqr
  _cuda()
  env = manipulation.load('reorient', 'state_dense')
  state, _ = env.reset(torch.Generator().manual_seed(0), (2,))
  planner = ilqr.ILQR(env.task, ilqr.ILQRConfig(
      horizon=2, iterations=1, line_search_steps=2, plan_substeps=3))
  LC.reset_launches()
  act, st = planner.solve(state.data, state.task.goal,
                          planner.init_state(streams=2))
  torch.cuda.synchronize()
  h, s = 2, planner.n_plan_substeps
  assert LC.launches['cholesky_solve_factor'] == 2 * h * s + s
  assert LC.launches['cholesky_resolve_const'] == 3 * 2 * h * s + 7 * s
  assert LC.launches['cholesky_solve'] == 0
  assert bool(torch.isfinite(act).all() and torch.isfinite(st.cost).all())
  assert bool(((act >= planner._lo) & (act <= planner._hi)).all())


def _ik_targets(cpu, n, seed):
  """n fingertip target sets: the FK (CPU, float64) at joint positions
  uniform in 0.8 of the joint ranges."""
  lo, hi = torch.as_tensor(cpu._lo), torch.as_tensor(cpu._hi)
  u = torch.rand((n, lo.shape[0]), generator=torch.Generator().manual_seed(
      seed), dtype=torch.float64)
  return cpu._tips(cpu._fk(0.8 * lo + 0.8 * (hi - lo) * u))


@pytest.mark.cuda
def test_ik_solve_batch_on_card():
  """solve_batch of 16 feasible target sets on the card (30 attempts):
  at least 13 solved (tests/test_ik.py's 4 in 5), each solution's FK in
  float64 within 1.5 tol of its targets and its joints in range.  No
  tensor of the attempts and the selection leaves the card: no operation
  takes a card tensor to the host, and the only reads are the loop's
  exit test, one per iteration."""
  _cuda()
  from torch.utils._python_dispatch import TorchDispatchMode

  from dexterity_tpu_torch.inverse_kinematics import ik_solver
  from dexterity_tpu_torch.models import hands
  solver = ik_solver.IKSolver(hands.AdroitHand())
  cpu = ik_solver.IKSolver(hands.AdroitHand(), device='cpu',
                           dtype=torch.float64)
  targets = _ik_targets(cpu, 16, 0)
  solver.solve_batch(targets, gen=torch.Generator().manual_seed(1))
  inits = solver._initial_configurations(16, 30,
                                         torch.Generator().manual_seed(2))

  class OffCard(TorchDispatchMode):
    to_host, reads = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      out = func(*args, **(kwargs or {}))
      if func is torch.ops.aten._local_scalar_dense.default:
        OffCard.reads += 1
        return out
      ins = [a for a in args if isinstance(a, torch.Tensor)]
      outs = out if isinstance(out, (tuple, list)) else (out,)
      if any(a.is_cuda for a in ins) and any(
          isinstance(o, torch.Tensor) and not o.is_cuda for o in outs):
        self.to_host.append(str(func))
      return out

  with OffCard() as watch:
    qpos, ok = solver._best(inits, targets.reshape(16, -1), 1e-3, 100)
  assert watch.to_host == []
  assert 1 <= OffCard.reads <= 101
  assert qpos.is_cuda and ok.is_cuda and qpos.dtype == torch.float32
  assert int(ok.sum()) >= 13
  q64 = qpos.double().cpu()
  err = torch.linalg.vector_norm(cpu._tips(cpu._fk(q64)) - targets, dim=-1)
  assert bool((err[ok.cpu()] <= 1.5e-3).all())
  assert bool((q64 >= torch.as_tensor(cpu._lo)).all())
  assert bool((q64 <= torch.as_tensor(cpu._hi)).all())


def test_ik_solver_needs_a_card_or_the_cpu(monkeypatch):
  """IKSolver() places its model on cuda: without a card it raises unless
  the caller asks for the CPU."""
  from dexterity_tpu_torch.inverse_kinematics import ik_solver
  from dexterity_tpu_torch.models import hands
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    ik_solver.IKSolver(hands.AdroitHand())
  solver = ik_solver.IKSolver(hands.AdroitHand(), device='cpu')
  assert solver.model.device == torch.device('cpu')
  assert solver.model.dtype == torch.float32


@pytest.mark.cuda
def test_one_control_steps_state_reaches_the_host_in_one_copy():
  """rendering.host_state of a card state: (qpos, mocap_pos, mocap_quat)
  as numpy, brought over in one device-to-host copy."""
  _cuda()
  from torch.utils._python_dispatch import TorchDispatchMode

  from dexterity_tpu_torch import rendering
  env = manipulation.load('reorient', 'state_dense')
  gen = torch.Generator().manual_seed(0)
  state, _ = env.reset(gen, (8,))
  state, _ = env.step(state, torch.zeros(8, env.action_spec().shape[0]),
                      gen)
  data = state.data

  class ToHost(TorchDispatchMode):
    copies = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      out = func(*args, **(kwargs or {}))
      ins = [a for a in args if isinstance(a, torch.Tensor)]
      if any(a.is_cuda for a in ins) and isinstance(
          out, torch.Tensor) and not out.is_cuda:
        ToHost.copies.append(str(func))
      return out

  with ToHost():
    qpos, mpos, mquat = rendering.host_state(data)
  assert len(ToHost.copies) == 1
  assert qpos.shape == (8, env.model.nq) and qpos.dtype == np.float32
  assert mpos.shape == (8, env.model.nmocap, 3)
  assert mquat.shape == (8, env.model.nmocap, 4)
  np.testing.assert_array_equal(qpos, data.qpos.cpu().numpy())
  np.testing.assert_array_equal(mpos, data.mocap_pos.cpu().numpy())
  np.testing.assert_array_equal(mquat, data.mocap_quat.cpu().numpy())


@pytest.mark.cuda
def test_reach_vision_observation_on_card():
  """reach VISION_ONLY on the card: the camera observation is uint8 on
  cuda, rendered from the vendor meshes (needs mujoco on the host)."""
  _cuda()
  pytest.importorskip('mujoco')
  from dexterity_tpu_torch import environment
  from dexterity_tpu_torch.manipulation.shared import observations
  from dexterity_tpu_torch.manipulation.tasks import reach
  task = reach.reach_task(observations.ObservationSet.VISION_ONLY, True)
  env = environment.GoalEnvironment(task)
  gen = torch.Generator().manual_seed(0)
  LC.reset_launches()
  state, ts = env.reset(gen, (8,))
  state, ts = env.step(state, torch.zeros(8, env.action_spec().shape[0]),
                       gen)
  img = ts.observation['front_close']
  assert tuple(img.shape) == (8, 84, 84, 3)
  assert img.dtype == torch.uint8 and img.is_cuda
  assert int(img.max()) > 0
  assert task._camera_obs._renderer._mm.nmesh > 0
  assert LC.launches['cholesky_solve'] > 0
  task._camera_obs._renderer.close()
