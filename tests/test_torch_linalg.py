"""Cholesky kernels of the PyTorch port (dexterity_tpu_torch.physics.
linalg_cuda) against the JAX package's linalg_pallas.

On the CPU the wrappers run their plain PyTorch versions; those are held
to the JAX solutions at the tolerances of tests/test_linalg_pallas.py.
The packed factor (K1's and K4's output, K2's input) exists only in the
kernels' layout — JAX's CPU "factor" is the matrix itself — so it is held
to a numpy implementation of the documented layout, and the
cholesky_factor / cholesky_resolve pair is held to JAX's by its
solution.  The CUDA kernels
themselves are checked on the card by tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu.physics import linalg_pallas as LP
from dexterity_tpu_torch.physics import linalg_cuda as LC


def _spd(seed, batch, n):
  rng = np.random.RandomState(seed)
  a = rng.randn(*batch, n, n)
  h = np.einsum('...ij,...kj->...ik', a, a) + 3 * np.eye(n)
  g = rng.randn(*batch, n)
  return h, g


def _packed_factor_np(h):
  """Documented packed layout: strict lower = L, diagonal = 1 / L_kk."""
  n = h.shape[-1]
  out = np.zeros_like(h)
  for idx in np.ndindex(h.shape[:-2]):
    low = np.linalg.cholesky(h[idx])
    f = np.tril(low, -1)
    f[np.arange(n), np.arange(n)] = 1.0 / np.diag(low)
    out[idx] = f
  return out


def _t(x):
  return torch.as_tensor(x, dtype=torch.float64)


# The last five sit on the boundaries of the kernels' register design
# (n <= 32, a row per lane) and of the wide design (n <= 64, a row per
# thread over two warps), and at the juggle model's n = 62.
_SHAPES = [((7,), 10), ((3, 5), 8), ((4,), 30), ((2,), 1), ((2,), 32),
           ((2,), 33), ((2,), 64), ((2,), 62)]


@pytest.mark.parametrize('batch,n', _SHAPES)
def test_cholesky_solve_matches_jax(batch, n):
  h, g = _spd(0, batch, n)
  f = LP.cholesky_solve
  for _ in batch:
    f = jax.vmap(f)
  ref = np.asarray(jax.jit(f)(jnp.asarray(h), jnp.asarray(g)))
  got = LC.cholesky_solve(_t(h), _t(g)).numpy()
  np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize('batch,n', _SHAPES)
def test_cholesky_solve_factor_matches_jax(batch, n):
  h, g = _spd(1, batch, n)
  f = LP.cholesky_solve_factor
  for _ in batch:
    f = jax.vmap(f)
  ref_x, _ = jax.jit(f)(jnp.asarray(h), jnp.asarray(g))
  x, fac = LC.cholesky_solve_factor(_t(h), _t(g))
  np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), rtol=1e-7,
                             atol=1e-9)
  # Lower triangle and diagonal of the packed factor (upper unspecified).
  want = _packed_factor_np(h)
  low = np.tril(np.ones((n, n), bool))
  np.testing.assert_allclose(fac.numpy()[..., low], want[..., low],
                             rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize('batch,n', _SHAPES)
def test_cholesky_resolve_const_matches_jax(batch, n):
  h, g = _spd(2, batch, n)
  _, g2 = _spd(3, batch, n)
  f = LP.cholesky_resolve_const
  for _ in batch:
    f = jax.vmap(f)
  # JAX's CPU factor is the matrix itself; resolve refactors it.
  ref = np.asarray(jax.jit(f)(jnp.asarray(h), jnp.asarray(g2)))
  _, fac = LC.cholesky_solve_factor(_t(h), _t(g))
  got = LC.cholesky_resolve_const(fac, _t(g2)).numpy()
  np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-9)
  # The resolve reads only the documented layout: garbage in the upper
  # triangle changes nothing.
  upper = torch.triu(torch.full_like(fac, 1e6), 1)
  got2 = LC.cholesky_resolve_const(fac + upper, _t(g2)).numpy()
  np.testing.assert_array_equal(got2, got)


@pytest.mark.parametrize('batch,n', [((2, 6), 9), ((5,), 8), ((4,), 30),
                                     ((2,), 62)])
def test_cholesky_factor_resolve_pair_matches_jax(batch, n):
  """K4 + K2: the pair's solution against JAX's cholesky_factor /
  cholesky_resolve under nested vmaps (tests/test_linalg_pallas.py).
  JAX's CPU factor is the matrix itself, the port's the packed factor;
  the solutions agree."""
  h, g = _spd(7, batch, n)

  def fr(hh, gg):
    return LP.cholesky_resolve(LP.cholesky_factor(hh), gg)

  f = fr
  for _ in batch:
    f = jax.vmap(f)
  ref = np.asarray(jax.jit(f)(jnp.asarray(h), jnp.asarray(g)))
  fac = LC.cholesky_factor(_t(h))
  assert fac.shape == batch + (n, n)
  got = LC.cholesky_resolve(fac, _t(g)).numpy()
  np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-9)
  np.testing.assert_allclose(got, np.linalg.solve(h, g[..., None])[..., 0],
                             rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize('batch,n', _SHAPES)
def test_cholesky_factor_packed_layout(batch, n):
  """K4's output is the documented packed layout, the same as K1's
  factor."""
  h, g = _spd(8, batch, n)
  fac = LC.cholesky_factor(_t(h)).numpy()
  low = np.tril(np.ones((n, n), bool))
  np.testing.assert_allclose(fac[..., low], _packed_factor_np(h)[..., low],
                             rtol=1e-10, atol=1e-12)
  _, fac1 = LC.cholesky_solve_factor(_t(h), _t(g))
  np.testing.assert_array_equal(fac[..., low], fac1.numpy()[..., low])


def test_near_singular_is_finite():
  """The pivot clamp rsqrt(max(a_kk, 1e-12)) keeps a rank-deficient
  matrix finite, as on the TPU."""
  rng = np.random.RandomState(4)
  n = 12
  v = rng.randn(3, n, 2)
  h = np.einsum('bik,bjk->bij', v, v)               # rank 2
  g = rng.randn(3, n)
  for x in (LC.cholesky_solve(_t(h), _t(g)),
            LC.cholesky_solve_factor(_t(h), _t(g))[0],
            LC.cholesky_resolve(LC.cholesky_factor(_t(h)), _t(g))):
    assert torch.isfinite(x).all()


def test_cpu_tensors_use_plain_versions():
  """CPU tensors run the plain versions and launch nothing."""
  LC.reset_launches()
  h, g = _spd(5, (2,), 6)
  x, fac = LC.cholesky_solve_factor(_t(h), _t(g))
  LC.cholesky_resolve_const(fac, _t(g))
  LC.cholesky_solve(_t(h), _t(g))
  LC.cholesky_resolve(LC.cholesky_factor(_t(h)), _t(g))
  assert LC.launches == {'cholesky_solve_factor': 0,
                         'cholesky_resolve_const': 0, 'cholesky_solve': 0,
                         'cholesky_factor': 0}


def test_float32_plain_matches_float64():
  h, g = _spd(6, (16,), 30)
  x32 = LC.cholesky_solve(_t(h).float(), _t(g).float()).double().numpy()
  ref = np.linalg.solve(h, g[..., None])[..., 0]
  np.testing.assert_allclose(x32, ref, rtol=1e-3, atol=1e-5)


_K1, _K2, _K3, _K4 = (LC._MODE_SOLVE_FACTOR, LC._MODE_RESOLVE, LC._MODE_SOLVE,
                      LC._MODE_FACTOR)


@pytest.mark.parametrize('n,dtype,want', [
    (1, torch.float32, 'registers'), (30, torch.float32, 'registers'),
    (32, torch.float32, 'registers'), (33, torch.float32, 'wide'),
    (64, torch.float32, 'wide'), (80, torch.float32, 'shared'),
    (300, torch.float32, 'shared'), (1, torch.float64, 'registers'),
    (30, torch.float64, 'registers'), (32, torch.float64, 'registers'),
    (33, torch.float64, 'wide'), (64, torch.float64, 'wide'),
    (0, torch.float32, 'shared'), (30, torch.float16, 'shared'),
    (62, torch.float32, 'wide'), (62, torch.float64, 'wide'),
    (65, torch.float32, 'shared'), (65, torch.float64, 'shared'),
    (62, torch.float16, 'shared')])
@pytest.mark.parametrize('mode', [_K1, _K2, _K3, _K4])
def test_design_rule(n, dtype, want, mode):
  """Each kernel's design follows from (n, dtype, mode) alone: for every
  mode the register design at n <= 32, the wide design at 32 < n <= 64
  and the shared design above 64."""
  assert LC._design(n, dtype, mode) == want


@pytest.mark.parametrize('mode,name', [
    (LC._MODE_SOLVE_FACTOR, 'cholesky_solve_factor'),
    (LC._MODE_RESOLVE, 'cholesky_resolve_const'),
    (LC._MODE_SOLVE, 'cholesky_solve'),
    (LC._MODE_FACTOR, 'cholesky_factor')])
def test_launch_checks_come_before_the_card(monkeypatch, mode, name):
  """The wrapper's checks raise before any build or card call: float16,
  an n whose matrix does not fit in shared memory, and a register design
  asked for where it does not exist (meta tensors, no card).  K4 takes no
  rhs."""
  def no_build(*_):
    raise AssertionError('the checks should have raised before a build')
  monkeypatch.setattr(LC.cuda_build, 'build_all', no_build)
  monkeypatch.setattr(LC, '_fns', {})

  def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device='meta')

  def rhs(*shape, dtype=torch.float32):
    return None if mode == LC._MODE_FACTOR else meta(*shape, dtype=dtype)

  with pytest.raises(TypeError):
    LC._launch(mode, name, meta(2, 4, 4, dtype=torch.float16),
               rhs(2, 4, dtype=torch.float16))
  with pytest.raises(ValueError, match='shared memory'):
    LC._launch(mode, name, meta(1, 300, 300), rhs(1, 300))
  with pytest.raises(ValueError, match='register design'):
    LC._launch(mode, name, meta(1, 80, 80), rhs(1, 80), design='registers')
  with pytest.raises(ValueError):
    LC._launch(mode, name, meta(2, 4, 5), rhs(2, 4))


@pytest.mark.parametrize('mode,name', [
    (LC._MODE_SOLVE, 'cholesky_solve'), (LC._MODE_FACTOR, 'cholesky_factor'),
    (LC._MODE_SOLVE_FACTOR, 'cholesky_solve_factor'),
    (LC._MODE_RESOLVE, 'cholesky_resolve_const')])
@pytest.mark.parametrize('n,dtype,want', [
    (1, torch.float32, 'registers'), (30, torch.float32, 'registers'),
    (32, torch.float64, 'registers'), (33, torch.float32, 'wide'),
    (62, torch.float64, 'wide'), (32, torch.float32, 'registers'),
    (33, torch.float64, 'wide'), (62, torch.float32, 'wide'),
    (64, torch.float32, 'wide'), (64, torch.float64, 'wide'),
    (65, torch.float32, 'shared'), (65, torch.float64, 'shared')])
def test_launch_picks_k3_design(monkeypatch, n, dtype, want, mode, name):
  """`_launch` sends each kernel, K1 (cholesky_solve_factor), K2
  (cholesky_resolve_const), K3 (cholesky_solve) and K4 (cholesky_factor,
  no rhs), to the design `_design` names: the register design at n <= 32,
  the wide one at 32 < n <= 64 and the shared-memory one above (meta
  tensors, a stub C entry per design, no card)."""
  called = []
  fns = {d: (lambda *args, d=d: called.append((d, args[0], args[-1])) or 0)
         for d in ('registers', 'wide', 'shared')}
  monkeypatch.setattr(LC, '_fns', fns)
  monkeypatch.setattr(LC.cuda_build, 'launch',
                      lambda fn, dev, *args: fn(*args))
  monkeypatch.setitem(LC.launches, name, 0)
  h = torch.empty(4, n, n, dtype=dtype, device='meta')
  g = torch.empty(4, n, dtype=dtype, device='meta')
  if mode == LC._MODE_FACTOR:
    out = LC._launch(mode, name, h, want_factor=True)
    assert out.shape == (4, n, n)
  elif mode == LC._MODE_SOLVE_FACTOR:
    x, fac = LC._launch(mode, name, h, g, want_factor=True)
    assert x.shape == (4, n) and fac.shape == (4, n, n)
  else:
    out = LC._launch(mode, name, h, g)
    assert out.shape == (4, n)
  assert LC._design(n, dtype, mode) == want
  # The matrices per block the design takes, as many as fit.
  per_matrix = LC._matrix_smem_bytes(n, h.element_size(), want, mode)
  per_block = min(LC._PER_BLOCK[want], LC._MAX_SMEM // per_matrix)
  assert called == [(want, mode, per_block)]
  assert LC.launches[name] == 1


@pytest.mark.parametrize('mode,name', [
    (LC._MODE_SOLVE, 'cholesky_solve'),
    (LC._MODE_SOLVE_FACTOR, 'cholesky_solve_factor'),
    (LC._MODE_RESOLVE, 'cholesky_resolve_const'),
    (LC._MODE_FACTOR, 'cholesky_factor')])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_wide_design_checks_its_shared_memory_first(monkeypatch, mode, name,
                                                    dtype):
  """The wide design's shared memory per matrix mirrors
  wide_group_smem_bytes (cholesky_wide.cu): the mbarrier, the column
  slots (all but K2), y or x of one warp and the stage (all but K3, whose
  stage lies in its slots).  A block takes exactly two matrices (kWideGroups); were two
  over the 227 KB a block may use, `_launch` raises before any build or
  card call (meta tensors; the limit lowered to just under two matrices),
  and it refuses the wide design where it has no kernel (n > 64)."""
  n, elem = 62, torch.empty((), dtype=dtype).element_size()
  cols = 64 * (64 + 16 // elem) * elem
  stage = ((62 * 62 + 64) * elem + 15) // 16 * 16
  want = (16 + (0 if mode == LC._MODE_RESOLVE else cols) + 32 * elem +
          (0 if mode == LC._MODE_SOLVE else stage))
  assert LC._matrix_smem_bytes(n, elem, 'wide', mode) == want
  assert want % 16 == 0

  def no_build(*_):
    raise AssertionError('the checks should have raised before a build')
  monkeypatch.setattr(LC.cuda_build, 'build_all', no_build)
  monkeypatch.setattr(LC, '_fns', {})
  assert LC._PER_BLOCK['wide'] == 2
  monkeypatch.setattr(LC, '_MAX_SMEM', 2 * want - 1)
  h = torch.empty(4, n, n, dtype=dtype, device='meta')
  factor = mode == LC._MODE_FACTOR
  g = None if factor else torch.empty(4, n, dtype=dtype, device='meta')
  with pytest.raises(ValueError, match='shared memory'):
    LC._launch(mode, name, h, g,
               want_factor=mode in (LC._MODE_SOLVE_FACTOR, LC._MODE_FACTOR))
  with pytest.raises(ValueError, match='no wide design'):
    LC._launch(mode, name, torch.empty(1, 65, 65, dtype=dtype, device='meta'),
               None if factor else
               torch.empty(1, 65, dtype=dtype, device='meta'), design='wide')


@pytest.mark.parametrize('mode', [_K1, _K2, _K3, _K4])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_wide_design_fits_two_groups_at_n64(mode, dtype):
  """At the wide design's largest n, two matrices (kWideGroups) fit in
  the 227 KB a block may use, for every mode and type: `_launch` takes
  the wide design there with its two groups."""
  elem = torch.empty((), dtype=dtype).element_size()
  per_matrix = LC._matrix_smem_bytes(64, elem, 'wide', mode)
  assert LC._PER_BLOCK['wide'] == 2
  assert 2 * per_matrix <= LC._MAX_SMEM
  assert LC._design(64, dtype, mode) == 'wide'
