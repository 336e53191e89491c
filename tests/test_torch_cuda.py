"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

This file imports neither jax nor the JAX package, so on a machine with a
card and no jax it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dexterity_tpu_torch.physics import linalg_cuda as LC


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
                         'cholesky_resolve_const': 1, 'cholesky_solve': 1}


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
