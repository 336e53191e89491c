"""Derivative rules of the port's Cholesky wrappers (linalg_cuda's
autograd Functions) against the JAX package's linalg_pallas rules.

Float64 on the CPU, where the Functions run the plain versions; the same
Functions launch the kernels on the card (tests/test_torch_cuda.py).
Forward mode: the port's `forward_ad` tangents against `jax.jvp` of
cholesky_solve_factor (K1), cholesky_resolve_const (K2) and
cholesky_solve (K3).  Reverse mode: K3's gradients against `jax.vjp`;
JAX defines no transpose for K1's and K2's custom_vmap, so their
gradients are held to the transpose of JAX's JVP by the adjoint identity
<xbar, J dg> = <J^T xbar, dg>.  Tolerance 1e-10 relative throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from dexterity_tpu.physics import linalg_pallas as LP
from dexterity_tpu_torch.physics import linalg_cuda as LC

_CASES = [((3,), 5), ((2, 3), 5), ((3,), 30), ((2, 3), 30)]
_RTOL = 1e-10


def _inputs(seed, batch, n):
  """SPD h, rhs g, tangents dh (not symmetric) and dg, cotangent xbar."""
  rng = np.random.RandomState(seed)
  a = rng.randn(*batch, n, n)
  h = np.einsum('...ij,...kj->...ik', a, a) / n + np.eye(n)
  return (h, rng.randn(*batch, n), rng.randn(*batch, n, n),
          rng.randn(*batch, n), rng.randn(*batch, n))


def _t(x):
  return torch.as_tensor(x, dtype=torch.float64)


def _vmapped(f, batch):
  for _ in batch:
    f = jax.vmap(f)
  return jax.jit(f)


def _close(got, want):
  want = np.asarray(want)
  err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
  assert err < _RTOL, err


def _jvp(fn, primals, tangents):
  """The port's forward-mode tangent of fn's first output."""
  with forward_ad.dual_level():
    out = fn(*(forward_ad.make_dual(_t(p), _t(t))
               for p, t in zip(primals, tangents)))
    out = out[0] if isinstance(out, tuple) else out
    return forward_ad.unpack_dual(out).tangent.numpy()


def _grads(fn, primals, xbar):
  args = [_t(p).requires_grad_() for p in primals]
  out = fn(*args)
  out = out[0] if isinstance(out, tuple) else out
  gs = torch.autograd.grad(out, args, _t(xbar), allow_unused=True)
  return [None if g is None else g.numpy() for g in gs]


@pytest.mark.parametrize('batch,n', _CASES)
def test_solve_factor_jvp_matches_jax(batch, n):
  """K1: dx = H^-1 dg with dH dropped, as linalg_pallas.py:253-259."""
  h, g, dh, dg, _ = _inputs(0, batch, n)
  f = _vmapped(lambda hh, gg, th, tg: jax.jvp(
      lambda a, b: LP.cholesky_solve_factor(a, b)[0], (hh, gg),
      (th, tg))[1], batch)
  want = f(jnp.asarray(h), jnp.asarray(g), jnp.asarray(dh), jnp.asarray(dg))
  _close(_jvp(LC.cholesky_solve_factor, (h, g), (dh, dg)), want)


@pytest.mark.parametrize('batch,n', _CASES)
def test_resolve_const_jvp_matches_jax(batch, n):
  """K2: dx = solve(fac, dg), dfac dropped.  JAX's CPU "factor" is the
  matrix itself; the port's is the packed factor of the same matrix."""
  h, g, dh, dg, _ = _inputs(1, batch, n)
  f = _vmapped(lambda hh, gg, th, tg: jax.jvp(
      LP.cholesky_resolve_const, (hh, gg), (th, tg))[1], batch)
  want = f(jnp.asarray(h), jnp.asarray(g), jnp.asarray(dh), jnp.asarray(dg))
  fac = LC.factor_plain(_t(h)).numpy()
  _close(_jvp(LC.cholesky_resolve_const, (fac, g), (dh, dg)), want)


@pytest.mark.parametrize('batch,n', _CASES)
def test_solve_jvp_matches_jax(batch, n):
  """K3: dx = H^-1 (dg - dH x) (custom_linear_solve, symmetric)."""
  h, g, dh, dg, _ = _inputs(2, batch, n)
  f = _vmapped(lambda hh, gg, th, tg: jax.jvp(
      LP.cholesky_solve, (hh, gg), (th, tg))[1], batch)
  want = f(jnp.asarray(h), jnp.asarray(g), jnp.asarray(dh), jnp.asarray(dg))
  _close(_jvp(LC.cholesky_solve, (h, g), (dh, dg)), want)


@pytest.mark.parametrize('batch,n', _CASES)
def test_solve_gradients_match_jax_vjp(batch, n):
  """K3's cotangents: gbar = H^-1 xbar, Hbar = -gbar x^T."""
  h, g, _, _, xbar = _inputs(3, batch, n)
  f = _vmapped(lambda hh, gg, xb: jax.vjp(LP.cholesky_solve, hh, gg)[1](xb),
               batch)
  want_h, want_g = f(jnp.asarray(h), jnp.asarray(g), jnp.asarray(xbar))
  got_h, got_g = _grads(LC.cholesky_solve, (h, g), xbar)
  _close(got_g, want_g)
  _close(got_h, want_h)


@pytest.mark.parametrize('batch,n', _CASES)
@pytest.mark.parametrize('name', ['cholesky_solve_factor',
                                  'cholesky_resolve_const'])
def test_k1_k2_gradients_are_the_transpose_of_jax_jvp(batch, n, name):
  """K1's and K2's gradients: none to the matrix (factor), and to g the
  transpose of JAX's JVP in g, by <xbar, J dg> = <J^T xbar, dg>."""
  h, g, _, dg, xbar = _inputs(4, batch, n)
  jfn = (lambda a, b: LP.cholesky_solve_factor(a, b)[0]) \
      if name == 'cholesky_solve_factor' else LP.cholesky_resolve_const
  f = _vmapped(lambda hh, gg, tg: jax.jvp(
      jfn, (hh, gg), (jnp.zeros_like(hh), tg))[1], batch)
  jdx = np.asarray(f(jnp.asarray(h), jnp.asarray(g), jnp.asarray(dg)))
  first = h if name == 'cholesky_solve_factor' else \
      LC.factor_plain(_t(h)).numpy()
  got_first, got_g = _grads(getattr(LC, name), (first, g), xbar)
  assert got_first is None
  lhs = np.sum(xbar * jdx, -1)
  rhs = np.sum(got_g * dg, -1)
  np.testing.assert_allclose(rhs, lhs, rtol=_RTOL,
                             atol=_RTOL * np.abs(lhs).max())


def test_k1_tangent_drops_dh_unlike_the_exact_derivative():
  """K1's tangent is H^-1 dg, not the exact H^-1 (dg - dH x) that forward
  AD through the plain loop gives: on a seeded 5 x 5 batch the two differ
  well beyond rounding, and K3 (no dH dropped) gives the exact one
  (symmetric dH)."""
  h, g, dh, dg, _ = _inputs(5, (3,), 5)
  dh = dh + np.swapaxes(dh, -1, -2)   # the plain loop reads one triangle
  rule = _jvp(LC.cholesky_solve_factor, (h, g), (dh, dg))
  exact = _jvp(LC.solve_factor_plain, (h, g), (dh, dg))
  x = np.linalg.solve(h, g[..., None])[..., 0]
  _close(rule, np.linalg.solve(h, dg[..., None])[..., 0])
  _close(exact, np.linalg.solve(h, (dg - np.einsum('...ij,...j->...i', dh,
                                                     x))[..., None])[..., 0])
  assert np.abs(rule - exact).max() > 1e-3
  _close(_jvp(LC.cholesky_solve, (h, g), (dh, dg)), exact)


@pytest.mark.parametrize('name', ['cholesky_resolve', 'cholesky_factor'])
def test_functions_without_a_rule_raise_on_a_derivative(name):
  """cholesky_resolve and cholesky_factor have no rule in the JAX
  package: a tangent or a gradient reaching them raises."""
  h, g, dh, dg, _ = _inputs(6, (3,), 5)
  fac = LC.factor_plain(_t(h))
  call = ((lambda a, b: LC.cholesky_factor(a)) if name == 'cholesky_factor'
          else LC.cholesky_resolve)
  first = _t(h) if name == 'cholesky_factor' else fac
  first_t = _t(dh)
  with forward_ad.dual_level():
    with pytest.raises(RuntimeError, match='derivative'):
      call(forward_ad.make_dual(first, first_t), _t(g))
    if name == 'cholesky_resolve':
      with pytest.raises(RuntimeError, match='derivative'):
        call(first, forward_ad.make_dual(_t(g), _t(dg)))
  with pytest.raises(RuntimeError, match='derivative'):
    call(first.clone().requires_grad_(), _t(g))
  call(first, _t(g))                  # no derivative: runs
  with torch.no_grad():
    call(first.clone().requires_grad_(), _t(g))


@pytest.mark.parametrize('mode,name', [
    (LC._MODE_SOLVE_FACTOR, 'cholesky_solve_factor'),
    (LC._MODE_RESOLVE, 'cholesky_resolve_const'),
    (LC._MODE_SOLVE, 'cholesky_solve')])
def test_launch_refuses_a_dual_operand(monkeypatch, mode, name):
  """`_launch` raises on an operand with a forward tangent or one that
  requires grad, before any build or card call: no launch drops a
  derivative."""
  def no_build(*_):
    raise AssertionError('the guard should have raised before a build')
  monkeypatch.setattr(LC.cuda_build, 'build_all', no_build)
  monkeypatch.setattr(LC, '_fns', {})
  h, g, dh, dg, _ = _inputs(7, (2,), 4)
  with forward_ad.dual_level():
    with pytest.raises(RuntimeError, match='derivative'):
      LC._launch(mode, name, _t(h), forward_ad.make_dual(_t(g), _t(dg)))
    with pytest.raises(RuntimeError, match='derivative'):
      LC._launch(mode, name, forward_ad.make_dual(_t(h), _t(dh)), _t(g))
  with pytest.raises(RuntimeError, match='derivative'):
    LC._launch(mode, name, _t(h).requires_grad_(), _t(g))


@pytest.mark.parametrize('name', ['cholesky_solve_factor',
                                  'cholesky_resolve_const', 'cholesky_solve'])
def test_rules_count_no_launch_on_the_cpu(name):
  """On CPU tensors the Functions run the plain versions, the tangent
  included, and count no kernel launch."""
  LC.reset_launches()
  h, g, dh, dg, _ = _inputs(8, (3,), 6)
  first = LC.factor_plain(_t(h)).numpy() \
      if name == 'cholesky_resolve_const' else h
  _jvp(getattr(LC, name), (first, g), (np.zeros_like(dh), dg))
  assert all(v == 0 for v in LC.launches.values())
