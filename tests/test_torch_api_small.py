"""The port's small public helpers against the JAX package's (CPU,
float64): the workspace sites, the `MujocoEffector` alias, the identity
quaternion, the plane helpers of the narrow phase, the rank-polymorphic
Cholesky names and the `Arena.attach_offset` alias."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu.core import serialization as jser
from dexterity_tpu.core import spec as jspec
from dexterity_tpu.manipulation.shared import workspaces as jws
from dexterity_tpu.models import arenas as jarenas
from dexterity_tpu.physics import linalg_pallas as LP
from dexterity_tpu.physics import math as jmath
from dexterity_tpu.physics.collision import soa as jsoa
from dexterity_tpu_torch import effectors
from dexterity_tpu_torch.core import serialization as pser
from dexterity_tpu_torch.core import spec as pspec
from dexterity_tpu_torch.effectors import mujoco_actuation
from dexterity_tpu_torch.manipulation.shared import workspaces as pws
from dexterity_tpu_torch.models import arenas as parenas
from dexterity_tpu_torch.physics import linalg_cuda as LC
from dexterity_tpu_torch.physics import math as pmath
from dexterity_tpu_torch.physics.collision import soa as psoa


def _site_fields(site):
  """A site's fields as plain values (enums as ints, arrays as lists)."""
  out = {}
  for f in dataclasses.fields(site):
    v = getattr(site, f.name)
    out[f.name] = np.asarray(v).tolist() if not isinstance(v, str) else v
  return out


_SITES = [
    ('bbox', dict(lower=(-0.1, 0.2, 0.0), upper=(0.3, 0.2, 0.5))),
    ('bbox', dict(lower=[0, 0, 0], upper=[1, 2, 3], visible=True,
                  name='box', rgba=(0.1, 0.2, 0.3, 0.4))),
    ('target', dict(radius=0.05)),
    ('target', dict(radius=0.2, visible=True, name='goal',
                    rgba=[0, 0, 1, 1])),
]


@pytest.mark.parametrize('kind,kw', _SITES)
def test_workspace_sites_match_jax(kind, kw):
  """The same site on a fresh body, field by field: a flat bbox side
  takes the minimum dimension, a hidden site the task-site group."""
  fn = 'add_bbox_site' if kind == 'bbox' else 'add_target_site'
  jbody, pbody = jspec.BodySpec(name='b'), pspec.BodySpec(name='b')
  jsite = getattr(jws, fn)(jbody, **kw)
  psite = getattr(pws, fn)(pbody, **kw)
  assert pbody.sites == [psite] and len(jbody.sites) == 1
  assert _site_fields(psite) == _site_fields(jsite)


@pytest.mark.parametrize('fn,kw', [
    ('add_bbox_site', dict(lower=(0, 1, 0), upper=(1, 0, 1))),
    ('add_target_site', dict(radius=0.0)),
    ('add_target_site', dict(radius=-1.0)),
])
def test_workspace_sites_assert_on_bad_input(fn, kw):
  for mod, spec in ((jws, jspec), (pws, pspec)):
    with pytest.raises(AssertionError):
      getattr(mod, fn)(spec.BodySpec(name='b'), **kw)


def test_mujoco_effector_is_actuator_effector():
  assert mujoco_actuation.MujocoEffector is mujoco_actuation.ActuatorEffector
  assert effectors.MujocoEffector is effectors.ActuatorEffector


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_quat_identity(dtype):
  q = pmath.quat_identity(dtype, device='cpu')
  assert q.dtype == dtype and q.device.type == 'cpu'
  assert q.tolist() == [1.0, 0.0, 0.0, 0.0]
  assert q.tolist() == np.asarray(jmath.quat_identity()).tolist()
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='no CUDA device'):
      pmath.quat_identity(dtype)


@pytest.mark.parametrize('shape', [(4, 3), (4, 3, 3)])
def test_plane_helpers_round_trip(shape):
  """vec3 / mat3 give JAX's planes; stack_v3 of vec3 is the input."""
  a = np.random.RandomState(len(shape)).randn(*shape)
  t = torch.as_tensor(a)
  split = psoa.vec3 if len(shape) == 2 else psoa.mat3
  jsplit = jsoa.vec3 if len(shape) == 2 else jsoa.mat3
  planes, jplanes = split(t), jsplit(jnp.asarray(a))
  assert len(planes) == len(jplanes) == (3 if len(shape) == 2 else 9)
  for p, jp in zip(planes, jplanes):
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
  if len(shape) == 2:
    assert torch.equal(psoa.stack_v3(planes), t)
  else:
    rows = [psoa.stack_v3(planes[3 * i:3 * i + 3]) for i in range(3)]
    assert torch.equal(torch.stack(rows, dim=-2), t)


@pytest.mark.parametrize('batch', [(6,), (3, 5)])
def test_rank_polymorphic_cholesky_names_match_jax(batch):
  """cholesky_factor_b / cholesky_resolve_b are the port's pair itself;
  on the CPU their solution agrees with JAX's cholesky_solve and with
  JAX's own _b pair, to 1e-10, at n = 30."""
  assert LC.cholesky_factor_b is LC.cholesky_factor
  assert LC.cholesky_resolve_b is LC.cholesky_resolve
  n = 30
  rng = np.random.RandomState(len(batch))
  a = rng.randn(*batch, n, n)
  h = np.einsum('...ij,...kj->...ik', a, a) + 3 * np.eye(n)
  g = rng.randn(*batch, n)
  x = LC.cholesky_resolve_b(LC.cholesky_factor_b(torch.as_tensor(h)),
                            torch.as_tensor(g)).numpy()
  solve = LP.cholesky_solve
  for _ in batch:
    solve = jax.vmap(solve)
  hj, gj = jnp.asarray(h), jnp.asarray(g)
  for ref in (solve(hj, gj),
              LP.cholesky_resolve_b(LP.cholesky_factor_b(hj), gj)):
    np.testing.assert_allclose(x, np.asarray(ref), rtol=0, atol=1e-10)


class _Entity:
  """An entity as the arenas take one: a spec with one body and a geom."""

  def __init__(self, spec_mod, name):
    self.name = name
    self.spec = spec_mod.ModelSpec(name=name)
    body = self.spec.worldbody.add_body('root', pos=np.array([0.0, 0.1, 0.2]))
    body.add_geom('box', type=spec_mod.GeomType.BOX,
                  size=np.array([0.01, 0.02, 0.03]))


def test_arena_attach_offset_is_attach():
  """`Arena.attach_offset` is `attach` in both packages (the reference's
  name), and attaching an entity by it at an offset gives the JAX
  package's spec (as `spec_to_dict` writes it) and prefix."""
  assert parenas.Arena.attach_offset is parenas.Arena.attach
  assert jarenas.Arena.attach_offset is jarenas.Arena.attach
  out = {}
  for key, arenas, spec_mod, ser in (('jax', jarenas, jspec, jser),
                                     ('port', parenas, pspec, pser)):
    arena = arenas.Standard()
    prefix = arena.attach_offset(_Entity(spec_mod, 'cube'), pos=(0.1, 0, 0.3),
                                 quat=(0.0, 1.0, 0.0, 0.0))
    out[key] = (prefix, ser.spec_to_dict(arena.spec))
  assert out['port'][0] == out['jax'][0] == 'cube/'
  assert out['port'][1] == out['jax'][1]
