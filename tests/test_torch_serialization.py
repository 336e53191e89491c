"""The port's ModelSpec writer against the JAX package's (CPU, float64).

For the four hand specs and for juggle's composed task spec with one
explicit contact pair added (so that one spec carries meshes, equalities,
pairs, excludes and pruned pairs, and every branch of `spec_to_dict`
runs): the port's `spec_to_dict` equals JAX's, the two `save_spec` files
are byte-equal, and the written file loads back into a spec that compiles
to the original's model (the port's counterpart of
tests/test_serialization_export.py::test_spec_json_roundtrip).
"""

import copy
import filecmp

import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.core import serialization as jser
from dexterity_tpu.core import spec as jspec
from dexterity_tpu.models import hands as jhands
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import serialization as pser
from dexterity_tpu_torch.core import spec as pspec
from dexterity_tpu_torch.models import hands as phands

_CASES = ['adroit', 'shadow', 'mpl_left', 'mpl_right', 'juggle_with_pair']


def _juggle_with_pair(manip, spec_mod):
  spec = copy.deepcopy(manip.build_task('juggle', 'state_sparse').arena.spec)
  geoms = [g.name for b in spec.worldbody.walk() for g in b.geoms
           if g.collidable]
  spec.pairs.append(spec_mod.PairSpec(geom1=geoms[0], geom2=geoms[-1],
                                      condim=4, margin=0.001))
  return spec


def _specs(kind):
  """(JAX spec, port spec) of one case."""
  if kind == 'juggle_with_pair':
    return (_juggle_with_pair(jmanip, jspec),
            _juggle_with_pair(pmanip, pspec))
  if kind == 'adroit':
    return jhands.AdroitHand().spec, phands.AdroitHand().spec
  if kind == 'shadow':
    return jhands.ShadowHandSeriesE().spec, phands.ShadowHandSeriesE().spec
  side = kind.split('_')[1].upper()
  return (jhands.MPLHand(side=jhands.HandSide[side]).spec,
          phands.MPLHand(side=phands.HandSide[side]).spec)


@pytest.fixture(scope='module')
def specs():
  cache = {}

  def get(kind):
    if kind not in cache:
      cache[kind] = _specs(kind)
    return cache[kind]
  return get


def test_juggle_case_carries_every_part(specs):
  _, spec = specs('juggle_with_pair')
  assert (spec.meshes and spec.equalities and spec.pairs and spec.excludes
          and spec.pruned_pairs)


@pytest.mark.parametrize('kind', _CASES)
def test_spec_to_dict_matches_jax(specs, kind):
  jax_spec, port_spec = specs(kind)
  assert pser.spec_to_dict(port_spec) == jser.spec_to_dict(jax_spec)


@pytest.mark.parametrize('kind', _CASES)
def test_save_spec_is_byte_equal_to_jax(specs, kind, tmp_path):
  jax_spec, port_spec = specs(kind)
  jser.save_spec(jax_spec, str(tmp_path / 'jax.json'))
  pser.save_spec(port_spec, str(tmp_path / 'port.json'))
  assert filecmp.cmp(tmp_path / 'jax.json', tmp_path / 'port.json',
                     shallow=False)


@pytest.mark.parametrize('kind', _CASES)
def test_saved_spec_loads_and_compiles_to_the_same_model(specs, kind,
                                                          tmp_path):
  _, spec = specs(kind)
  path = str(tmp_path / 'spec.json')
  pser.save_spec(spec, path)
  m1 = spec.compile(device='cpu', dtype=torch.float64)
  m2 = pser.load_spec(path).compile(device='cpu', dtype=torch.float64)
  assert (m1.nq, m1.nu, m1.npair) == (m2.nq, m2.nu, m2.npair)
  for field in ('body_pos', 'jnt_range', 'actuator_gainprm',
                'tendon_moment'):
    assert torch.equal(getattr(m1, field), getattr(m2, field)), field
  assert m1.jnt_names == m2.jnt_names
