"""The port's render-mesh assets, the hands' mesh join and the export with
meshes, against the JAX package (on the CPU).

The registry and the 70 STL files are byte-equal copies; each hand's
`spec.meshes` and geom mesh provenance equal the JAX hand's; the join
changes no field of the compiled Model; `export_mjcf(include_meshes=True)`
equals JAX's text once each package's assets root is replaced in the
`file` attributes.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.mjcf import export as jexport
from dexterity_tpu.models import hands as jhands
from dexterity_tpu.models import meshes as jmeshes
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import serialization as pser
from dexterity_tpu_torch.mjcf import export as pexport
from dexterity_tpu_torch.mjcf import stl as pstl
from dexterity_tpu_torch.models import hands as phands
from dexterity_tpu_torch.models import meshes as pmeshes

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_J_ASSETS = os.path.join(_ROOT, 'dexterity_tpu', 'models', 'assets')
_P_ASSETS = os.path.join(_ROOT, 'dexterity_tpu_torch', 'models', 'assets')
_MODELS = ('adroit_hand', 'mpl_left', 'mpl_right', 'shadow_hand_e')


def _hands(kind):
  if kind == 'adroit':
    return jhands.AdroitHand(), phands.AdroitHand()
  if kind == 'shadow':
    return jhands.ShadowHandSeriesE(), phands.ShadowHandSeriesE()
  side = kind.split('_')[1].upper()
  return (jhands.MPLHand(side=jhands.HandSide[side]),
          phands.MPLHand(side=phands.HandSide[side]))


def _specs(name):
  """JAX's and the port's spec of a hand or of a task's arena."""
  if name.endswith('_arena'):
    domain = name[:-len('_arena')]
    return (jmanip.build_task(domain, 'state_dense').arena.spec,
            pmanip.build_task(domain, 'state_dense').arena.spec)
  jh, ph = _hands(name)
  return jh.spec, ph.spec


def test_registry_copy_is_byte_equal():
  assert filecmp.cmp(os.path.join(_J_ASSETS, 'mesh_registry.json'),
                     os.path.join(_P_ASSETS, 'mesh_registry.json'),
                     shallow=False)
  assert pmeshes.registry() == jmeshes.registry()


@pytest.mark.parametrize('model', _MODELS)
def test_stl_copies_are_byte_equal(model):
  jdir = os.path.join(_J_ASSETS, 'meshes', model)
  pdir = os.path.join(_P_ASSETS, 'meshes', model)
  names = sorted(os.listdir(jdir))
  assert names and sorted(os.listdir(pdir)) == names
  match, mismatch, errors = filecmp.cmpfiles(jdir, pdir, names,
                                             shallow=False)
  assert (mismatch, errors) == ([], [])
  assert len(match) == len(names)


def test_every_registry_file_resolves_under_the_port():
  reg = pmeshes.registry()
  assert len(reg) == 70
  for key, ent in reg.items():
    path = pmeshes.asset_path(ent['file'])
    assert path.startswith(_P_ASSETS + os.sep) and os.path.isfile(path), key
    assert np.isfinite(pstl.load_stl_vertices(path)).all(), key
  assert pmeshes.asset_path('/abs/x.stl') == '/abs/x.stl'


@pytest.mark.parametrize('kind', ['adroit', 'mpl_left', 'mpl_right',
                                  'shadow'])
def test_hand_mesh_join_matches_jax(kind):
  """spec.meshes and every geom's mesh provenance equal JAX's."""
  jh, ph = _hands(kind)
  assert ph.spec.meshes
  assert ({k: dataclasses.asdict(m) for k, m in ph.spec.meshes.items()}
          == {k: dataclasses.asdict(m) for k, m in jh.spec.meshes.items()})

  def provenance(spec):
    return [(g.name, g.mesh) for b in spec.worldbody.walk()
            for g in b.geoms]

  assert provenance(ph.spec) == provenance(jh.spec)


@pytest.mark.parametrize('asset', ['adroit_hand.json', 'mpl_right.json',
                                   'shadow_hand_e.json'])
def test_mesh_join_changes_no_model_field(asset):
  """The compiled Model is the same with and without the join."""
  path = os.path.join(_P_ASSETS, asset)
  plain = pser.load_spec(path)
  joined = pser.load_spec(path)
  pmeshes.attach_mesh_assets(joined, os.path.splitext(asset)[0])
  assert joined.meshes and not plain.meshes
  a = plain.compile(device='cpu', dtype=torch.float64)
  b = joined.compile(device='cpu', dtype=torch.float64)
  for f in dataclasses.fields(a):
    x, y = getattr(a, f.name), getattr(b, f.name)
    if isinstance(x, torch.Tensor):
      assert torch.equal(x, y), f.name
    elif dataclasses.is_dataclass(x):
      for g in dataclasses.fields(x):
        u, v = getattr(x, g.name), getattr(y, g.name)
        assert (torch.equal(u, v) if isinstance(u, torch.Tensor)
                else u == v), g.name
    else:
      assert x == y, f.name


@pytest.mark.parametrize('name', ['reorient_arena', 'reach_arena', 'shadow',
                                  'adroit', 'mpl_right'])
def test_export_with_meshes_matches_jax(name):
  jspec, pspec = _specs(name)
  want = jexport.export_mjcf(jspec, keep_visual=True, include_meshes=True)
  got = pexport.export_mjcf(pspec, keep_visual=True, include_meshes=True)
  assert f'file="{_P_ASSETS}{os.sep}meshes{os.sep}' in got
  assert _J_ASSETS not in got
  assert got.replace(_P_ASSETS, _J_ASSETS) == want
  # The default export is the primitives-only text, as before.
  assert pexport.export_mjcf(pspec) == jexport.export_mjcf(jspec)
