"""The port's MJCF toolchain (STL reader, primitive fit, parser, export)
against the JAX package, on the CPU in float64.

Compiled models are held field for field as tests/test_torch_model.py
holds them (static structure and names exactly, arrays to 1e-12, inverse
weights to rtol 1e-9).  Export text is held equal character for
character: both packages print from float64 values (the JAX tests run
with x64 on, the port's export compiles in float64 on the CPU).
"""

import ast
import os
import struct

import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.mjcf import export as jexport
from dexterity_tpu.mjcf import parser as jparser
from dexterity_tpu.mjcf import primitive_fit as jfit
from dexterity_tpu.mjcf import stl as jstl
from dexterity_tpu.models import hands as jhands
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import spec as PS
from dexterity_tpu_torch.mjcf import export as pexport
from dexterity_tpu_torch.mjcf import parser as pparser
from dexterity_tpu_torch.mjcf import primitive_fit as pfit
from dexterity_tpu_torch.mjcf import stl as pstl
from dexterity_tpu_torch.models import hands as phands
from test_torch_model import _compare_models

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MESHES = os.path.join(_ROOT, 'dexterity_tpu', 'models', 'assets', 'meshes')
_VENDOR_STLS = ('adroit_hand/F1.stl', 'shadow_hand_e/palm.stl',
                'mpl_right/index0.stl')
F64 = dict(device='cpu', dtype=torch.float64)

_HANDS = {
    'shadow': (jhands.ShadowHandSeriesE, phands.ShadowHandSeriesE),
    'adroit': (jhands.AdroitHand, phands.AdroitHand),
    'mpl_right': (jhands.MPLHand, phands.MPLHand),
}


def _weld_xmls():
  """ANCHOR_XML and CONNECT_XML of tests/test_weld_mocap.py, read from the
  file (importing it would import MuJoCo)."""
  path = os.path.join(_ROOT, 'tests', 'test_weld_mocap.py')
  tree = ast.parse(open(path).read())
  consts = {}
  for node in tree.body:
    if (isinstance(node, ast.Assign) and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name)
        and node.targets[0].id == 'ANCHOR_XML'):
      consts['anchor'] = ast.literal_eval(node.value)
  anchor = consts['anchor']
  connect = anchor.replace(
      '''<weld body1="A2" body2="B" anchor="0.01 0.02 0.03"
          relpose="0.005 -0.01 0.02  0.96 0.2 0.16 0.12" torquescale="0.7"/>''',
      '<connect body1="A2" body2="B" anchor="0.015 -0.01 0.02"/>')
  assert connect != anchor
  return {'anchor': anchor, 'connect': connect}


def _specs(name):
  """JAX's and the port's spec of a hand, or of the reorient arena."""
  if name == 'reorient_arena':
    return (jmanip.build_task('reorient', 'state_dense').arena.spec,
            pmanip.build_task('reorient', 'state_dense').arena.spec)
  jcls, pcls = _HANDS[name]
  return jcls().spec, pcls().spec


# ---------------------------------------------------------------------------
# STL and primitive fit
# ---------------------------------------------------------------------------


def _triangles(seed, n=40):
  return np.random.default_rng(seed).normal(size=(n, 3, 3)).astype(np.float32)


def _write_binary(path, tris, header=b'binary stl'):
  with open(path, 'wb') as f:
    f.write(header.ljust(80, b' '))
    f.write(struct.pack('<I', len(tris)))
    for t in tris:
      f.write(struct.pack('<3f', 0, 0, 1))
      f.write(t.astype('<f4').tobytes())
      f.write(b'\0\0')


def _write_ascii(path, tris):
  with open(path, 'w') as f:
    f.write('solid test\n')
    for t in tris:
      f.write('  facet normal 0 0 1\n    outer loop\n')
      for v in t:
        f.write(f'      vertex {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n')
      f.write('    endloop\n  endfacet\n')
    f.write('endsolid test\n')


@pytest.mark.parametrize('kind', ['binary', 'binary_solid_header', 'ascii'])
def test_stl_vertices_match_jax(tmp_path, kind):
  tris = _triangles(1)
  path = str(tmp_path / f'{kind}.stl')
  if kind == 'ascii':
    _write_ascii(path, tris)
  else:
    # A binary file whose header starts with 'solid' takes the ASCII
    # attempt first and falls back.
    _write_binary(path, tris, b'solid but binary' if 'solid' in kind
                  else b'binary stl')
  got, want = pstl.load_stl_vertices(path), jstl.load_stl_vertices(path)
  assert got.dtype == np.float64 and got.shape == want.shape
  assert got.shape[0] == np.unique(tris.reshape(-1, 3), axis=0).shape[0]
  np.testing.assert_array_equal(got, want)


def _fits_equal(got, want):
  assert len(got) == len(want)
  for a, b in zip(got, want):
    assert int(a.type) == int(b.type)
    for f in ('pos', 'quat', 'size'):
      np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0,
                                 atol=1e-12, err_msg=f)
    assert a.fit_error == pytest.approx(b.fit_error, rel=1e-12, abs=1e-15)


@pytest.mark.parametrize('shape', ['box', 'rod', 'blob', 'l_shape'])
def test_fit_primitives_match_jax_on_seeded_clouds(shape):
  rng = np.random.default_rng(4)
  if shape == 'box':
    pts = rng.uniform(-1, 1, (400, 3)) * [0.03, 0.01, 0.02]
  elif shape == 'rod':
    pts = rng.normal(size=(400, 3)) * [0.05, 0.008, 0.008]
  elif shape == 'blob':
    pts = rng.normal(size=(400, 3)) * 0.01
  else:
    pts = np.concatenate([rng.uniform(0, 1, (200, 3)) * [0.08, 0.01, 0.01],
                          rng.uniform(0, 1, (200, 3)) * [0.01, 0.06, 0.01]])
  rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
  pts = pts @ rot.T + [0.1, -0.2, 0.05]
  got = pfit.fit_primitives(pts, scale=1.5)
  _fits_equal(got, jfit.fit_primitives(pts, scale=1.5))
  _fits_equal([pfit.fit_primitive(pts)], [jfit.fit_primitive(pts)])
  if shape == 'l_shape':
    assert len(got) > 1      # the split branch ran


@pytest.mark.parametrize('rel', _VENDOR_STLS)
def test_fit_primitives_match_jax_on_vendor_meshes(rel):
  path = os.path.join(_MESHES, rel)
  verts = pstl.load_stl_vertices(path)
  np.testing.assert_array_equal(verts, jstl.load_stl_vertices(path))
  _fits_equal(pfit.fit_primitives(verts, scale=1e-3),
              jfit.fit_primitives(verts, scale=1e-3))


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('which', ['anchor', 'connect'])
def test_parser_weld_xmls_compile_to_jax_model(which):
  xml = _weld_xmls()[which]
  jm = jparser.load_mjcf_string(xml).compile()
  pm = pparser.load_mjcf_string(xml).compile(**F64)
  _compare_models(jm, pm)
  assert pm.neq == 1


@pytest.mark.parametrize('hand', sorted(_HANDS))
def test_parser_on_jax_hand_export_compiles_to_jax_model(hand):
  xml = jexport.export_mjcf(_specs(hand)[0], keep_visual=True)
  jm = jparser.load_mjcf_string(xml).compile()
  pm = pparser.load_mjcf_string(xml).compile(**F64)
  _compare_models(jm, pm)


_MESH_XML = """
<mujoco model="included">
  <compiler angle="degree" meshdir="meshes"/>
  <option timestep="0.004" gravity="0 0 -9.81"/>
  <include file="defaults.xml"/>
  <asset>
    <mesh name="link" file="link.stl" scale="0.001 0.001 0.001"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1"/>
    <body name="base" pos="0 0 0.2" childclass="arm">
      <inertial pos="0 0 0" mass="0.5" diaginertia="0.001 0.001 0.001"/>
      <joint name="j0" axis="0 0 1" range="-90 90"/>
      <geom name="base_geom" type="box" size="0.02 0.02 0.02"/>
      <body name="link1" pos="0 0 0.05" euler="0 30 0">
        <joint name="j1" class="stiff"/>
        <geom name="link1_mesh" type="mesh" mesh="link"/>
        <geom name="link1_visual" class="visual" type="capsule"
              fromto="0 0 0 0 0 0.05" size="0.01"/>
        <site name="tip" pos="0 0 0.06"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t0">
      <joint joint="j0" coef="1"/>
      <joint joint="j1" coef="-0.5"/>
    </fixed>
  </tendon>
  <actuator>
    <position name="a0" joint="j0" kp="5" ctrlrange="-1 1"/>
    <motor name="a1" tendon="t0" gear="2"/>
  </actuator>
  <equality>
    <joint joint1="j1" joint2="j0" polycoef="0 0.5 0 0 0"/>
  </equality>
  <contact>
    <pair geom1="floor" geom2="link1_mesh" condim="3"/>
    <exclude body1="base" body2="link1"/>
  </contact>
</mujoco>
"""

_DEFAULTS_XML = """
<mujoco>
  <default>
    <joint damping="0.1" armature="0.01"/>
    <geom friction="0.8 0.01 0.001" density="500"/>
    <default class="arm">
      <joint axis="0 1 0" range="-45 45" damping="0.2"/>
      <geom rgba="0.2 0.3 0.4 1" margin="0.001"/>
      <default class="stiff">
        <joint stiffness="3" damping="0.5"/>
      </default>
      <default class="visual">
        <geom contype="0" conaffinity="0" group="2"/>
      </default>
    </default>
  </default>
</mujoco>
"""


def _mesh_scene(tmp_path):
  """An MJCF with <include>, nested default classes, childclass and a
  collision mesh geom (a seeded elongated vertex cloud as triangles)."""
  (tmp_path / 'meshes').mkdir()
  rng = np.random.default_rng(8)
  verts = rng.normal(size=(300, 3)) * [8.0, 8.0, 30.0] + [0, 0, 25.0]
  _write_binary(str(tmp_path / 'meshes' / 'link.stl'),
                verts[:300].reshape(100, 3, 3).astype(np.float32))
  (tmp_path / 'defaults.xml').write_text(_DEFAULTS_XML)
  path = tmp_path / 'scene.xml'
  path.write_text(_MESH_XML)
  return str(path)


def test_parser_include_defaults_and_fitted_mesh_compile_to_jax_model(
    tmp_path):
  path = _mesh_scene(tmp_path)
  jspec, pspec = jparser.load_mjcf(path), pparser.load_mjcf(path)
  jm, pm = jspec.compile(), pspec.compile(**F64)
  _compare_models(jm, pm)
  # The defaults, the class and the fitted mesh reached the model.
  j1 = pspec.worldbody.children[0].children[0].joints[0]
  assert (j1.stiffness, j1.damping, j1.armature) == (3.0, 0.5, 0.01)
  assert np.allclose(j1.axis, [0, 1, 0]) and np.allclose(
      j1.range, np.deg2rad([-45, 45]))
  link1 = pspec.worldbody.children[0].children[0]
  mesh_geoms = [g for g in link1.geoms if g.mesh == 'link']
  assert mesh_geoms and mesh_geoms[0].name == 'link1_mesh'
  assert int(mesh_geoms[0].type) != int(PS.GeomType.MESH)
  assert pm.ntendon == 1 and pm.nu == 2 and pm.neq == 1


def test_load_mjcf_string_leaves_no_file(tmp_path, monkeypatch):
  import tempfile
  monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
  pparser.load_mjcf_string(_weld_xmls()['anchor'])
  assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


_EXPORTS = sorted(_HANDS) + ['reorient_arena']


@pytest.mark.parametrize('name', _EXPORTS)
def test_export_text_matches_jax(name):
  jspec, pspec = _specs(name)
  for keep_visual in (False, True):
    assert (pexport.export_mjcf(pspec, keep_visual=keep_visual)
            == jexport.export_mjcf(jspec, keep_visual=keep_visual))
  # The hands carry render meshes; only include_meshes=True emits them
  # (its text against JAX's: tests/test_torch_meshes.py).
  assert pspec.meshes
  with_meshes = pexport.export_mjcf(pspec, include_meshes=True)
  assert '<mesh ' in with_meshes and '<mesh ' not in pexport.export_mjcf(
      pspec)


@pytest.mark.parametrize('name', _EXPORTS)
def test_export_for_conformance_text_matches_jax(name):
  jspec, pspec = _specs(name)
  assert (pexport.export_for_conformance(pspec)
          == jexport.export_for_conformance(jspec))


def test_export_for_conformance_does_not_change_the_spec():
  _, pspec = _specs('adroit')
  before = pexport.export_mjcf(pspec, keep_visual=True)
  pexport.export_for_conformance(pspec)
  assert pexport.export_mjcf(pspec, keep_visual=True) == before


def test_export_include_meshes_raises_on_a_spec_with_meshes():
  """It no longer raises: include_meshes=True emits a mesh asset the spec
  adds, with its file resolved under the port's assets, and the default
  export is unchanged by it."""
  _, pspec = _specs('adroit')
  pspec.meshes['extra/F1'] = PS.MeshSpec(name='extra/F1',
                                         file='meshes/adroit_hand/F1.stl')
  geom = next(g for b in pspec.worldbody.walk() for g in b.geoms
              if g.mesh == 'adroit_hand/F1')
  geom.mesh = 'extra/F1'
  xml = pexport.export_mjcf(pspec, include_meshes=True)
  path = os.path.join(_ROOT, 'dexterity_tpu_torch', 'models', 'assets',
                      'meshes', 'adroit_hand', 'F1.stl')
  assert f'<mesh name="extra/F1" file="{path}"' in xml
  assert pexport.export_mjcf(pspec) == pexport.export_mjcf(
      _specs('adroit')[1])


def test_port_export_compiles_in_mujoco():
  """The port's exports compile in MuJoCo with the port's dimensions
  (tests/test_serialization_export.py's checks)."""
  mujoco = pytest.importorskip('mujoco')
  _, pspec = _specs('shadow')
  pm = pspec.compile(**F64)
  mm = mujoco.MjModel.from_xml_string(pexport.export_for_conformance(pspec))
  assert (mm.nq, mm.nv, mm.nu, mm.npair) == (pm.nq, pm.nv, pm.nu, pm.npair)
  task = pmanip.build_task('reach', 'state_dense')
  mm = mujoco.MjModel.from_xml_string(pexport.export_mjcf(task.arena.spec))
  assert mm.nu == 24
