"""MJCF (MuJoCo XML) subset importer -> ModelSpec (port of
dexterity_tpu/mjcf/parser.py).

Replaces dm_control.mjcf for the feature subset the dexterity models use
(SURVEY.md §7 layer 1): compiler settings, nested default classes with
childclass inheritance, <include>, mesh assets, the worldbody tree (bodies,
hinge/slide/ball/free joints, primitive + mesh geoms, sites, inertials),
explicit contact pairs/excludes, fixed tendons, position/general actuators,
and joint/tendon equality couplings (MPL).

Collision mesh geoms are replaced at import time by fitted primitives
(`primitive_fit`); visual mesh geoms are kept as non-collidable markers.
This module is import-time tooling on the host — runtime code consumes only
the compiled `Model` (`spec.compile()`, on cuda unless the caller names a
device) or specs deserialized from JSON assets.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np

from dexterity_tpu_torch.core import spec as S
from dexterity_tpu_torch.core.types import (ActuatorTrn, BiasType, EqType,
                                            GeomType, JointType)
from dexterity_tpu_torch.mjcf import primitive_fit, stl

_GEOM_TYPES = {
    'plane': GeomType.PLANE, 'sphere': GeomType.SPHERE,
    'capsule': GeomType.CAPSULE, 'ellipsoid': GeomType.ELLIPSOID,
    'cylinder': GeomType.CYLINDER, 'box': GeomType.BOX, 'mesh': GeomType.MESH,
}
_JOINT_TYPES = {
    'free': JointType.FREE, 'ball': JointType.BALL,
    'slide': JointType.SLIDE, 'hinge': JointType.HINGE,
}


def _floats(s: str) -> np.ndarray:
  return np.asarray([float(x) for x in s.split()], dtype=np.float64)


class _Defaults:
  """Resolved default-class attribute maps, per element tag.

  MJCF class names are globally unique, so every named class registers in a
  shared registry; `resolve` looks the name up there (classes are usable
  from any scope, matching MuJoCo semantics).
  """

  def __init__(self, parent: Optional['_Defaults'] = None):
    self.by_tag: Dict[str, Dict[str, str]] = (
        {k: dict(v) for k, v in parent.by_tag.items()} if parent else {})
    self.registry: Dict[str, '_Defaults'] = (
        parent.registry if parent else {})

  def absorb(self, elem: ET.Element):
    for child in elem:
      if child.tag == 'default':
        name = child.get('class')
        sub = _Defaults(self)
        sub.absorb(child)
        self.registry[name] = sub
      else:
        merged = self.by_tag.setdefault(child.tag, {})
        merged.update(child.attrib)

  def resolve(self, class_name: Optional[str]) -> '_Defaults':
    if class_name is None:
      return self
    if class_name in self.registry:
      return self.registry[class_name]
    raise KeyError(f'unknown default class {class_name!r}')


class MjcfParser:

  def __init__(self, path: str, discard_visual: bool = False,
               fit_collision_meshes: bool = True):
    self.path = path
    self.dir = os.path.dirname(os.path.abspath(path))
    self.discard_visual = discard_visual
    self.fit_collision_meshes = fit_collision_meshes
    self.angle = 'degree'  # MuJoCo default
    self.meshdir = ''
    self.meshes: Dict[str, Dict] = {}   # name -> {file, scale}
    self.spec = S.ModelSpec()
    self.root_defaults = _Defaults()
    self._mesh_fit_cache: Dict[str, primitive_fit.FittedPrimitive] = {}

  # -- helpers -----------------------------------------------------------

  # Element tag -> defaults tag (MJCF defaults use <tendon> for fixed/spatial).
  _DEFAULTS_TAG = {'fixed': 'tendon', 'spatial': 'tendon',
                   'freejoint': 'joint'}

  def _attr(self, elem: ET.Element, defaults: _Defaults, key: str,
            fallback: Optional[str] = None) -> Optional[str]:
    if key in elem.attrib:
      return elem.attrib[key]
    tag = self._DEFAULTS_TAG.get(elem.tag, elem.tag)
    tag_defaults = defaults.by_tag.get(tag, {})
    return tag_defaults.get(key, fallback)

  def _angle(self, value: float) -> float:
    return np.deg2rad(value) if self.angle == 'degree' else value

  def _orientation(self, elem, defaults) -> np.ndarray:
    quat = self._attr(elem, defaults, 'quat')
    if quat is not None:
      q = _floats(quat)
      return q / np.linalg.norm(q)
    euler = self._attr(elem, defaults, 'euler')
    if euler is not None:
      e = [self._angle(v) for v in _floats(euler)]
      q = np.array([1.0, 0, 0, 0])
      for axis_idx, ang in enumerate(e):  # eulerseq default 'xyz', extrinsic
        axis = np.zeros(3)
        axis[axis_idx] = 1.0
        qa = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis])
        q = S._quat_mul_np(qa, q)
      return q / np.linalg.norm(q)
    axisangle = self._attr(elem, defaults, 'axisangle')
    if axisangle is not None:
      v = _floats(axisangle)
      axis = v[:3] / np.linalg.norm(v[:3])
      ang = self._angle(v[3])
      return np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis])
    return np.array([1.0, 0, 0, 0])

  # -- top level ---------------------------------------------------------

  def parse(self) -> S.ModelSpec:
    root = self._read_xml(self.path)
    self.spec.name = root.get('model', 'model')

    for elem in root:
      if elem.tag == 'compiler':
        self.angle = elem.get('angle', self.angle)
        self.meshdir = elem.get('meshdir', self.meshdir)
      elif elem.tag == 'option':
        if 'timestep' in elem.attrib:
          self.spec.option.timestep = float(elem.get('timestep'))
        if 'gravity' in elem.attrib:
          self.spec.option.gravity = tuple(_floats(elem.get('gravity')))
      elif elem.tag == 'default':
        self.root_defaults.absorb(elem)

    for elem in root:
      if elem.tag == 'asset':
        self._parse_assets(elem)

    for elem in root:
      if elem.tag == 'worldbody':
        self._parse_body_children(elem, self.spec.worldbody,
                                  self.root_defaults)
      elif elem.tag == 'contact':
        self._parse_contact(elem)
      elif elem.tag == 'tendon':
        self._parse_tendon(elem)
      elif elem.tag == 'actuator':
        self._parse_actuator(elem)
      elif elem.tag == 'equality':
        self._parse_equality(elem)
      # sensors/visual/size: not needed for physics; observables are
      # first-class in the task layer instead.
    return self.spec

  def _read_xml(self, path: str) -> ET.Element:
    tree = ET.parse(path)
    root = tree.getroot()
    self._inline_includes(root, os.path.dirname(os.path.abspath(path)))
    return root

  def _inline_includes(self, elem: ET.Element, base: str):
    # <include file="..."/> splices the included root's children in place.
    for parent in elem.iter():
      while True:
        idx = None
        for i, child in enumerate(list(parent)):
          if child.tag == 'include':
            idx = i
            break
        if idx is None:
          break
        inc = list(parent)[idx]
        inc_path = os.path.join(base, inc.get('file'))
        inc_root = ET.parse(inc_path).getroot()
        parent.remove(inc)
        for j, sub in enumerate(list(inc_root)):
          parent.insert(idx + j, sub)

  def _parse_assets(self, elem: ET.Element):
    defaults = self.root_defaults
    for child in elem:
      if child.tag == 'mesh':
        file = child.get('file')
        name = child.get('name') or os.path.splitext(
            os.path.basename(file))[0]
        scale_s = child.get('scale') or defaults.by_tag.get(
            'mesh', {}).get('scale')
        scale = _floats(scale_s) if scale_s else np.ones(3)
        self.meshes[name] = {
            'file': os.path.join(self.dir, self.meshdir, file),
            'scale': scale,
        }

  # -- worldbody ----------------------------------------------------------

  def _parse_body_children(self, elem: ET.Element, body: S.BodySpec,
                           defaults: _Defaults):
    for child in elem:
      cls = child.get('class')
      d = defaults.resolve(cls) if cls else defaults
      if child.tag == 'body':
        self._parse_body(child, body, defaults)
      elif child.tag == 'inertial':
        body.inertial = S.InertialSpec(
            pos=_floats(child.get('pos', '0 0 0')),
            quat=self._orientation(child, d),
            mass=float(child.get('mass')),
            diaginertia=_floats(child.get('diaginertia', '0 0 0')))
      elif child.tag in ('joint', 'freejoint'):
        self._parse_joint(child, body, d)
      elif child.tag == 'geom':
        self._parse_geom(child, body, d)
      elif child.tag == 'site':
        self._parse_site(child, body, d)
      elif child.tag == 'camera':
        pass  # vision observables are deferred (SURVEY.md §7 P4)

  def _parse_body(self, elem: ET.Element, parent: S.BodySpec,
                  defaults: _Defaults):
    childclass = elem.get('childclass')
    d = defaults.resolve(childclass) if childclass else defaults
    body = parent.add_body(
        name=elem.get('name', f'{parent.name}_child'),
        pos=_floats(elem.get('pos', '0 0 0')),
        quat=self._orientation(elem, d),
        mocap=elem.get('mocap', 'false') == 'true')
    self._parse_body_children(elem, body, d)

  def _parse_joint(self, elem: ET.Element, body: S.BodySpec, d: _Defaults):
    if elem.tag == 'freejoint':
      body.add_joint(elem.get('name', f'{body.name}_free'),
                     type=JointType.FREE)
      return
    get = lambda k, fb=None: self._attr(elem, d, k, fb)
    jtype = _JOINT_TYPES[get('type', 'hinge')]
    rng_s = get('range')
    rng = tuple(self._angle(v) for v in _floats(rng_s)) if rng_s else (0.0, 0.0)
    # MuJoCo autolimits: a specified range implies limited unless
    # explicitly disabled.
    limited_s = get('limited', 'auto')
    limited = (limited_s == 'true'
               or (limited_s == 'auto' and rng_s is not None))
    limited = limited and jtype != JointType.FREE
    body.add_joint(
        elem.get('name', f'{body.name}_joint'),
        type=jtype,
        pos=_floats(get('pos', '0 0 0')),
        axis=_floats(get('axis', '0 0 1')),
        range=rng, limited=limited,
        damping=float(get('damping', '0')),
        armature=float(get('armature', '0')),
        frictionloss=float(get('frictionloss', '0')),
        stiffness=float(get('stiffness', '0')),
        margin=self._angle(float(get('margin', '0'))),
        solref=tuple(_floats(get('solreflimit', '0.02 1'))),
        solimp=tuple(_floats(get('solimplimit', '0.9 0.95 0.001 0.5 2'))),
    )

  def _parse_geom(self, elem: ET.Element, body: S.BodySpec, d: _Defaults):
    get = lambda k, fb=None: self._attr(elem, d, k, fb)
    gtype = _GEOM_TYPES[get('type', 'sphere')]
    name = elem.get('name', f'{body.name}_geom{len(body.geoms)}')
    size_s = get('size', '0 0 0')
    size = np.zeros(3)
    sz = _floats(size_s)
    size[:len(sz)] = sz
    pos = _floats(get('pos', '0 0 0'))
    quat = self._orientation(elem, d)
    fromto = get('fromto')
    if fromto is not None:
      f = _floats(fromto)
      a, b = f[:3], f[3:]
      mid = (a + b) / 2
      zaxis = b - a
      length = np.linalg.norm(zaxis)
      pos = mid
      quat = _z_align_quat(zaxis / max(length, 1e-12))
      size[1] = length / 2
    contype = int(get('contype', '1'))
    conaffinity = int(get('conaffinity', '1'))
    friction_s = _floats(get('friction', '1 0.005 0.0001'))
    friction3 = np.ones(3)
    friction3[:len(friction_s)] = friction_s[:3]
    mass_s = get('mass')
    group = int(get('group', '0'))
    rgba = tuple(_floats(get('rgba', '0.5 0.5 0.5 1')))
    common = dict(
        pos=pos, quat=quat,
        friction=tuple(friction3),
        solref=tuple(_floats(get('solref', '0.02 1'))),
        solimp=tuple(_floats(get('solimp', '0.9 0.95 0.001 0.5 2'))),
        margin=float(get('margin', '0')),
        gap=float(get('gap', '0')),
        condim=int(get('condim', '3')),
        contype=contype, conaffinity=conaffinity, group=group,
        density=float(get('density', '1000')),
        mass=float(mass_s) if mass_s is not None else None,
        rgba=rgba,
    )
    if gtype == GeomType.MESH:
      mesh_name = get('mesh')
      collidable = contype != 0 or conaffinity != 0
      if collidable and self.fit_collision_meshes:
        # One geom per fitted part; part 0 keeps the source geom name so
        # name-based lookups (explicit pairs, masks, coloring) still
        # resolve, extra parts get a  __p{i}  suffix (same name prefix, so
        # prefix-based collision masks cover them too).
        for i, fit in enumerate(self._fit_mesh(mesh_name)):
          fpos = pos + S._quat_to_mat_np(quat) @ fit.pos
          fquat = S._quat_mul_np(quat, fit.quat)
          pname = name if i == 0 else f'{name}__p{i}'
          body.add_geom(pname, type=fit.type,
                        **{**common, 'pos': fpos, 'quat': fquat},
                        mesh=mesh_name)
          body.geoms[-1].size = fit.size.copy()
        return
      if self.discard_visual and not collidable:
        return
      body.add_geom(name, type=GeomType.MESH, size=size, mesh=mesh_name,
                    **common)
      return
    body.add_geom(name, type=gtype, size=size, mesh=None, **common)

  def _fit_mesh(self, mesh_name: str):
    """Fitted primitive decomposition (list) for a collision mesh."""
    if mesh_name not in self._mesh_fit_cache:
      info = self.meshes[mesh_name]
      verts = stl.load_stl_vertices(info['file']) * info['scale']
      self._mesh_fit_cache[mesh_name] = primitive_fit.fit_primitives(verts)
    return self._mesh_fit_cache[mesh_name]

  def _parse_site(self, elem: ET.Element, body: S.BodySpec, d: _Defaults):
    get = lambda k, fb=None: self._attr(elem, d, k, fb)
    size = np.full(3, 0.005)
    sz = _floats(get('size', '0.005'))
    size[:len(sz)] = sz
    body.add_site(
        elem.get('name', f'{body.name}_site{len(body.sites)}'),
        pos=_floats(get('pos', '0 0 0')),
        quat=self._orientation(elem, d),
        size=size,
        type=_GEOM_TYPES[get('type', 'sphere')],
        group=int(get('group', '0')),
        rgba=tuple(_floats(get('rgba', '0.5 0.5 0.5 1'))))

  # -- non-tree sections ---------------------------------------------------

  def _parse_contact(self, elem: ET.Element):
    for child in elem:
      if child.tag == 'pair':
        d = self.root_defaults.resolve(child.get('class')) if child.get(
            'class') else self.root_defaults
        get = lambda k, fb=None: self._attr(child, d, k, fb)
        fr = _floats(get('friction', '1 1 0.005 0.0001 0.0001'))
        self.spec.pairs.append(S.PairSpec(
            geom1=child.get('geom1'), geom2=child.get('geom2'),
            condim=int(get('condim', '3')),
            friction=(fr[0], fr[2], fr[3]),
            solref=tuple(_floats(get('solref', '0.02 1'))),
            solimp=tuple(_floats(get('solimp', '0.9 0.95 0.001 0.5 2'))),
            margin=float(get('margin', '0'))))
      elif child.tag == 'exclude':
        self.spec.excludes.append(S.ExcludeSpec(
            body1=child.get('body1'), body2=child.get('body2')))

  def _parse_tendon(self, elem: ET.Element):
    for child in elem:
      if child.tag != 'fixed':
        raise NotImplementedError('only fixed tendons are supported')
      d = self.root_defaults.resolve(child.get('class')) if child.get(
          'class') else self.root_defaults
      get = lambda k, fb=None: self._attr(child, d, k, fb)
      rng = get('range')
      joints = [(j.get('joint'), float(j.get('coef'))) for j in child
                if j.tag == 'joint']
      limited_s = get('limited', 'auto')
      self.spec.tendons.append(S.TendonSpec(
          name=child.get('name'),
          joints=joints,
          range=tuple(_floats(rng)) if rng else (0.0, 0.0),
          limited=(limited_s == 'true'
                   or (limited_s == 'auto' and rng is not None)),
          margin=float(get('margin', '0')),
          solref=tuple(_floats(get('solreflimit', '0.02 1'))),
          solimp=tuple(_floats(get('solimplimit', '0.9 0.95 0.001 0.5 2')))))

  def _parse_actuator(self, elem: ET.Element):
    for child in elem:
      d = self.root_defaults.resolve(child.get('class')) if child.get(
          'class') else self.root_defaults
      get = lambda k, fb=None: self._attr(child, d, k, fb)
      joint = child.get('joint')
      tendon = child.get('tendon')
      trntype = ActuatorTrn.JOINT if joint else ActuatorTrn.TENDON
      target = joint or tendon
      name = child.get('name', f'act_{target}')
      ctrlrange_s = get('ctrlrange')
      ctrllimited_s = get('ctrllimited', 'auto')
      if ctrlrange_s and ctrllimited_s in ('auto', 'true'):
        ctrlrange = tuple(_floats(ctrlrange_s))
      else:
        ctrlrange = (-np.inf, np.inf)  # unlimited control
      forcerange = get('forcerange')
      forcerange = (tuple(_floats(forcerange)) if forcerange
                    else (-np.inf, np.inf))
      gear_s = get('gear')
      gear = float(_floats(gear_s)[0]) if gear_s else 1.0
      if child.tag == 'position':
        kp = float(get('kp', '1'))
        kv = float(get('kv', '0'))
        self.spec.actuators.append(S.ActuatorSpec.position(
            name, target, kp=kp, kv=kv, trntype=trntype,
            ctrlrange=ctrlrange, forcerange=forcerange, gear=gear))
      elif child.tag == 'general':
        gainprm = _floats(get('gainprm', '1 0 0'))[:3]
        gainprm = np.pad(gainprm, (0, 3 - len(gainprm)))
        biasprm = _floats(get('biasprm', '0 0 0'))[:3]
        biasprm = np.pad(biasprm, (0, 3 - len(biasprm)))
        biastype = (BiasType.AFFINE if get('biastype', 'none') == 'affine'
                    else BiasType.NONE)
        self.spec.actuators.append(S.ActuatorSpec(
            name=name, trntype=trntype, target=target,
            gainprm=tuple(gainprm), biastype=biastype,
            biasprm=tuple(biasprm), ctrlrange=ctrlrange,
            forcerange=forcerange, gear=gear))
      elif child.tag == 'motor':
        self.spec.actuators.append(S.ActuatorSpec(
            name=name, trntype=trntype, target=target,
            gainprm=(1.0, 0.0, 0.0), biastype=BiasType.NONE,
            ctrlrange=ctrlrange, forcerange=forcerange, gear=gear))
      else:
        raise NotImplementedError(f'actuator <{child.tag}> unsupported')

  def _parse_equality(self, elem: ET.Element):
    for child in elem:
      polycoef = _floats(child.get('polycoef', '0 1 0 0 0'))
      data = np.zeros(11)
      data[:len(polycoef)] = polycoef
      solref = tuple(_floats(child.get('solref', '0.02 1')))
      solimp = tuple(_floats(child.get('solimp', '0.9 0.95 0.001 0.5 2')))
      if child.tag == 'joint':
        self.spec.equalities.append(S.EqualitySpec(
            name=child.get('name', f'eq{len(self.spec.equalities)}'),
            type=EqType.JOINT, obj1=child.get('joint1'),
            obj2=child.get('joint2', ''), data=data,
            solref=solref, solimp=solimp))
      elif child.tag == 'tendon':
        self.spec.equalities.append(S.EqualitySpec(
            name=child.get('name', f'eq{len(self.spec.equalities)}'),
            type=EqType.TENDON, obj1=child.get('tendon1'),
            obj2=child.get('tendon2', ''), data=data,
            solref=solref, solimp=solimp))
      elif child.tag == 'weld':
        # MuJoCo weld data layout: [anchor(3, body2 frame), relpose(3+4,
        # body1 frame; zero quat = resolve at qpos0), torquescale].
        data = np.zeros(11)
        data[0:3] = _floats(child.get('anchor', '0 0 0'))
        data[3:10] = _floats(child.get('relpose', '0 0 0 0 0 0 0'))
        data[10] = float(child.get('torquescale', '1'))
        self.spec.equalities.append(S.EqualitySpec(
            name=child.get('name', f'eq{len(self.spec.equalities)}'),
            type=EqType.WELD, obj1=child.get('body1'),
            obj2=child.get('body2', ''), data=data,
            solref=solref, solimp=solimp))
      elif child.tag == 'connect':
        # data[0:3] = anchor in body1 frame; data[3:6] (the body2-side
        # point) is resolved at compile time from the qpos0 pose.
        data = np.zeros(11)
        data[0:3] = _floats(child.get('anchor', '0 0 0'))
        data[10] = 1.0  # MuJoCo writes the torquescale default regardless
        self.spec.equalities.append(S.EqualitySpec(
            name=child.get('name', f'eq{len(self.spec.equalities)}'),
            type=EqType.CONNECT, obj1=child.get('body1'),
            obj2=child.get('body2', ''), data=data,
            solref=solref, solimp=solimp, resolve_at_compile=True))
      else:
        raise NotImplementedError(f'equality <{child.tag}> unsupported')


def _z_align_quat(z: np.ndarray) -> np.ndarray:
  """Quaternion rotating +z onto the given unit vector."""
  zaxis = np.array([0.0, 0.0, 1.0])
  c = float(np.dot(zaxis, z))
  if c > 1 - 1e-12:
    return np.array([1.0, 0, 0, 0])
  if c < -1 + 1e-12:
    return np.array([0.0, 1.0, 0, 0])
  axis = np.cross(zaxis, z)
  axis = axis / np.linalg.norm(axis)
  ang = np.arccos(np.clip(c, -1, 1))
  return np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis])


def load_mjcf(path: str, **kw) -> S.ModelSpec:
  """Parses an MJCF file into a ModelSpec."""
  return MjcfParser(path, **kw).parse()


def load_mjcf_string(xml: str, **kw) -> S.ModelSpec:
  """Parses an MJCF XML string into a ModelSpec (<include> and mesh files
  resolve against the temporary directory, as in the JAX package)."""
  import tempfile
  with tempfile.NamedTemporaryFile('w', suffix='.xml', delete=False) as f:
    f.write(xml)
    path = f.name
  try:
    return MjcfParser(path, **kw).parse()
  finally:
    os.remove(path)
