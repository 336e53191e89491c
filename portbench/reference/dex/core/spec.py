"""Mutable model description and compiler to the immutable `Model`.

Port of dexterity_tpu/core/spec.py.  The compiler is numpy until its last
step, which builds the Model's tensors; the inverse weights are computed
in float64 on the CPU with the port's own kinematics and smooth dynamics,
then the model is cast and moved to the requested device.

`ModelSpec` replaces dm_control's PyMJCF object graph for this framework's
needs: entities (hands, arenas, props) are built or imported as specs,
composed with `attach()` (the TPU-native analogue of
`composer.Entity.attach` / `Arena.attach_offset`, reference:
dexterity/models/arenas/arena.py:47-63), and compiled once into device arrays.

Compilation performs, at build time, everything the reference does per-process
in Python/C (MJCF compile, contact-pair pruning from contype/conaffinity —
reference: dexterity/utils/mujoco_collisions.py:17-61): the candidate contact
pair list is computed here, statically, so the runtime narrow phase has a
fixed shape.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math as _math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from reference.dex.core import types
from reference.dex.core.types import (ActuatorTrn, BiasType, EqType,
                                            GeomType, JointType)

_DEFAULT_SOLREF = (0.02, 1.0)
_DEFAULT_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)


def _arr(x, n=None) -> np.ndarray:
  a = np.asarray(x, dtype=np.float64)
  if n is not None:
    a = a.reshape(n)
  return a


@dataclasses.dataclass
class JointSpec:
  name: str
  type: JointType = JointType.HINGE
  pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
  axis: np.ndarray = dataclasses.field(
      default_factory=lambda: np.array([0.0, 0.0, 1.0]))
  range: Tuple[float, float] = (0.0, 0.0)
  limited: bool = False
  damping: float = 0.0
  armature: float = 0.0
  frictionloss: float = 0.0
  stiffness: float = 0.0
  springref: float = 0.0
  margin: float = 0.0
  solref: Tuple[float, float] = _DEFAULT_SOLREF
  solimp: Tuple[float, ...] = _DEFAULT_SOLIMP


@dataclasses.dataclass
class GeomSpec:
  name: str
  type: GeomType = GeomType.SPHERE
  pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
  quat: np.ndarray = dataclasses.field(
      default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))
  size: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
  friction: Tuple[float, float, float] = (1.0, 0.005, 0.0001)
  solref: Tuple[float, float] = _DEFAULT_SOLREF
  solimp: Tuple[float, ...] = _DEFAULT_SOLIMP
  margin: float = 0.0
  gap: float = 0.0
  condim: int = 3
  contype: int = 1
  conaffinity: int = 1
  group: int = 0
  density: float = 1000.0
  mass: Optional[float] = None
  rgba: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 1.0)
  mesh: Optional[str] = None   # source mesh name (export / provenance only)

  @property
  def collidable(self) -> bool:
    return (self.contype != 0 or self.conaffinity != 0) and (
        self.type != GeomType.MESH)


@dataclasses.dataclass
class MeshSpec:
  """A render-only mesh asset (physics never loads mesh files; camera
  observables and MJCF export use these to show the real vendor geometry
  instead of the fitted collision primitives — see models/meshes.py)."""
  name: str
  file: str                    # path relative to models/assets (or absolute)
  scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
  # True for vendor models whose single mesh serves as both collision and
  # visual geometry (MPL): export re-emits it as an extra visual-only geom
  # at (pos, quat) on every body whose fitted primitives carry this mesh
  # as provenance.
  emit_on_body: bool = False
  pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
  quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass
class SiteSpec:
  name: str
  pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
  quat: np.ndarray = dataclasses.field(
      default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))
  size: np.ndarray = dataclasses.field(
      default_factory=lambda: np.full(3, 0.005))
  type: GeomType = GeomType.SPHERE
  group: int = 0
  rgba: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 1.0)


@dataclasses.dataclass
class InertialSpec:
  pos: np.ndarray
  quat: np.ndarray
  mass: float
  diaginertia: np.ndarray


@dataclasses.dataclass
class BodySpec:
  name: str
  pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
  quat: np.ndarray = dataclasses.field(
      default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))
  inertial: Optional[InertialSpec] = None
  mocap: bool = False
  joints: List[JointSpec] = dataclasses.field(default_factory=list)
  geoms: List[GeomSpec] = dataclasses.field(default_factory=list)
  sites: List[SiteSpec] = dataclasses.field(default_factory=list)
  children: List['BodySpec'] = dataclasses.field(default_factory=list)

  def add_body(self, name: str, **kw) -> 'BodySpec':
    body = BodySpec(name=name, **kw)
    self.children.append(body)
    return body

  def add_joint(self, name: str, **kw) -> JointSpec:
    joint = JointSpec(name=name, **kw)
    self.joints.append(joint)
    return joint

  def add_geom(self, name: str, **kw) -> GeomSpec:
    geom = GeomSpec(name=name, **kw)
    self.geoms.append(geom)
    return geom

  def add_site(self, name: str, **kw) -> SiteSpec:
    site = SiteSpec(name=name, **kw)
    self.sites.append(site)
    return site

  def walk(self):
    yield self
    for child in self.children:
      yield from child.walk()


@dataclasses.dataclass
class TendonSpec:
  """Fixed tendon: length = sum(coef_i * qpos[joint_i])."""
  name: str
  joints: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
  range: Tuple[float, float] = (0.0, 0.0)
  limited: bool = False
  margin: float = 0.0
  solref: Tuple[float, float] = _DEFAULT_SOLREF
  solimp: Tuple[float, ...] = _DEFAULT_SOLIMP


@dataclasses.dataclass
class ActuatorSpec:
  name: str
  trntype: ActuatorTrn = ActuatorTrn.JOINT
  target: str = ''                  # joint or tendon name
  gainprm: Tuple[float, float, float] = (1.0, 0.0, 0.0)
  biastype: BiasType = BiasType.NONE
  biasprm: Tuple[float, float, float] = (0.0, 0.0, 0.0)
  ctrlrange: Tuple[float, float] = (-1.0, 1.0)
  ctrllimited: bool = True
  forcerange: Tuple[float, float] = (-np.inf, np.inf)
  gear: float = 1.0

  @classmethod
  def position(cls, name: str, target: str, kp: float, kv: float = 0.0,
               trntype: ActuatorTrn = ActuatorTrn.JOINT, **kw):
    """MuJoCo <position> actuator: gain kp, bias (0, -kp, -kv)."""
    return cls(name=name, trntype=trntype, target=target,
               gainprm=(kp, 0.0, 0.0), biastype=BiasType.AFFINE,
               biasprm=(0.0, -kp, -kv), **kw)


@dataclasses.dataclass
class EqualitySpec:
  name: str
  type: EqType = EqType.JOINT
  obj1: str = ''
  obj2: str = ''
  data: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(11))
  solref: Tuple[float, float] = _DEFAULT_SOLREF
  solimp: Tuple[float, ...] = _DEFAULT_SOLIMP
  active: bool = True
  # CONNECT only: derive data[3:6] (the body2-frame coordinates of the
  # anchor point) from the qpos0 pose at compile time (MuJoCo compiler
  # behavior for <connect anchor=...>).
  resolve_at_compile: bool = False


@dataclasses.dataclass
class PairSpec:
  geom1: str
  geom2: str
  condim: int = 3
  friction: Tuple[float, float, float] = (1.0, 0.005, 0.0001)
  solref: Tuple[float, float] = _DEFAULT_SOLREF
  solimp: Tuple[float, ...] = _DEFAULT_SOLIMP
  margin: float = 0.0


@dataclasses.dataclass
class ExcludeSpec:
  body1: str
  body2: str


@dataclasses.dataclass
class OptionSpec:
  timestep: float = 0.002
  gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
  solver_iterations: int = 8
  ls_iterations: int = 8
  contact_top_k: int = 64
  midphase_cap: int = 64


@dataclasses.dataclass
class ModelSpec:
  """A full mutable model description."""
  name: str = 'model'
  option: OptionSpec = dataclasses.field(default_factory=OptionSpec)
  worldbody: BodySpec = dataclasses.field(
      default_factory=lambda: BodySpec(name='world'))
  tendons: List[TendonSpec] = dataclasses.field(default_factory=list)
  actuators: List[ActuatorSpec] = dataclasses.field(default_factory=list)
  equalities: List[EqualitySpec] = dataclasses.field(default_factory=list)
  pairs: List[PairSpec] = dataclasses.field(default_factory=list)
  excludes: List[ExcludeSpec] = dataclasses.field(default_factory=list)
  # Pairs dropped by mjcf.prune (sorted (geom1, geom2) name tuples).
  # A drop-list (not a whitelist) so attach() composition keeps all
  # cross-entity pairs (e.g. hand vs prop).
  pruned_pairs: set = dataclasses.field(default_factory=set)
  # Render-only mesh assets keyed by the (namespaced) mesh name geoms
  # reference via GeomSpec.mesh (models/meshes.py populates these for the
  # vendored hands; physics never reads them).
  meshes: Dict[str, MeshSpec] = dataclasses.field(default_factory=dict)

  # ---------------------------------------------------------------------
  # Lookup / composition
  # ---------------------------------------------------------------------

  def bodies(self) -> List[BodySpec]:
    return list(self.worldbody.walk())

  def find_body(self, name: str) -> BodySpec:
    for b in self.worldbody.walk():
      if b.name == name:
        return b
    raise KeyError(f'no body named {name!r}')

  def joint_names(self) -> List[str]:
    return [j.name for b in self.worldbody.walk() for j in b.joints]

  def rename_all(self, prefix: str) -> 'ModelSpec':
    """Prefixes every named element in-place. Returns self."""
    for b in self.worldbody.walk():
      if b is not self.worldbody:
        b.name = prefix + b.name
      for j in b.joints:
        j.name = prefix + j.name
      for g in b.geoms:
        g.name = prefix + g.name
      for s in b.sites:
        s.name = prefix + s.name
    for t in self.tendons:
      t.name = prefix + t.name
      t.joints = [(prefix + jn, c) for jn, c in t.joints]
    for a in self.actuators:
      a.name = prefix + a.name
      a.target = prefix + a.target
    for e in self.equalities:
      e.name = prefix + e.name
      if e.obj1:
        e.obj1 = prefix + e.obj1
      if e.obj2:
        e.obj2 = prefix + e.obj2
    for p in self.pairs:
      p.geom1 = prefix + p.geom1
      p.geom2 = prefix + p.geom2
    for x in self.excludes:
      x.body1 = prefix + x.body1
      x.body2 = prefix + x.body2
    self.pruned_pairs = {tuple(sorted((prefix + a, prefix + b)))
                         for a, b in self.pruned_pairs}
    return self

  def attach(self, child: 'ModelSpec', prefix: str = '',
             pos=(0.0, 0.0, 0.0), quat=(1.0, 0.0, 0.0, 0.0),
             parent_body: Optional[str] = None) -> 'ModelSpec':
    """Attaches a deep copy of `child` under a new frame body.

    The frame body (named `{prefix}root` if the child world has multiple
    direct children, otherwise the single child body re-posed) is placed at
    (pos, quat) relative to `parent_body` (default: world).

    Returns self for chaining.
    """
    child = copy.deepcopy(child)
    if prefix:
      child.rename_all(prefix)
    parent = self.find_body(parent_body) if parent_body else self.worldbody

    kids = child.worldbody.children
    if len(kids) == 1 and not child.worldbody.geoms and not child.worldbody.sites:
      root = kids[0]
      # Compose attachment pose with the child root's own pose.
      p, q = _pose_mul_np(np.asarray(pos, np.float64),
                          np.asarray(quat, np.float64), root.pos, root.quat)
      root.pos, root.quat = p, q
      parent.children.append(root)
    else:
      frame = BodySpec(name=f'{prefix}attachment', pos=_arr(pos, 3),
                       quat=_arr(quat, 4))
      frame.children.extend(kids)
      frame.geoms.extend(child.worldbody.geoms)
      frame.sites.extend(child.worldbody.sites)
      parent.children.append(frame)

    self.tendons.extend(child.tendons)
    self.actuators.extend(child.actuators)
    self.equalities.extend(child.equalities)
    self.pairs.extend(child.pairs)
    self.excludes.extend(child.excludes)
    self.pruned_pairs |= child.pruned_pairs
    self.meshes.update(child.meshes)
    return self

  def add_mocap(self, name: str, pos=(0, 0, 0), quat=(1, 0, 0, 0),
                weld_body: Optional[str] = None,
                solref=_DEFAULT_SOLREF, solimp=_DEFAULT_SOLIMP) -> BodySpec:
    """Adds a mocap body, optionally welded to `weld_body`.

    TPU-native analogue of Arena.add_mocap (reference:
    dexterity/models/arenas/arena.py:65-112).
    """
    mocap = BodySpec(name=name, pos=_arr(pos, 3), quat=_arr(quat, 4),
                     mocap=True)
    mocap.inertial = InertialSpec(pos=np.zeros(3),
                                  quat=np.array([1.0, 0, 0, 0]),
                                  mass=0.0, diaginertia=np.zeros(3))
    self.worldbody.children.append(mocap)
    if weld_body is not None:
      self.equalities.append(
          EqualitySpec(name=f'{name}_weld', type=EqType.WELD, obj1=name,
                       obj2=weld_body, data=np.zeros(11), solref=solref,
                       solimp=solimp))
    return mocap

  # ---------------------------------------------------------------------
  # Compile
  # ---------------------------------------------------------------------

  def compile(self, device=None, dtype=torch.float32) -> types.Model:
    """Compiles the spec into a Model on `device` (cuda unless given) in
    `dtype`."""
    device = types.resolve_device(device)
    f64 = _Float64Cpu
    bodies = self.bodies()  # depth-first, world first
    body_index = {b.name: i for i, b in enumerate(bodies)}
    if len(body_index) != len(bodies):
      raise ValueError('body names must be unique')

    # --- bodies / joints / dofs -----------------------------------------
    body_parentid = [0]
    for b in bodies[1:]:
      parent = _find_parent(self.worldbody, b)
      body_parentid.append(body_index[parent.name])

    joints: List[JointSpec] = []
    jnt_bodyid: List[int] = []
    body_jntadr, body_jntnum = [], []
    for i, b in enumerate(bodies):
      body_jntadr.append(len(joints) if b.joints else -1)
      body_jntnum.append(len(b.joints))
      for j in b.joints:
        joints.append(j)
        jnt_bodyid.append(i)
        if j.type == JointType.FREE and body_parentid[i] != 0:
          raise ValueError(f'free joint on non-world child body {b.name!r}')
      if b.mocap and b.joints:
        raise ValueError(f'mocap body {b.name!r} cannot have joints')

    jnt_qposadr, jnt_dofadr = [], []
    nq = nv = 0
    for j in joints:
      jnt_qposadr.append(nq)
      jnt_dofadr.append(nv)
      nq += types.QPOS_WIDTH[j.type]
      nv += types.DOF_WIDTH[j.type]

    dof_bodyid, dof_jntid = [], []
    dof_damping = np.zeros(nv)
    dof_armature = np.zeros(nv)
    dof_frictionloss = np.zeros(nv)
    for ji, j in enumerate(joints):
      width = types.DOF_WIDTH[j.type]
      adr = jnt_dofadr[ji]
      dof_bodyid += [jnt_bodyid[ji]] * width
      dof_jntid += [ji] * width
      dof_damping[adr:adr + width] = j.damping
      dof_armature[adr:adr + width] = j.armature
      dof_frictionloss[adr:adr + width] = j.frictionloss

    qpos0 = np.zeros(nq)
    for ji, j in enumerate(joints):
      if j.type == JointType.FREE:
        b = bodies[jnt_bodyid[ji]]
        qpos0[jnt_qposadr[ji]:jnt_qposadr[ji] + 3] = b.pos
        qpos0[jnt_qposadr[ji] + 3:jnt_qposadr[ji] + 7] = b.quat
      elif j.type == JointType.BALL:
        qpos0[jnt_qposadr[ji]] = 1.0

    # --- mocap -----------------------------------------------------------
    body_mocapid = []
    nmocap = 0
    for b in bodies:
      if b.mocap:
        body_mocapid.append(nmocap)
        nmocap += 1
      else:
        body_mocapid.append(-1)

    # --- inertia ---------------------------------------------------------
    body_mass = np.zeros(len(bodies))
    body_inertia = np.zeros((len(bodies), 3))
    body_ipos = np.zeros((len(bodies), 3))
    body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (len(bodies), 1))
    for i, b in enumerate(bodies):
      if i == 0:
        continue
      inertial = b.inertial or _inertia_from_geoms(b)
      body_mass[i] = inertial.mass
      body_inertia[i] = inertial.diaginertia
      body_ipos[i] = inertial.pos
      body_iquat[i] = inertial.quat / max(np.linalg.norm(inertial.quat), 1e-15)

    # --- geoms / sites -----------------------------------------------------
    geoms: List[GeomSpec] = []
    geom_bodyid: List[int] = []
    sites: List[SiteSpec] = []
    site_bodyid: List[int] = []
    for i, b in enumerate(bodies):
      for g in b.geoms:
        geoms.append(g)
        geom_bodyid.append(i)
      for s in b.sites:
        sites.append(s)
        site_bodyid.append(i)
    geom_index = {g.name: k for k, g in enumerate(geoms)}
    if len(geom_index) != len(geoms):
      raise ValueError('geom names must be unique')

    # --- tendons -----------------------------------------------------------
    jnt_index = {j.name: ji for ji, j in enumerate(joints)}
    if len(jnt_index) != len(joints):
      raise ValueError('joint names must be unique')
    ten_moment = np.zeros((len(self.tendons), nv))
    for ti, t in enumerate(self.tendons):
      for jname, coef in t.joints:
        ji = jnt_index[jname]
        if joints[ji].type not in (JointType.HINGE, JointType.SLIDE):
          raise ValueError('fixed tendons support scalar joints only')
        ten_moment[ti, jnt_dofadr[ji]] = coef
    ten_index = {t.name: ti for ti, t in enumerate(self.tendons)}

    # --- actuators ---------------------------------------------------------
    actuator_trnid = []
    for a in self.actuators:
      if a.trntype == ActuatorTrn.JOINT:
        actuator_trnid.append(jnt_index[a.target])
        if joints[jnt_index[a.target]].type not in (JointType.HINGE,
                                                    JointType.SLIDE):
          raise ValueError('joint actuators support scalar joints only')
      else:
        actuator_trnid.append(ten_index[a.target])

    # --- equalities ----------------------------------------------------------
    # qpos0 world poses (joints contribute identity at the reference
    # configuration; free-body qpos0 equals the local pose), used to resolve
    # the compile-time parts of CONNECT/WELD data like MuJoCo's compiler.
    def _qpos0_world_poses():
      xpos = [np.zeros(3)]
      xquat = [np.array([1.0, 0, 0, 0])]
      for bi, b in enumerate(bodies[1:], start=1):
        pp, pq = xpos[body_parentid[bi]], xquat[body_parentid[bi]]
        q = np.asarray(b.quat, np.float64)
        q = q / max(np.linalg.norm(q), 1e-15)
        xpos.append(pp + _np_quat_rotate(pq, np.asarray(b.pos, np.float64)))
        xquat.append(_np_quat_mul(pq, q))
      return xpos, xquat

    eq_obj1, eq_obj2 = [], []
    eq_data_rows = []
    poses0 = None
    for e in self.equalities:
      data = np.array(e.data, np.float64, copy=True)
      if e.type == EqType.JOINT:
        eq_obj1.append(jnt_index[e.obj1])
        eq_obj2.append(jnt_index[e.obj2] if e.obj2 else -1)
      elif e.type == EqType.TENDON:
        eq_obj1.append(ten_index[e.obj1])
        eq_obj2.append(ten_index[e.obj2] if e.obj2 else -1)
      else:  # CONNECT / WELD reference bodies
        b1 = body_index[e.obj1]
        b2 = body_index[e.obj2] if e.obj2 else 0
        eq_obj1.append(b1)
        eq_obj2.append(b2)
        if poses0 is None:
          poses0 = _qpos0_world_poses()
        xp, xq = poses0
        if e.type == EqType.WELD:
          if data[10] == 0.0:
            data[10] = 1.0  # MuJoCo torquescale default
          if np.allclose(data[6:10], 0.0):
            # Zero relpose quaternion: use the qpos0 relative pose
            # (MuJoCo <weld relpose> default semantics).
            q1, q2 = xq[b1], xq[b2]
            data[6:10] = _np_quat_mul(_np_quat_conj(q1), q2)
            p2w = xp[b2] + _np_quat_rotate(q2, data[0:3])
            data[3:6] = _np_quat_rotate(_np_quat_conj(q1), p2w - xp[b1])
          else:
            data[6:10] = data[6:10] / np.linalg.norm(data[6:10])
        elif e.resolve_at_compile:  # CONNECT <anchor> from XML
          p1w = xp[b1] + _np_quat_rotate(xq[b1], data[0:3])
          data[3:6] = _np_quat_rotate(_np_quat_conj(xq[b2]), p1w - xp[b2])
      eq_data_rows.append(data)

    # --- contact pairs (static broad phase) --------------------------------
    pair_list = self._make_pairs(bodies, body_index, body_parentid, geoms,
                                 geom_bodyid, geom_index)

    # --- assemble ------------------------------------------------------------
    def fa(items, attr, width=None):
      if not items:
        shape = (0,) if width is None else (0, width)
        return f64.zeros(shape)
      vals = np.asarray([getattr(x, attr) for x in items], dtype=np.float64)
      # MuJoCo normalizes orientations and joint axes at compile time.
      if attr in ('quat', 'axis'):
        norm = np.linalg.norm(vals, axis=-1, keepdims=True)
        vals = vals / np.maximum(norm, 1e-15)
      return f64.asarray(vals)

    model = types.Model(
        nq=nq, nv=nv, nu=len(self.actuators), nbody=len(bodies),
        njnt=len(joints), ngeom=len(geoms), nsite=len(sites),
        ntendon=len(self.tendons), neq=len(self.equalities), nmocap=nmocap,
        npair=len(pair_list),
        body_parentid=tuple(body_parentid),
        body_jntadr=tuple(body_jntadr), body_jntnum=tuple(body_jntnum),
        body_dofadr=tuple(
            jnt_dofadr[body_jntadr[i]] if body_jntnum[i] else -1
            for i in range(len(bodies))),
        body_dofnum=tuple(
            sum(types.DOF_WIDTH[joints[body_jntadr[i] + k].type]
                for k in range(body_jntnum[i])) for i in range(len(bodies))),
        body_mocapid=tuple(body_mocapid),
        jnt_type=tuple(int(j.type) for j in joints),
        jnt_bodyid=tuple(jnt_bodyid),
        jnt_qposadr=tuple(jnt_qposadr), jnt_dofadr=tuple(jnt_dofadr),
        jnt_limited=tuple(bool(j.limited) for j in joints),
        dof_bodyid=tuple(dof_bodyid), dof_jntid=tuple(dof_jntid),
        geom_type=tuple(int(g.type) for g in geoms),
        geom_bodyid=tuple(geom_bodyid),
        geom_condim=tuple(g.condim for g in geoms),
        site_bodyid=tuple(site_bodyid),
        actuator_trntype=tuple(int(a.trntype) for a in self.actuators),
        actuator_trnid=tuple(actuator_trnid),
        actuator_biastype=tuple(int(a.biastype) for a in self.actuators),
        tendon_limited=tuple(bool(t.limited) for t in self.tendons),
        eq_type=tuple(int(e.type) for e in self.equalities),
        eq_obj1=tuple(eq_obj1), eq_obj2=tuple(eq_obj2),
        pair_geom1=tuple(p[0] for p in pair_list),
        pair_geom2=tuple(p[1] for p in pair_list),
        pair_condim=tuple(p[2] for p in pair_list),
        body_names=tuple(b.name for b in bodies),
        jnt_names=tuple(j.name for j in joints),
        geom_names=tuple(g.name for g in geoms),
        site_names=tuple(s.name for s in sites),
        actuator_names=tuple(a.name for a in self.actuators),
        tendon_names=tuple(t.name for t in self.tendons),
        opt=types.Option(
            timestep=float(self.option.timestep),
            gravity=f64.asarray(np.asarray(self.option.gravity, np.float64)),
            solver_iterations=self.option.solver_iterations,
            ls_iterations=self.option.ls_iterations,
            contact_top_k=self.option.contact_top_k,
            midphase_cap=self.option.midphase_cap,
        ),
        qpos0=f64.asarray(qpos0),
        body_pos=fa(bodies, 'pos', 3), body_quat=fa(bodies, 'quat', 4),
        body_ipos=f64.asarray(body_ipos), body_iquat=f64.asarray(body_iquat),
        body_mass=f64.asarray(body_mass),
        body_inertia=f64.asarray(body_inertia),
        jnt_pos=fa(joints, 'pos', 3), jnt_axis=fa(joints, 'axis', 3),
        jnt_range=fa(joints, 'range', 2),
        jnt_solref=fa(joints, 'solref', 2), jnt_solimp=fa(joints, 'solimp', 5),
        jnt_margin=fa(joints, 'margin'),
        dof_damping=f64.asarray(dof_damping),
        dof_armature=f64.asarray(dof_armature),
        dof_frictionloss=f64.asarray(dof_frictionloss),
        geom_pos=fa(geoms, 'pos', 3), geom_quat=fa(geoms, 'quat', 4),
        geom_size=fa(geoms, 'size', 3), geom_friction=fa(geoms, 'friction', 3),
        geom_solref=fa(geoms, 'solref', 2), geom_solimp=fa(geoms, 'solimp', 5),
        geom_margin=fa(geoms, 'margin'),
        site_pos=fa(sites, 'pos', 3), site_quat=fa(sites, 'quat', 4),
        actuator_gainprm=fa(self.actuators, 'gainprm', 3),
        actuator_biasprm=fa(self.actuators, 'biasprm', 3),
        actuator_ctrlrange=fa(self.actuators, 'ctrlrange', 2),
        actuator_forcerange=fa(self.actuators, 'forcerange', 2),
        actuator_gear=fa(self.actuators, 'gear'),
        tendon_moment=f64.asarray(ten_moment),
        tendon_range=fa(self.tendons, 'range', 2),
        tendon_solref=fa(self.tendons, 'solref', 2),
        tendon_solimp=fa(self.tendons, 'solimp', 5),
        tendon_margin=fa(self.tendons, 'margin'),
        eq_data=(f64.asarray(np.stack(eq_data_rows))
                 if eq_data_rows else f64.zeros((0, 11))),
        eq_solref=fa(self.equalities, 'solref', 2),
        eq_solimp=fa(self.equalities, 'solimp', 5),
        pair_friction=f64.asarray(
            np.asarray([p[3] for p in pair_list], np.float64).reshape(-1, 3)),
        pair_solref=f64.asarray(
            np.asarray([p[4] for p in pair_list], np.float64).reshape(-1, 2)),
        pair_solimp=f64.asarray(
            np.asarray([p[5] for p in pair_list], np.float64).reshape(-1, 5)),
        pair_margin=f64.asarray(
            np.asarray([p[6] for p in pair_list], np.float64).reshape(-1)),
        dof_invweight0=f64.zeros(nv),
        body_invweight0=f64.zeros((len(bodies), 2)),
        tendon_invweight0=f64.zeros(len(self.tendons)),
    )
    return _fill_invweight0(model).to(device=device, dtype=dtype)

  def _make_pairs(self, bodies, body_index, body_parentid, geoms, geom_bodyid,
                  geom_index):
    """Builds the static candidate contact-pair list.

    Implements MuJoCo's filtering semantics at compile time: same-body and
    (weld-)parent-child exclusion, contype/conaffinity compatibility,
    explicit <exclude>, and explicit <pair> additions.
    """
    exclude_pairs = set()
    for x in self.excludes:
      b1, b2 = body_index[x.body1], body_index[x.body2]
      exclude_pairs.add((min(b1, b2), max(b1, b2)))

    # weldparent: walk up through joint-less bodies.
    def weld_root(i):
      while i != 0 and not bodies[i].joints:
        i = body_parentid[i]
      return i

    def parent_filter(i1, i2):
      w1, w2 = weld_root(i1), weld_root(i2)
      if w1 == w2:
        return True  # same weld: never collide
      pw1 = weld_root(body_parentid[w1]) if w1 else -1
      pw2 = weld_root(body_parentid[w2]) if w2 else -1
      # parent-child exclusion (not applied to world-attached free bodies).
      if pw1 == w2 and w2 != 0:
        return True
      if pw2 == w1 and w1 != 0:
        return True
      return False

    # A mesh geom fitted as several primitives keeps the source name on
    # part 0 and gets  __p{i}  siblings; explicit pairs naming the source
    # expand over every part.
    def named_parts(name):
      ids = [geom_index[name]]
      i = 1
      while f'{name}__p{i}' in geom_index:
        ids.append(geom_index[f'{name}__p{i}'])
        i += 1
      return ids

    pair_list = []
    seen = set()
    # Explicit pairs first (they override filtering).
    for p in self.pairs:
      for g1 in named_parts(p.geom1):
        for g2 in named_parts(p.geom2):
          key = (min(g1, g2), max(g1, g2))
          seen.add(key)
          pair_list.append((g1, g2, p.condim, tuple(p.friction),
                            tuple(p.solref), tuple(p.solimp), p.margin))

    for g1, g2 in itertools.combinations(range(len(geoms)), 2):
      key = (g1, g2)
      if key in seen:
        continue
      spec1, spec2 = geoms[g1], geoms[g2]
      if not (spec1.collidable and spec2.collidable):
        continue
      b1, b2 = geom_bodyid[g1], geom_bodyid[g2]
      if b1 == b2 or parent_filter(b1, b2):
        continue
      if (min(b1, b2), max(b1, b2)) in exclude_pairs:
        continue
      if not ((spec1.contype & spec2.conaffinity) or
              (spec2.contype & spec1.conaffinity)):
        continue
      if tuple(sorted((spec1.name, spec2.name))) in self.pruned_pairs:
        continue
      # Dynamic-pair parameter mixing (MuJoCo mj_contactParam with equal
      # solmix: average solref/solimp, max friction & margin & condim).
      condim = max(spec1.condim, spec2.condim)
      friction = tuple(np.maximum(spec1.friction, spec2.friction))
      solref = tuple((np.asarray(spec1.solref) + np.asarray(spec2.solref)) / 2)
      solimp = tuple((np.asarray(spec1.solimp) + np.asarray(spec2.solimp)) / 2)
      # includemargin = margin - gap (gap unused by the dexterity models).
      margin = max(spec1.margin, spec2.margin) - max(spec1.gap, spec2.gap)
      pair_list.append((g1, g2, condim, friction, solref, solimp, margin))

    # Order pairs so plane pairs come first (cheap) — cosmetic but stable.
    return pair_list


class _Float64Cpu:
  """The two array constructors compile() needs, as float64 CPU tensors
  (the JAX compiler's f64.asarray / f64.zeros in x64 mode)."""

  @staticmethod
  def asarray(x):
    return torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float64)

  @staticmethod
  def zeros(shape):
    return torch.zeros(shape, dtype=torch.float64)


def _fill_invweight0(model: types.Model) -> types.Model:
  """Computes MuJoCo-style inverse weights at the reference configuration.

  dof_invweight0 = diag(M0^-1); body_invweight0 = mean diagonal of the
  6x6 inverse spatial inertia J M0^-1 J^T at each body COM (translation /
  rotation blocks); tendon_invweight0 = m M0^-1 m^T per fixed tendon.
  `model` is float64 on the CPU.
  """
  from reference.dex.physics import kinematics, smooth
  data = types.make_data(model)
  data = kinematics.fwd_position(model, data)
  data = smooth.crb(model, data)
  minv = torch.linalg.inv(data.qM)
  dof_iw = torch.diagonal(minv)
  jac = smooth.com_jacobians(model, data)      # (nbody, 6, nv)
  a = torch.einsum('biv,vw,bjw->bij', jac, minv, jac)
  rot_iw = torch.diagonal(a[:, :3, :3], dim1=1, dim2=2).sum(-1) / 3.0
  trn_iw = torch.diagonal(a[:, 3:, 3:], dim1=1, dim2=2).sum(-1) / 3.0
  body_iw = torch.stack([trn_iw, rot_iw], dim=-1)
  if model.ntendon:
    ten_iw = torch.einsum('tv,vw,tw->t', model.tendon_moment, minv,
                          model.tendon_moment)
  else:
    ten_iw = torch.zeros((0,), dtype=torch.float64)
  return model.replace(dof_invweight0=dof_iw, body_invweight0=body_iw,
                       tendon_invweight0=ten_iw)


def _find_parent(root: BodySpec, target: BodySpec) -> BodySpec:
  for b in root.walk():
    if target in b.children:
      return b
  raise KeyError(f'body {target.name!r} not found in tree')


def _pose_mul_np(pos_a, quat_a, pos_b, quat_b):
  ra = _quat_to_mat_np(quat_a)
  return pos_a + ra @ pos_b, _quat_mul_np(quat_a, quat_b)


def _np_quat_mul(a, b):
  return _quat_mul_np(a, b)


def _np_quat_conj(q):
  return np.array([q[0], -q[1], -q[2], -q[3]])


def _np_quat_rotate(q, v):
  return _quat_to_mat_np(q) @ np.asarray(v, np.float64)


def _quat_mul_np(a, b):
  aw, ax, ay, az = a
  bw, bx, by, bz = b
  return np.array([
      aw * bw - ax * bx - ay * by - az * bz,
      aw * bx + ax * bw + ay * bz - az * by,
      aw * by - ax * bz + ay * bw + az * bx,
      aw * bz + ax * by - ay * bx + az * bw,
  ])


def _quat_to_mat_np(q):
  w, x, y, z = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])


def _inertia_from_geoms(body: BodySpec) -> InertialSpec:
  """Computes body inertia from its geoms (primitive analytic formulas)."""
  total_mass = 0.0
  com = np.zeros(3)
  contributions = []
  for g in body.geoms:
    m, inertia_diag = _geom_mass_inertia(g)
    if m <= 0:
      continue
    r = _quat_to_mat_np(g.quat)
    full = r @ np.diag(inertia_diag) @ r.T
    contributions.append((m, g.pos.copy(), full))
    total_mass += m
    com += m * g.pos
  if total_mass <= 0:
    # Massless leaf (MuJoCo would reject; we allow with tiny regularizer).
    return InertialSpec(pos=np.zeros(3), quat=np.array([1.0, 0, 0, 0]),
                        mass=1e-6, diaginertia=np.full(3, 1e-9))
  com /= total_mass
  total = np.zeros((3, 3))
  for m, pos, full in contributions:
    d = pos - com
    total += full + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
  evals, evecs = np.linalg.eigh(total)
  if np.linalg.det(evecs) < 0:
    evecs[:, 2] *= -1
  quat = _mat_to_quat_np(evecs)
  return InertialSpec(pos=com, quat=quat, mass=total_mass,
                      diaginertia=np.maximum(evals, 1e-12))


def _geom_mass_inertia(g: GeomSpec) -> Tuple[float, np.ndarray]:
  s = g.size
  if g.type == GeomType.SPHERE:
    vol = 4 / 3 * _math.pi * s[0] ** 3
    mass = g.mass if g.mass is not None else g.density * vol
    i = 0.4 * mass * s[0] ** 2
    return mass, np.array([i, i, i])
  if g.type == GeomType.BOX:
    vol = 8 * s[0] * s[1] * s[2]
    mass = g.mass if g.mass is not None else g.density * vol
    fx, fy, fz = (2 * s[0]) ** 2, (2 * s[1]) ** 2, (2 * s[2]) ** 2
    return mass, mass / 12 * np.array([fy + fz, fx + fz, fx + fy])
  if g.type == GeomType.CAPSULE:
    r, hl = s[0], s[1]
    vol_cyl = _math.pi * r * r * 2 * hl
    vol_sph = 4 / 3 * _math.pi * r ** 3
    mass = g.mass if g.mass is not None else g.density * (vol_cyl + vol_sph)
    mc = mass * vol_cyl / (vol_cyl + vol_sph)
    ms = mass - mc
    # cylinder part
    ixx = mc * (r * r / 4 + (2 * hl) ** 2 / 12)
    izz = mc * r * r / 2
    # hemispheres (parallel axis)
    ixx += ms * (0.4 * r * r + hl * hl + 2 * 0.375 * r * hl)
    izz += ms * 0.4 * r * r
    return mass, np.array([ixx, ixx, izz])
  if g.type == GeomType.CYLINDER:
    r, hl = s[0], s[1]
    vol = _math.pi * r * r * 2 * hl
    mass = g.mass if g.mass is not None else g.density * vol
    ixx = mass * (r * r / 4 + (2 * hl) ** 2 / 12)
    return mass, np.array([ixx, ixx, mass * r * r / 2])
  if g.type == GeomType.ELLIPSOID:
    vol = 4 / 3 * _math.pi * s[0] * s[1] * s[2]
    mass = g.mass if g.mass is not None else g.density * vol
    return mass, mass / 5 * np.array(
        [s[1] ** 2 + s[2] ** 2, s[0] ** 2 + s[2] ** 2, s[0] ** 2 + s[1] ** 2])
  return 0.0, np.zeros(3)  # planes / meshes carry no mass here


def _mat_to_quat_np(m: np.ndarray) -> np.ndarray:
  tr = np.trace(m)
  if tr > 0:
    s = _math.sqrt(tr + 1.0) * 2
    return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                     (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
  i = int(np.argmax(np.diag(m)))
  if i == 0:
    s = _math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
    q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
         (m[0, 2] + m[2, 0]) / s]
  elif i == 1:
    s = _math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
    q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
         (m[1, 2] + m[2, 1]) / s]
  else:
    s = _math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
    q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
         (m[1, 2] + m[2, 1]) / s, 0.25 * s]
  q = np.asarray(q)
  return q / np.linalg.norm(q)
