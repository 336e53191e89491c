"""Compiled model and simulation state as dataclasses of tensors.

Port of dexterity_tpu/core/types.py.  Structural fields (counts, index
tables, names) stay Python ints and tuples; numeric parameters are tensors
on one device in one dtype.  `Data` is batch-leading: every tensor field
carries the same leading batch shape (none for a single environment).

`model_from_numpy` / `data_from_numpy` carry a model or state across from
any source given as plain numpy arrays plus the static ints and tuples;
the parity tests use them so the port and the JAX package compute from
identical inputs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


class GeomType(enum.IntEnum):
  PLANE = 0
  SPHERE = 1
  CAPSULE = 2
  ELLIPSOID = 3
  CYLINDER = 4
  BOX = 5
  MESH = 6  # carried for export/viz; collisions use fitted primitives


class ActuatorTrn(enum.IntEnum):
  JOINT = 0
  TENDON = 1


class BiasType(enum.IntEnum):
  NONE = 0
  AFFINE = 1


class EqType(enum.IntEnum):
  CONNECT = 0
  WELD = 1
  JOINT = 2
  TENDON = 3


class ObjType(enum.IntEnum):
  """Object types addressable by Jacobians and velocity queries: the
  subset the reference's mapper validates (body, geom, site)."""
  BODY = 0
  GEOM = 1
  SITE = 2


QPOS_WIDTH = {JointType.FREE: 7, JointType.BALL: 4,
              JointType.SLIDE: 1, JointType.HINGE: 1}
DOF_WIDTH = {JointType.FREE: 6, JointType.BALL: 3,
             JointType.SLIDE: 1, JointType.HINGE: 1}


def resolve_device(device=None) -> torch.device:
  """The device an entry point places its tensors on: `cuda` unless the
  caller names another.  Raises when no card is present and no device was
  given; never falls back to the CPU."""
  if device is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          'no CUDA device is available; pass device="cpu" to run on the CPU')
    return torch.device('cuda')
  return torch.device(device)


@dataclasses.dataclass(frozen=True)
class Option:
  """Physics options (subset of MuJoCo <option>)."""
  timestep: float
  gravity: torch.Tensor      # (3,)
  solver_iterations: int = 8
  ls_iterations: int = 8
  contact_top_k: int = 64
  midphase_cap: int = 64
  midphase_cap_plane: int = 16
  disable_constraint: bool = False
  solver_refactor_every: int = 1
  implicit_damping: bool = False

  def replace(self, **kw) -> 'Option':
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
  """Immutable compiled model: static structure plus parameter tensors."""

  nq: int
  nv: int
  nu: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  ntendon: int
  neq: int
  nmocap: int
  npair: int

  body_parentid: Tuple[int, ...]
  body_jntadr: Tuple[int, ...]
  body_jntnum: Tuple[int, ...]
  body_dofadr: Tuple[int, ...]
  body_dofnum: Tuple[int, ...]
  body_mocapid: Tuple[int, ...]

  jnt_type: Tuple[int, ...]
  jnt_bodyid: Tuple[int, ...]
  jnt_qposadr: Tuple[int, ...]
  jnt_dofadr: Tuple[int, ...]
  jnt_limited: Tuple[bool, ...]

  dof_bodyid: Tuple[int, ...]
  dof_jntid: Tuple[int, ...]

  geom_type: Tuple[int, ...]
  geom_bodyid: Tuple[int, ...]
  geom_condim: Tuple[int, ...]

  site_bodyid: Tuple[int, ...]

  actuator_trntype: Tuple[int, ...]
  actuator_trnid: Tuple[int, ...]
  actuator_biastype: Tuple[int, ...]

  tendon_limited: Tuple[bool, ...]

  eq_type: Tuple[int, ...]
  eq_obj1: Tuple[int, ...]
  eq_obj2: Tuple[int, ...]

  pair_geom1: Tuple[int, ...]
  pair_geom2: Tuple[int, ...]
  pair_condim: Tuple[int, ...]

  body_names: Tuple[str, ...]
  jnt_names: Tuple[str, ...]
  geom_names: Tuple[str, ...]
  site_names: Tuple[str, ...]
  actuator_names: Tuple[str, ...]
  tendon_names: Tuple[str, ...]

  opt: Option

  qpos0: torch.Tensor
  body_pos: torch.Tensor
  body_quat: torch.Tensor
  body_ipos: torch.Tensor
  body_iquat: torch.Tensor
  body_mass: torch.Tensor
  body_inertia: torch.Tensor

  jnt_pos: torch.Tensor
  jnt_axis: torch.Tensor
  jnt_range: torch.Tensor
  jnt_solref: torch.Tensor
  jnt_solimp: torch.Tensor
  jnt_margin: torch.Tensor

  dof_damping: torch.Tensor
  dof_armature: torch.Tensor
  dof_frictionloss: torch.Tensor

  geom_pos: torch.Tensor
  geom_quat: torch.Tensor
  geom_size: torch.Tensor
  geom_friction: torch.Tensor
  geom_solref: torch.Tensor
  geom_solimp: torch.Tensor
  geom_margin: torch.Tensor

  site_pos: torch.Tensor
  site_quat: torch.Tensor

  actuator_gainprm: torch.Tensor
  actuator_biasprm: torch.Tensor
  actuator_ctrlrange: torch.Tensor
  actuator_forcerange: torch.Tensor
  actuator_gear: torch.Tensor

  tendon_moment: torch.Tensor
  tendon_range: torch.Tensor
  tendon_solref: torch.Tensor
  tendon_solimp: torch.Tensor
  tendon_margin: torch.Tensor

  eq_data: torch.Tensor
  eq_solref: torch.Tensor
  eq_solimp: torch.Tensor

  pair_friction: torch.Tensor
  pair_solref: torch.Tensor
  pair_solimp: torch.Tensor
  pair_margin: torch.Tensor

  dof_invweight0: torch.Tensor
  body_invweight0: torch.Tensor
  tendon_invweight0: torch.Tensor

  # Derived constants (index tables, masks) built on first use; a new
  # Model from `replace` starts with an empty cache.
  _cache: Dict[Any, Any] = dataclasses.field(
      default_factory=dict, init=False, repr=False, compare=False)

  @property
  def device(self) -> torch.device:
    return self.qpos0.device

  @property
  def dtype(self) -> torch.dtype:
    return self.qpos0.dtype

  def replace(self, **kw) -> 'Model':
    return dataclasses.replace(self, **kw)

  def cached(self, key, build: Callable[[], Any]):
    """Returns the derived constant `key`, building it once per model."""
    if key not in self._cache:
      self._cache[key] = build()
    return self._cache[key]

  def index(self, key, values) -> torch.Tensor:
    """A cached int64 index tensor on the model's device."""
    return self.cached(('index', key), lambda: torch.as_tensor(
        np.asarray(values, np.int64), device=self.device))

  def const(self, key, build: Callable[[], np.ndarray],
            dtype=None) -> torch.Tensor:
    """A cached constant tensor on the model's device (model dtype)."""
    dtype = dtype or self.dtype
    return self.cached(('const', key, dtype), lambda: torch.as_tensor(
        np.asarray(build()), dtype=dtype, device=self.device))

  def to(self, device=None, dtype=None) -> 'Model':
    """The model with every parameter tensor on `device` in `dtype`."""
    def conv(t):
      return t.to(device=device, dtype=dtype)
    kw = {f.name: conv(getattr(self, f.name)) for f in dataclasses.fields(self)
          if isinstance(getattr(self, f.name), torch.Tensor)}
    kw['opt'] = self.opt.replace(gravity=conv(self.opt.gravity))
    return self.replace(**kw)

  def id_by_name(self, kind: str, name: str) -> int:
    return getattr(self, f'{kind}_names').index(name)


def subset_pairs(model: Model, keep) -> Model:
  """Model restricted to the candidate contact pairs in `keep` (static
  index list)."""
  keep = np.asarray(keep, np.int64)
  idx = torch.as_tensor(keep, device=model.device)
  return model.replace(
      npair=int(len(keep)),
      pair_geom1=tuple(model.pair_geom1[i] for i in keep),
      pair_geom2=tuple(model.pair_geom2[i] for i in keep),
      pair_condim=tuple(model.pair_condim[i] for i in keep),
      pair_friction=model.pair_friction[idx],
      pair_solref=model.pair_solref[idx],
      pair_solimp=model.pair_solimp[idx],
      pair_margin=model.pair_margin[idx])


def moving_base_bodies(model: Model) -> set:
  """Bodies whose kinematic chain to the world crosses a FREE joint or a
  mocap body."""
  moving = [False] * model.nbody
  for b in range(1, model.nbody):
    p = model.body_parentid[b]
    here = model.body_mocapid[b] >= 0
    for k in range(model.body_jntnum[b]):
      if model.jnt_type[model.body_jntadr[b] + k] == int(JointType.FREE):
        here = True
    moving[b] = here or moving[p]
  return {b for b in range(model.nbody) if moving[b]}


# Row indices of the static per-pair parameter table (see primitives).
PARAM_MARGIN = 0
PARAM_SOLREF = slice(1, 3)
PARAM_SOLIMP = slice(3, 8)
PARAM_FRICTION = slice(8, 11)
PARAM_CONDIM = 11
PARAM_BODY1 = 12
PARAM_BODY2 = 13
PARAM_IW = 14          # body_invweight0[b1, 0] + body_invweight0[b2, 0]
NPARAM = 15


@dataclasses.dataclass(frozen=True)
class Contact:
  """Static-shape contact slots in component-plane layout."""
  dist: torch.Tensor     # (..., npoint)
  pos: torch.Tensor      # (..., 3, npoint)
  frame: torch.Tensor    # (..., 9, npoint)
  pair: torch.Tensor     # (..., npoint) int64 candidate-pair index (-1 unused)
  margin: torch.Tensor   # (..., npoint)

  def replace(self, **kw) -> 'Contact':
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Data:
  """Simulation state + forward-pass products, batch-leading."""

  time: torch.Tensor
  qpos: torch.Tensor
  qvel: torch.Tensor
  ctrl: torch.Tensor
  qfrc_applied: torch.Tensor
  xfrc_applied: torch.Tensor
  mocap_pos: torch.Tensor
  mocap_quat: torch.Tensor

  xpos: torch.Tensor
  xquat: torch.Tensor
  xipos: torch.Tensor
  ximat: torch.Tensor
  site_xpos: torch.Tensor
  site_xmat: torch.Tensor
  geom_xpos: torch.Tensor
  geom_xmat: torch.Tensor

  cdof: torch.Tensor
  cvel: torch.Tensor

  qM: torch.Tensor
  qLD: torch.Tensor
  qfrc_bias: torch.Tensor
  qfrc_passive: torch.Tensor
  qfrc_actuator: torch.Tensor
  qfrc_constraint: torch.Tensor
  qfrc_constraint_axis: torch.Tensor
  qacc_smooth: torch.Tensor
  qacc: torch.Tensor

  ten_length: torch.Tensor
  ten_velocity: torch.Tensor
  actuator_length: torch.Tensor
  actuator_velocity: torch.Tensor
  actuator_force: torch.Tensor

  contact: Contact

  def replace(self, **kw) -> 'Data':
    return dataclasses.replace(self, **kw)


def map_data(data: Data, fn: Callable) -> Data:
  """Applies fn to every tensor of a Data, its contact slots included."""
  contact = data.contact.replace(
      **{f.name: fn(getattr(data.contact, f.name))
         for f in dataclasses.fields(data.contact)})
  return data.replace(
      contact=contact,
      **{f.name: fn(getattr(data, f.name)) for f in dataclasses.fields(data)
         if f.name != 'contact'})


def make_data(model: Model, batch: Tuple[int, ...] = ()) -> Data:
  """Zero-initialized Data at qpos0 with leading batch shape `batch`, on
  the model's device in the model's dtype."""
  batch = tuple(batch)
  kw = dict(dtype=model.dtype, device=model.device)

  def z(*shape):
    return torch.zeros(batch + shape, **kw)

  def tiled(row, *shape):
    return torch.as_tensor(row, **kw).expand(batch + shape).clone()

  nq, nv, nu = model.nq, model.nv, model.nu
  nbody, nsite, ngeom = model.nbody, model.nsite, model.ngeom
  npoint = num_contact_points(model)
  ident = np.array([1.0, 0, 0, 0])
  eye3 = np.eye(3)
  return Data(
      time=z(),
      qpos=model.qpos0.expand(batch + (nq,)).clone(),
      qvel=z(nv), ctrl=z(nu), qfrc_applied=z(nv),
      xfrc_applied=z(nbody, 6),
      mocap_pos=z(model.nmocap, 3),
      mocap_quat=tiled(ident, model.nmocap, 4),
      xpos=z(nbody, 3), xquat=tiled(ident, nbody, 4), xipos=z(nbody, 3),
      ximat=tiled(eye3, nbody, 3, 3),
      site_xpos=z(nsite, 3), site_xmat=tiled(eye3, nsite, 3, 3),
      geom_xpos=z(ngeom, 3), geom_xmat=tiled(eye3, ngeom, 3, 3),
      cdof=z(nv, 6), cvel=z(nbody, 6),
      qM=z(nv, nv), qLD=z(nv, nv),
      qfrc_bias=z(nv), qfrc_passive=z(nv), qfrc_actuator=z(nv),
      qfrc_constraint=z(nv), qfrc_constraint_axis=z(nv),
      qacc_smooth=z(nv), qacc=z(nv),
      ten_length=z(model.ntendon), ten_velocity=z(model.ntendon),
      actuator_length=z(nu), actuator_velocity=z(nu), actuator_force=z(nu),
      contact=Contact(
          dist=torch.full(batch + (npoint,), 1e10, **kw),
          pos=z(3, npoint),
          frame=tiled(np.eye(3).reshape(9, 1), 9, npoint),
          pair=torch.full(batch + (npoint,), -1, dtype=torch.int64,
                          device=model.device),
          margin=z(npoint)))


def model_from_numpy(fields: Dict[str, Any], device=None,
                     dtype=torch.float32) -> Model:
  """Builds a Model from numpy arrays plus static ints and tuples.

  `fields` maps every Model field name to its value: numpy arrays for the
  parameter tensors, ints and tuples for the static structure, and for
  'opt' a dict of the Option fields (timestep and gravity as numbers or
  arrays)."""
  device = resolve_device(device)

  def tensor(v):
    return torch.as_tensor(np.array(v, np.float64), dtype=dtype,
                           device=device)

  kw = {}
  for f in dataclasses.fields(Model):
    if not f.init:
      continue
    v = fields[f.name]
    if f.name == 'opt':
      opt = dict(v)
      opt['timestep'] = float(np.asarray(opt['timestep']))
      opt['gravity'] = tensor(opt['gravity'])
      v = Option(**{o.name: opt[o.name] for o in dataclasses.fields(Option)
                    if o.name in opt})
    elif isinstance(v, np.ndarray):
      v = tensor(v)
    elif isinstance(v, tuple):
      v = tuple(x.item() if isinstance(x, np.generic) else x for x in v)
    else:
      v = int(v)
    kw[f.name] = v
  return Model(**kw)


def data_from_numpy(fields: Dict[str, Any], device=None,
                    dtype=torch.float32) -> Data:
  """Builds a Data from numpy arrays (field name -> array; 'contact' a
  dict of the Contact fields).  Contact pair ids become int64."""
  device = resolve_device(device)

  def tensor(v, dt=dtype):
    return torch.as_tensor(np.array(v), dtype=dt, device=device)

  c = fields['contact']
  contact = Contact(**{f.name: tensor(c[f.name], torch.int64 if f.name ==
                                       'pair' else dtype)
                       for f in dataclasses.fields(Contact)})
  kw = {f.name: tensor(fields[f.name]) for f in dataclasses.fields(Data)
        if f.name != 'contact'}
  return Data(contact=contact, **kw)


def collision_type(t: int) -> int:
  return int(GeomType.CAPSULE) if int(t) == int(GeomType.CYLINDER) else int(t)


def max_points_per_pair(type1: int, type2: int) -> int:
  t1, t2 = sorted((collision_type(type1), collision_type(type2)))
  box = int(GeomType.BOX)
  plane = int(GeomType.PLANE)
  if (t1, t2) == (plane, box):
    return 8
  if (t1, t2) == (box, box):
    return 8
  if t2 == box:
    return 2 if t1 == int(GeomType.CAPSULE) else 1
  if t1 == plane and t2 == int(GeomType.CAPSULE):
    return 2
  return 1


def num_contact_points(model: Model) -> int:
  """Total static contact slots: per type-group, min(n_pairs, midphase_cap)
  pairs times the group's points-per-pair."""
  groups = {}
  for g1, g2 in zip(model.pair_geom1, model.pair_geom2):
    t1 = collision_type(model.geom_type[g1])
    t2 = collision_type(model.geom_type[g2])
    key = tuple(sorted((t1, t2)))
    groups[key] = groups.get(key, 0) + 1
  cap = model.opt.midphase_cap
  cap_plane = model.opt.midphase_cap_plane or cap
  n = 0
  for (t1, t2), count in groups.items():
    gcap = cap_plane if (cap and t1 == int(GeomType.PLANE)) else cap
    m = count if cap == 0 else min(count, gcap)
    n += m * max_points_per_pair(t1, t2)
  return max(n, 1)
