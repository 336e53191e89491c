"""Dexterous hand entities: Shadow Hand E, MPL (port of
dexterity_tpu/models/hands.py).

Each hand wraps a JSON model asset as a ModelSpec, adds fingertip sites
where the source lacks them, and exposes

  * joint groups and name tables,
  * control <-> joint-position projections derived from the actuator and
    tendon coupling structure (the coupling matrix and its pseudo-inverse),
  * palm-upright attachment poses,
  * joint-angle samplers over any leading batch shape.

The samplers take their randomness as tensors (uniform draws in [0, 1)),
so that a caller draws them from an explicit torch.Generator and a test
can hand them another package's draws.  The JAX package's rejection
`lax.while_loop` becomes an evaluation of the tries in rounds over the
environments that have no free try yet, as many tries at once as a fixed
row budget allows (`first_free_chunked`).

Each hand joins its geoms' mesh provenance with the packaged render
meshes (`meshes.attach_mesh_assets`): render-only data that changes no
Model field.
"""

from __future__ import annotations

import enum
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from reference.dex.core import serialization
from reference.dex.core.types import ActuatorTrn
from reference.dex.models import meshes

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'assets')
# Rows (environment x try) one rejection round evaluates at most: the
# 4 x 4096 of the goal search in the suite at B = 4096, whose peak memory
# is measured (PERF.md §5).  A batch of B environments still searching
# evaluates max(1, ROW_BUDGET // B) tries of each per round.
ROW_BUDGET = 16384

# Palm-upright pose shared by the Shadow-derived hands.
_PALM_UPRIGHT_POS = (0.0, 0.2, 0.1)
_PALM_UPRIGHT_QUAT = (0.0, 0.0, 0.707106781186, -0.707106781186)


class HandSide(enum.Enum):
  LEFT = enum.auto()
  RIGHT = enum.auto()


class HandPose:
  def __init__(self, xpos, xquat):
    self.xpos = np.asarray(xpos, np.float64)
    self.xquat = np.asarray(xquat, np.float64) / np.linalg.norm(xquat)


class JointGrouping:
  """A collection of joints belonging to a hand part."""

  def __init__(self, name: str, joint_names: Sequence[str]):
    self.name = name
    self.joint_names = tuple(joint_names)


def first_free(free: torch.Tensor) -> torch.Tensor:
  """Index of the first True along the last axis (the tries), or the last
  index where none is: the try a rejection loop that stops at the first
  success keeps."""
  tries = free.shape[-1]
  idx = torch.arange(tries, device=free.device)
  return torch.where(free, idx, tries - 1).amin(-1)


def first_free_chunked(evaluate: Callable, tries: int, batch: Tuple[int, ...],
                       device, row_budget: int = ROW_BUDGET):
  """`first_free` over every environment's tries, evaluated in rounds over
  the environments with no free try so far, each round as many tries of
  each as `row_budget` rows allow (at least one).

  evaluate(rows, t0, t1) evaluates tries [t0, t1) of the environments whose
  flat indices are `rows` ((R,) int64) and returns (free (R, t1 - t0)
  bool, payload) with payload a tensor or a tuple of tensors, each
  (R, t1 - t0, ...).

  Returns (the chosen try's payload, each (*batch, ...); ok (*batch,)
  bool, False where no try was free; the chosen try's index (*batch,)
  int64)."""
  n = int(np.prod(batch)) if batch else 1
  pick = torch.full((n,), tries - 1, dtype=torch.int64, device=device)
  ok = torch.zeros(n, dtype=torch.bool, device=device)
  out = None
  todo = torch.arange(n, device=device)
  t0 = 0
  while t0 < tries:
    t1 = min(t0 + max(1, row_budget // todo.numel()), tries)
    free, payload = evaluate(todo, t0, t1)
    single = isinstance(payload, torch.Tensor)
    payload = (payload,) if single else tuple(payload)
    if out is None:
      out = [p.new_zeros((n,) + p.shape[2:]) for p in payload]
    first = first_free(free)                          # (R,)
    found = free.any(-1)
    # The last try stands in where no try is free.
    keep = found | (t1 == tries)
    for o, p in zip(out, payload):
      val = torch.take_along_dim(
          p, first.reshape((-1,) + (1,) * (p.dim() - 1)), dim=1).squeeze(1)
      o[todo[keep]] = val[keep].to(o.dtype)
    pick[todo[found]] = t0 + first[found]
    ok[todo[found]] = True
    todo = todo[~found]
    if todo.numel() == 0:
      break
    t0 = t1
  out = tuple(o.reshape(tuple(batch) + o.shape[1:]) for o in out)
  return ((out[0] if single else out), ok.reshape(batch),
          pick.reshape(batch))


def flat_rows(data):
  """data with its leading batch axes (none for one environment) as one
  axis of environments."""
  from reference.dex.core import types
  nb = data.qpos.dim() - 1
  n = int(np.prod(data.qpos.shape[:nb]))
  return types.map_data(data, lambda x: x.reshape((n,) + x.shape[nb:]))


def repeat_rows(flat, rows: torch.Tensor, k: int):
  """The environments `rows` of a one-axis Data, each repeated k times
  in a row: (len(rows) * k, ...)."""
  from reference.dex.core import types
  n = len(rows) * k
  return types.map_data(flat, lambda x: x[rows].unsqueeze(1).expand(
      (len(rows), k) + x.shape[1:]).reshape((n,) + x.shape[1:]))


class DexterousHand:
  """Base hand entity wrapping a ModelSpec."""

  asset: str = ''
  palm_upright_pose = HandPose(_PALM_UPRIGHT_POS, _PALM_UPRIGHT_QUAT)

  def __init__(self, name: Optional[str] = None):
    self.spec = serialization.load_spec(os.path.join(_ASSETS, self.asset))
    # Join geom mesh provenance with the packaged render meshes so camera
    # observables show the vendor geometry, not the fitted primitives.
    meshes.attach_mesh_assets(self.spec, os.path.splitext(self.asset)[0])
    self.name = name or self.spec.name
    self.spec.name = self.name
    self._setup()
    # Name tables (before prefixing: hand-local).
    self.joint_names = tuple(self.spec.joint_names())
    self.actuator_names = tuple(a.name for a in self.spec.actuators)
    self._build_projections()
    self._build_joint_groups()

  # -- subclass hooks ----------------------------------------------------

  def _setup(self):
    """Adds fingertip sites / model edits before compilation."""

  @property
  def fingertip_site_names(self) -> Tuple[str, ...]:
    raise NotImplementedError

  def _build_joint_groups(self):
    groups = {}
    for jname in self.joint_names:
      groups.setdefault(_group_key(jname), []).append(jname)
    self.joint_groups = tuple(JointGrouping(k, v) for k, v in groups.items())

  # -- projections -------------------------------------------------------

  def _build_projections(self):
    """position_to_control @ qpos = the ctrl that holds that pose;
    control_to_position is its pseudo-inverse (splits a coupled command
    evenly)."""
    jnames = list(self.joint_names)
    nj = len(jnames)
    tendons = {t.name: t for t in self.spec.tendons}
    rows = []
    for a in self.spec.actuators:
      row = np.zeros(nj)
      if a.trntype == ActuatorTrn.JOINT:
        row[jnames.index(a.target)] = 1.0
      else:
        for jn, coef in tendons[a.target].joints:
          row[jnames.index(jn)] = coef
      rows.append(row)
    self.position_to_control = np.stack(rows) if rows else np.zeros((0, nj))
    self.control_to_position = np.linalg.pinv(self.position_to_control)

  def joint_positions_to_control(self, qpos):
    """(..., num_joints) -> (..., num_actuators), numpy or torch."""
    return _apply(self.position_to_control, qpos)

  def control_to_joint_positions(self, control):
    """(..., num_actuators) -> (..., num_joints), numpy or torch."""
    return _apply(self.control_to_position, control)

  # -- joint-angle sampling ----------------------------------------------

  @property
  def joint_ranges(self) -> np.ndarray:
    """(num_joints, 2) joint limits from the model spec."""
    by_name = {j.name: j for b in self.spec.worldbody.walk()
               for j in b.joints}
    return np.asarray([by_name[n].range for n in self.joint_names])

  @property
  def coupled_joint_ids(self) -> Tuple[Tuple[int, ...], ...]:
    """Joint-index groups driven by a single actuator."""
    out = []
    for row in self.position_to_control:
      nz = np.nonzero(row)[0]
      if len(nz) > 1:
        out.append(tuple(int(i) for i in nz))
    return tuple(out)

  def postprocess_sampled_joint_angles(self, qpos):
    """Forces coupled joints to share a value, over the last axis of a
    numpy array or tensor (numpy is edited in place, a tensor is not)."""
    if isinstance(qpos, torch.Tensor):
      qpos = qpos.clone()
    for ids in self.coupled_joint_ids:
      last = qpos[..., ids[-1]:ids[-1] + 1]
      qpos[..., list(ids)] = (last.clone() if isinstance(last, torch.Tensor)
                              else last.copy())
    return qpos

  def _scaled_ranges(self, range_fraction: float, like: torch.Tensor):
    if not 0 <= range_fraction <= 1:
      raise ValueError('range_fraction must be between 0 and 1.')
    rng = torch.as_tensor(self.joint_ranges * range_fraction,
                          dtype=like.dtype, device=like.device)
    return rng[:, 0], rng[:, 1]

  def sample_joint_angles(self, draws: torch.Tensor,
                          range_fraction: float = 1.0):
    """Joint configurations uniform within range_fraction * limits, from
    uniform draws in [0, 1) shaped (..., num_joints); not guaranteed
    collision-free.  The arithmetic is jax.random.uniform's on the same
    unit draws."""
    lo, hi = self._scaled_ranges(range_fraction, draws)
    qpos = torch.maximum(lo, draws * (hi - lo) + lo)
    return self.postprocess_sampled_joint_angles(qpos)

  def sample_collision_free_joint_angles(self, model, data, binding,
                                         draws: torch.Tensor,
                                         range_fraction: float = 1.0):
    """Self-collision-free configurations by rejection, for data with any
    leading batch shape.

    draws (*batch, T, num_joints) holds T tries' uniform draws per
    environment.  Each try sets the hand's qpos, runs `fwd_position` and
    rejects a self-collision; an environment keeps its first free try, or
    its last when all T collide (the JAX package's bounded
    lax.while_loop; `ok` is False then).  Tries run in rounds over the
    environments with no free try yet (first_free_chunked).  `data` is
    not modified.

    Returns (qpos (*batch, num_joints), ok (*batch,))."""
    from reference.dex.physics import step as physics_step
    from reference.dex.utils import collisions
    batch = tuple(data.qpos.shape[:-1])
    tries = draws.shape[-2]
    self_mask = model.cached(('self_mask', binding.prefix), lambda: (
        torch.as_tensor(collisions.self_mask(model, binding.prefix),
                        device=model.device)))
    qadr = model.index(('hand_qadr', binding.prefix), binding.qpos_adr)
    qpos_all = self.sample_joint_angles(
        draws.to(device=data.qpos.device, dtype=data.qpos.dtype),
        range_fraction).reshape((-1, tries, self.num_joints))
    flat = flat_rows(data)

    def evaluate(rows, t0, t1):
      k = t1 - t0
      cand = repeat_rows(flat, rows, k)
      q = qpos_all[rows, t0:t1]                           # (R, k, nj)
      qpos = cand.qpos.clone()
      qpos[:, qadr] = q.reshape(-1, self.num_joints)
      cand = physics_step.fwd_position(model, cand.replace(qpos=qpos))
      free = ~collisions.has_collision(cand, self_mask)
      return free.reshape(len(rows), k), q

    qpos, ok, _ = first_free_chunked(evaluate, tries, batch,
                                     data.qpos.device)
    return qpos, ok

  @property
  def num_joints(self) -> int:
    return len(self.joint_names)

  @property
  def num_actuators(self) -> int:
    return len(self.actuator_names)

  @property
  def underactuated(self) -> bool:
    return self.num_actuators < self.num_joints


def _apply(matrix: np.ndarray, x):
  """matrix @ x over the last axis of a numpy array or a tensor."""
  if isinstance(x, torch.Tensor):
    return x @ torch.as_tensor(matrix, dtype=x.dtype, device=x.device).T
  return np.asarray(x) @ matrix.T


def _group_key(joint_name: str) -> str:
  """Maps joint names to part groups (WR/FF/MF/RF/LF/TH or MPL parts)."""
  for prefix in ('WR', 'FF', 'MF', 'RF', 'LF', 'TH'):
    if joint_name.startswith(prefix):
      return prefix
  return joint_name.split('_')[0]


class ShadowHandSeriesE(DexterousHand):
  """Shadow Dexterous Hand E: 24 joints / 20 actuators, tendon-coupled
  distal pairs."""

  asset = 'shadow_hand_e.json'

  def _setup(self):
    # Fingertip sites at the tip body origins.
    for tip in ('fftip', 'mftip', 'rftip', 'lftip', 'thtip'):
      body = self.spec.find_body(tip)
      body.add_site(f'{tip}_site', pos=np.zeros(3),
                    size=np.full(3, 0.001), rgba=(1.0, 0.0, 0.0, 1.0),
                    group=4)

  @property
  def fingertip_site_names(self) -> Tuple[str, ...]:
    return ('fftip_site', 'mftip_site', 'rftip_site', 'lftip_site',
            'thtip_site')

  @property
  def coupled_joint_names(self):
    """Tendon-coupled (J0, J1) pairs driven by a single actuator."""
    return tuple(
        tuple(jn for jn, _ in t.joints)
        for t in self.spec.tendons
        if any(a.target == t.name and a.trntype == ActuatorTrn.TENDON
               for a in self.spec.actuators))


class MPLHand(DexterousHand):
  """Modular Prosthetic Limb: 22 joints / 13 actuators, polynomial
  equality couplings."""

  def __init__(self, side: HandSide = HandSide.RIGHT,
               name: Optional[str] = None):
    self.asset = ('mpl_left.json' if side == HandSide.LEFT
                  else 'mpl_right.json')
    self.side = side
    super().__init__(name=name)

  @property
  def fingertip_site_names(self) -> Tuple[str, ...]:
    # Distal touch sites of the source model.
    return ('index_distal', 'middle_distal', 'ring_distal', 'pinky_distal',
            'thumb_distal')
