"""Static kinematic-tree tables (port of dexterity_tpu/physics/tree.py).

Depth levels (with per-joint-type subsets) and pointer-doubling ancestor
tables, which turn the tree sweeps into ~log2(depth) vectorized rounds.

All tables are derived from Model's static fields only, so they are
computed once per model structure (lru_cache over the static tuples).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from reference.dex.core.types import JointType, Model


class Level(NamedTuple):
  ids: np.ndarray          # (k,) body ids at this depth (excluding world)
  parent: np.ndarray       # (k,) parent body ids
  # Per joint-type subsets (indices INTO ids/parent arrays + joint tables):
  # each is (sel, jnt_ids, qpos_adr, dof_adr) with sel indexing into ids.
  hinge: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
  slide: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
  ball: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
  free: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
  mocap: Tuple[np.ndarray, np.ndarray]  # (sel, mocap ids)
  fixed: np.ndarray        # (m,) sel of jointless, non-mocap bodies


class TreeTables(NamedTuple):
  levels: Tuple[Level, ...]
  single_jointed: bool     # every body has <= 1 joint (fast path valid)


def _subset(ids, jnt_of_body, model, jtype):
  sel, jids = [], []
  for k, b in enumerate(ids):
    ji = jnt_of_body[b]
    if ji >= 0 and model.jnt_type[ji] == int(jtype):
      sel.append(k)
      jids.append(ji)
  sel = np.asarray(sel, np.int32)
  jids = np.asarray(jids, np.int32)
  qadr = np.asarray([model.jnt_qposadr[j] for j in jids], np.int32)
  dadr = np.asarray([model.jnt_dofadr[j] for j in jids], np.int32)
  return sel, jids, qadr, dadr


@functools.lru_cache(maxsize=64)
def _build(body_parentid, body_jntadr, body_jntnum, body_mocapid,
           jnt_type, jnt_qposadr, jnt_dofadr) -> TreeTables:
  nbody = len(body_parentid)
  single = all(n <= 1 for n in body_jntnum)

  class _M:  # minimal static view for _subset
    pass

  m = _M()
  m.jnt_type = jnt_type
  m.jnt_qposadr = jnt_qposadr
  m.jnt_dofadr = jnt_dofadr

  depth = np.zeros(nbody, np.int32)
  for b in range(1, nbody):
    depth[b] = depth[body_parentid[b]] + 1

  jnt_of_body = np.full(nbody, -1, np.int32)
  for b in range(nbody):
    if body_jntnum[b] >= 1:
      jnt_of_body[b] = body_jntadr[b]

  levels: List[Level] = []
  for d in range(1, depth.max() + 1 if nbody > 1 else 1):
    ids = np.where(depth == d)[0].astype(np.int32)
    if len(ids) == 0:
      continue
    parent = np.asarray([body_parentid[b] for b in ids], np.int32)
    hinge = _subset(ids, jnt_of_body, m, JointType.HINGE)
    slide = _subset(ids, jnt_of_body, m, JointType.SLIDE)
    ball = _subset(ids, jnt_of_body, m, JointType.BALL)
    free = _subset(ids, jnt_of_body, m, JointType.FREE)
    mocap_sel, mocap_ids = [], []
    fixed = []
    for k, b in enumerate(ids):
      if body_mocapid[b] >= 0:
        mocap_sel.append(k)
        mocap_ids.append(body_mocapid[b])
      elif jnt_of_body[b] < 0:
        fixed.append(k)
    levels.append(Level(
        ids=ids, parent=parent, hinge=hinge, slide=slide, ball=ball,
        free=free,
        mocap=(np.asarray(mocap_sel, np.int32),
               np.asarray(mocap_ids, np.int32)),
        fixed=np.asarray(fixed, np.int32)))
  return TreeTables(levels=tuple(levels), single_jointed=single)


def tree_tables(model: Model) -> TreeTables:
  return _build(model.body_parentid, model.body_jntadr, model.body_jntnum,
                model.body_mocapid, model.jnt_type, model.jnt_qposadr,
                model.jnt_dofadr)


@functools.lru_cache(maxsize=64)
def jump_tables(body_parentid) -> Tuple[Tuple[int, ...], ...]:
  """Pointer-doubling ancestor tables: round k maps each body to its
  ancestor at distance 2^k (clamped at world).  len = ceil(log2(depth))."""
  parent = np.asarray(body_parentid, np.int32)
  tables = [tuple(int(x) for x in parent)]
  cur = parent
  while (cur != 0).any() and len(tables) < 32:
    cur = cur[cur]                      # parent^(2^k)
    tables.append(tuple(int(x) for x in cur))
  # The last table is all-world; rounds before it suffice, but applying the
  # extra all-world round is a harmless identity compose — drop it.
  while len(tables) > 1 and not any(tables[-1]):
    tables.pop()
  return tuple(tables)
