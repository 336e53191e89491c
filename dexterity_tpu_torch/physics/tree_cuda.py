"""Fused tree sweep: hand-written CUDA kernels for Hopper (port of
dexterity_tpu/physics/tree_pallas.py).

Two kernels, one source (`csrc/tree_sweep.cu`), each beside its plain
PyTorch version:

  tree_fk  (K5)  <- tree_pallas._kernel_body: FK, cdof, geom and inertial
                    frames, body10, tendon length/velocity  (fk_plain)
  tree_dyn (K6)  <- tree_pallas._kernel_dyn: CRB qm, RNE qfrc_bias
                    (dyn_plain)

`build_tree_sweep(model)` returns
fn(qpos (nq, B), qvel (nv, B), mocap_pos (3·nmocap, B),
   mocap_quat (4·nmocap, B)) -> dict of batch-minor (rows, B) arrays with
the keys and row layouts of tree_pallas's `_fk_shapes` without `body10`,
plus `qm` (nv·nv, B, row v·nv + w) and `qfrc_bias` (nv, B), as JAX's `fn`.
Component rows come first: row c·n + i is component c of element i (xpos
c·nbody + b, cdof c·nv + v with c over [ang(3), lin(3)], gmat k·ngeom + g
with k over the row-major 3x3, ...).

The mocap inputs are component-major too: row c·nmocap + m is component c
of mocap body m, the convention `_kernel_body` itself reads
(`_rows(mocap_pos, 3)`).  (tests/test_tree_pallas.py feeds JAX a
mocap-major reshape of an (nmocap, 3, B) array; the two agree only for
nmocap = 1.)

On CUDA tensors the call launches K5, then K6; on CPU tensors it runs the
plain versions (`tree_sweep_plain`), built from the port's own plane
functions (those `step._precompute_planes` runs), which need not replay
the Pallas kernels' one-hot-matmul formulation.  The kernels take float32
or float64 and any batch size (no lane multiple).  There is no switch: on
CUDA tensors K6 is always the kernel.

Bound on the card at the reorient planning model (nbody 33, nv 30, nq 31,
ngeom 236, ntendon 4, nmocap 1), B = 1024, float32: K5 moves 68 input and
3,680 output rows (15.35 MB, 4.6 us at 3.35 TB/s), K6 540 input and 930
output rows (6.02 MB, 1.8 us).  Both do far less arithmetic than the FP32
rate allows.  K5 computes every body's local pose at once and composes the
world poses level by level over a static table of the bodies by tree depth
(10 levels for the hand), then spreads the outputs over a CTA's threads in
16-byte chunks of rollouts: a CTA's tile is one 128-byte line of each
output row, its items a quarter of the rows.  K6 computes what
`_kernel_dyn` computes, every tree recursion a gather over the static
tables below (subtrees, ancestor dofs, qm entry kinds), in six phases
shared by a CTA's threads (see the source's header).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from dexterity_tpu_torch.core.types import JointType, Model
from dexterity_tpu_torch.physics import cuda_build, kinematics, smooth

# Launch counts per kernel: one added per kernel launch, nowhere else.
launches = {'tree_sweep_fk': 0, 'tree_sweep_dyn': 0}

# Segment order of the packed tables; csrc/tree_sweep.cu's IntSeg and
# FloatSeg enums list the same names in the same order.  K5 composes the
# world poses level by level over a CSR list of the bodies by tree depth
# (`level_ptr`, then `level_body`).  K6's gathers read two CSR lists, each
# body's subtree and each body's ancestor-or-self dofs, and each qm entry's
# kind (_QM_KINDS).  K5 copies the int buffer from its header through
# dof_body into shared memory, K6 its own int segments (dof_body and the
# last five) as one block; each copies the float buffer's segments it reads.
_INT_SEGS = ('body_parent', 'body_jtype', 'body_qadr', 'body_mocap',
             'dof_jtype', 'dof_jofs', 'geom_body', 'level_ptr', 'level_body',
             'dof_body', 'body_sub_ptr', 'body_sub', 'body_ancdof_ptr',
             'body_ancdof', 'qm_kind')
_FLOAT_SEGS = ('body_pos', 'body_quat', 'body_jaxis', 'body_jpos',
               'body_ipos', 'body_iquat', 'body_mass', 'body_inertia',
               'dof_jaxis', 'dof_jpos', 'dof_armature', 'dof_keep',
               'geom_pos', 'geom_quat', 'gravity', 'ten_qsel',
               'ten_moment')

# Kind of qm entry (v, w) in `qm_kind`: off the CRB pattern, on its strict
# upper triangle (v < w), on the mirror of that below the diagonal, or on
# the diagonal (the kernel's kQmZero .. kQmDiag).
_QM_KINDS = ('zero', 'upper', 'mirrored', 'diagonal')

# Bytes of K5's tile of rollouts: one 128-byte line of each row, 32
# float32 or 16 float64 rollouts (the kernel's kFkLine).  K6's rollouts
# and threads per CTA (its tile is the kernel's kDynTile).  Both tiles are
# checked at binding.  Shared memory one block may use on Hopper: 227 KB.
_FK_LINE = 128
_DYN_TILE = 8
_DYN_THREADS = 512
_MAX_SMEM = 232448

_lib = None


def reset_launches() -> None:
  for k in launches:
    launches[k] = 0


def supports(model: Model) -> bool:
  """Static capability check: HINGE/SLIDE/FREE joints, at most one joint
  per body (tree_pallas.supports)."""
  ok = {int(JointType.HINGE), int(JointType.SLIDE), int(JointType.FREE)}
  if not set(int(t) for t in model.jnt_type) <= ok:
    return False
  return all(model.body_jntnum[b] <= 1 for b in range(model.nbody))


def build() -> ctypes.CDLL:
  """Builds (if a source changed) and loads the kernel library; later
  calls return it without a lock (cuda_build holds one over the build)."""
  global _lib
  if _lib is None:
    lib = cuda_build.library('tree_sweep')
    lib.dex_tree_layout.restype = ctypes.c_int
    lib.dex_tree_layout.argtypes = [ctypes.c_int]
    if tuple(lib.dex_tree_layout(k) for k in range(4)) != (
        len(_INT_SEGS), len(_FLOAT_SEGS), _DYN_TILE, _FK_LINE):
      raise RuntimeError('tree_sweep.cu and tree_cuda.py disagree on the '
                         'table layout or the kernels\' tiles')
    dims = [ctypes.c_int] * 6
    lib.dex_tree_fk.restype = ctypes.c_int
    lib.dex_tree_fk.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + dims
        + [ctypes.c_void_p] * 5
        + [ctypes.c_int64, ctypes.c_void_p])
    lib.dex_tree_dyn.restype = ctypes.c_int
    lib.dex_tree_dyn.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + dims
        + [ctypes.c_void_p] * 5
        + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    _lib = lib
  return _lib


# ---------------------------------------------------------------------------
# Static tables
# ---------------------------------------------------------------------------


def _csr(mask: np.ndarray):
  """(row pointers, column indices) of the nonzeros of a 0/1 mask."""
  rows, cols = np.nonzero(mask)
  return np.searchsorted(rows, np.arange(mask.shape[0] + 1)), cols


def _levels(model: Model):
  """The bodies by tree depth as a CSR list: (level pointers, bodies),
  level 0 the world alone, each level's bodies in index order."""
  depth = np.zeros(model.nbody, np.int64)
  for b in range(1, model.nbody):
    depth[b] = depth[model.body_parentid[b]] + 1
  order = np.argsort(depth, kind='stable')
  return np.searchsorted(depth[order], np.arange(depth.max() + 2)), order


def _qm_kind(model: Model) -> np.ndarray:
  """(nv, nv) index into _QM_KINDS of each qm entry, from the CRB pattern
  smooth._dof_upper_mask_np."""
  up = smooth._dof_upper_mask_np(model).astype(bool)
  eye = np.eye(model.nv, dtype=bool)
  return (1 * (up & ~eye) + 2 * (up.T & ~eye) + 3 * eye).astype(np.int64)


def tables_np(model: Model):
  """The kernels' packed tables as numpy: (int32 buffer, float64 buffer).
  The int buffer opens with every segment's offset (int segments, then
  float segments)."""
  if not supports(model):
    raise ValueError('tree sweep: the model has joints other than '
                     'hinge/slide/free or bodies with several joints')
  nbody, nv, nq = model.nbody, model.nv, model.nq
  for b in range(1, nbody):
    if not model.body_parentid[b] < b:
      raise ValueError(f'tree sweep: body {b} precedes its parent')
  host = lambda t: t.detach().cpu().double().numpy()
  jnt_of = [model.body_jntadr[b] if model.body_jntnum[b] else -1
            for b in range(nbody)]
  jnt_axis, jnt_pos = host(model.jnt_axis), host(model.jnt_pos)
  zeros3 = np.zeros(3)
  dof_jnt = [model.dof_jntid[v] for v in range(nv)]
  trans_free = np.zeros(nv, bool)
  for j in range(model.njnt):
    if model.jnt_type[j] == int(JointType.FREE):
      trans_free[model.jnt_dofadr[j]:model.jnt_dofadr[j] + 3] = True
  level_ptr, level_body = _levels(model)
  sub_ptr, sub = _csr(smooth._subtree_mask_np(model))
  anc_ptr, anc = _csr(kinematics.ancestor_mask(model))
  tm = host(model.tendon_moment).reshape(model.ntendon, nv)
  qsel = np.zeros((model.ntendon, nq))
  dq_adr = kinematics._dof_qposadr(model)
  for k in range(model.ntendon):
    for v in range(nv):
      qsel[k, dq_adr[v]] += tm[k, v]
  ints = dict(
      body_parent=model.body_parentid,
      body_jtype=[model.jnt_type[j] if j >= 0 else -1 for j in jnt_of],
      body_qadr=[model.jnt_qposadr[j] if j >= 0 else 0 for j in jnt_of],
      body_mocap=model.body_mocapid, dof_body=model.dof_bodyid,
      dof_jtype=[model.jnt_type[j] for j in dof_jnt],
      dof_jofs=[v - model.jnt_dofadr[dof_jnt[v]] for v in range(nv)],
      geom_body=model.geom_bodyid, level_ptr=level_ptr,
      level_body=level_body, body_sub_ptr=sub_ptr, body_sub=sub,
      body_ancdof_ptr=anc_ptr, body_ancdof=anc, qm_kind=_qm_kind(model))
  floats = dict(
      body_pos=host(model.body_pos), body_quat=host(model.body_quat),
      body_jaxis=[jnt_axis[j] if j >= 0 else zeros3 for j in jnt_of],
      body_jpos=[jnt_pos[j] if j >= 0 else zeros3 for j in jnt_of],
      body_ipos=host(model.body_ipos), body_iquat=host(model.body_iquat),
      body_mass=host(model.body_mass),
      body_inertia=host(model.body_inertia),
      dof_jaxis=[jnt_axis[j] for j in dof_jnt],
      dof_jpos=[jnt_pos[j] for j in dof_jnt],
      dof_armature=host(model.dof_armature),
      dof_keep=1.0 - trans_free, geom_pos=host(model.geom_pos),
      geom_quat=host(model.geom_quat), gravity=host(model.opt.gravity),
      ten_qsel=qsel, ten_moment=tm)
  head = len(_INT_SEGS) + len(_FLOAT_SEGS)
  int_parts = [np.asarray(ints[k], np.int64).reshape(-1) for k in _INT_SEGS]
  float_parts = [np.asarray(floats[k], np.float64).reshape(-1)
                 for k in _FLOAT_SEGS]
  offsets = np.cumsum([head] + [len(p) for p in int_parts])[:-1]
  foffsets = np.cumsum([0] + [len(p) for p in float_parts])[:-1]
  ti = np.concatenate([offsets, foffsets] + int_parts).astype(np.int32)
  tf = np.concatenate(float_parts) if float_parts else np.zeros(0)
  return ti, tf


def _device_tables(model: Model, dtype: torch.dtype, device):
  def build_tabs():
    ti, tf = tables_np(model)
    return (torch.as_tensor(ti, device=device),
            torch.as_tensor(tf, dtype=dtype, device=device))
  return model.cached(('tree_sweep_tables', str(device), dtype), build_tabs)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _check(want_rows, *xs):
  """Inputs are (rows, B) with the given rows, on one device in one
  dtype."""
  b = xs[0].shape[-1]
  got = tuple(tuple(x.shape) for x in xs)
  want = tuple((r, b) for r in want_rows)
  if got != want:
    raise ValueError(f'tree sweep: input shapes {got}, expected {want}')
  if len({x.device for x in xs}) != 1 or len({x.dtype for x in xs}) != 1:
    raise TypeError('tree sweep: inputs differ in device or dtype')


def _check_inputs(model: Model, qpos, qvel, mocap_pos, mocap_quat):
  _check((model.nq, model.nv, 3 * model.nmocap, 4 * model.nmocap), qpos,
         qvel, mocap_pos, mocap_quat)


def fk_plain(model: Model, qpos, qvel, mocap_pos, mocap_quat):
  """K5's function from the port's plane functions, in the kernels'
  (rows, B) layout, body10 included."""
  _check_inputs(model, qpos, qvel, mocap_pos, mocap_quat)
  nb, nv, ng, nm = model.nbody, model.nv, model.ngeom, model.nmocap
  b = qpos.shape[-1]
  xpos, xquat, cdof6 = kinematics.body_poses_planes(
      model, qpos, mocap_pos.reshape(3, nm, b).transpose(0, 1),
      mocap_quat.reshape(4, nm, b).transpose(0, 1))
  gpos, gmat = kinematics.frame_planes(
      xpos, xquat, model.index('geom_bodyid', model.geom_bodyid),
      model.geom_pos, model.geom_quat, qpos.dtype)
  body10, xipos = smooth.inertia_origin_planes(model, xpos, xquat)
  if model.ntendon:
    dof_qposadr = model.index('dof_qposadr', kinematics._dof_qposadr(model))
    tm = model.tendon_moment.to(qpos.dtype)
    ten_length = torch.tensordot(tm, qpos[dof_qposadr], 1)
    ten_velocity = torch.tensordot(tm, qvel, 1)
  else:
    ten_length = ten_velocity = qpos.new_zeros((0, b))
  return dict(
      xpos=xpos.reshape(3 * nb, b), xquat=xquat.reshape(4 * nb, b),
      cdof=cdof6.reshape(6 * nv, b), gpos=torch.stack(gpos).reshape(
          3 * ng, b), gmat=torch.stack(gmat).reshape(9 * ng, b),
      xipos=xipos.reshape(3 * nb, b), body10=body10.reshape(10 * nb, b),
      ten_length=ten_length, ten_velocity=ten_velocity)


def dyn_plain(model: Model, cdof, body10, qvel):
  """K6's function: CRB qm (nv·nv, B) and RNE qfrc_bias (nv, B) from cdof
  (6·nv, B), body10 (10·nbody, B) and qvel (nv, B)."""
  nb, nv = model.nbody, model.nv
  b = qvel.shape[-1]
  cdof6 = cdof.reshape(6, nv, b)
  b10 = body10.reshape(10, nb, b)
  qm = smooth.crb_planes(model, b10, cdof6)
  qfrc_bias, _ = smooth.rne_planes(model, b10, cdof6, qvel)
  return dict(qm=qm.reshape(nv * nv, b), qfrc_bias=qfrc_bias)


def tree_sweep_plain(model: Model, qpos, qvel, mocap_pos, mocap_quat):
  """The whole sweep, plain: fk_plain then dyn_plain, without body10."""
  out = fk_plain(model, qpos, qvel, mocap_pos, mocap_quat)
  body10 = out.pop('body10')
  out.update(dyn_plain(model, out['cdof'], body10, qvel))
  return out


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _fk_smem(model: Model, elem: int) -> int:
  """K5's shared memory in bytes, mirroring csrc/tree_sweep.cu's
  fk_smem_bytes: 7 pose rows per body and the input rows, a tile's values
  (_FK_LINE bytes) each; the float tables; the int tables through dof_body
  (each table rounded up to 16 bytes)."""
  nb, nv, ng, nt = model.nbody, model.nv, model.ngeom, model.ntendon
  r16 = lambda x: (x + 15) // 16 * 16
  rows = 7 * nb + model.nq + nv + 7 * model.nmocap
  floats = 24 * nb + 8 * nv + 7 * ng + 3 + nt * (model.nq + nv)
  ints = len(_INT_SEGS) + len(_FLOAT_SEGS) + 6 * nb + 3 * nv + ng + 1
  return rows * _FK_LINE + r16(floats * elem) + r16(4 * ints)


def _check_fits(model: Model, x: torch.Tensor) -> None:
  """Raises where the kernels do not take x's dtype or the model does not
  fit in their shared memory (K5: `_fk_smem`; K6: csrc/tree_sweep.cu's
  dyn_smem_bytes, mirrored here)."""
  if x.dtype not in (torch.float32, torch.float64):
    raise TypeError(f'tree sweep: dtype {x.dtype} is not float32/float64')
  elem = x.element_size()
  nb, nv = model.nbody, model.nv
  ints = nv + 2 * (nb + 1) + nb * nb + nb * nv + nv * nv
  dyn = ((19 * nv + 32 * nb) * _DYN_TILE + 2 * nv + 3) * elem + 4 * ints
  if max(_fk_smem(model, elem), dyn) > _MAX_SMEM:
    raise ValueError(f'tree sweep: nbody={model.nbody}, nv={model.nv} '
                     'exceed the shared memory')


def _route(model: Model, x: torch.Tensor) -> bool:
  """True for the kernel (CUDA tensors), False for the plain version (CPU
  tensors); raises on anything else."""
  if x.device != model.device:
    raise ValueError(f'tree sweep: inputs on {x.device}, model on '
                     f'{model.device}')
  if x.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'tree sweep: unsupported device {x.device}')
  return x.device.type == 'cuda'


# K5's outputs in the order of its one (rows, B) buffer.
_FK_KEYS = ('xpos', 'xquat', 'cdof', 'gpos', 'gmat', 'xipos', 'body10',
            'ten_length', 'ten_velocity')


def _fk_rows(model: Model):
  nb, nv, ng, nt = model.nbody, model.nv, model.ngeom, model.ntendon
  return (3 * nb, 4 * nb, 6 * nv, 3 * ng, 9 * ng, 3 * nb, 10 * nb, nt, nt)


def tree_fk(model: Model, qpos, qvel, mocap_pos, mocap_quat):
  """K5: fk_plain's outputs (body10 included); the kernel for CUDA
  tensors, fk_plain for CPU tensors.  On the card the outputs are row
  views of one (rows, B) buffer, so any one of them kept alive keeps the
  whole buffer (15 MB at the reorient planning model, B = 1024, float32)
  alive: clone an output to keep it alone."""
  _check_inputs(model, qpos, qvel, mocap_pos, mocap_quat)
  if not _route(model, qpos):
    return fk_plain(model, qpos, qvel, mocap_pos, mocap_quat)
  _check_fits(model, qpos)
  lib = build()
  ti, tf = _device_tables(model, qpos.dtype, qpos.device)
  qpos, qvel, mocap_pos, mocap_quat = (
      x.contiguous() for x in (qpos, qvel, mocap_pos, mocap_quat))
  rows = _fk_rows(model)
  b = qpos.shape[-1]
  buf = qpos.new_empty((sum(rows), b))
  err = cuda_build.launch(
      lib.dex_tree_fk, qpos.device, qpos.element_size(), ti.data_ptr(),
      tf.data_ptr(), model.nbody, model.nv, model.nq, model.ngeom,
      model.ntendon, model.nmocap, qpos.data_ptr(), qvel.data_ptr(),
      mocap_pos.data_ptr(), mocap_quat.data_ptr(), buf.data_ptr(), b)
  if err != 0:
    raise RuntimeError(f'tree_sweep_fk: kernel launch failed (cudaError '
                       f'{err})')
  launches['tree_sweep_fk'] += 1
  return dict(zip(_FK_KEYS, buf.split_with_sizes(rows)))


def tree_dyn(model: Model, cdof, body10, qvel):
  """K6: dyn_plain's outputs; the kernel for CUDA tensors, dyn_plain for
  CPU tensors."""
  nb, nv = model.nbody, model.nv
  b = qvel.shape[-1]
  _check((6 * nv, 10 * nb, nv), cdof, body10, qvel)
  if not _route(model, qvel):
    return dyn_plain(model, cdof, body10, qvel)
  _check_fits(model, qvel)
  lib = build()
  dev, dtype = qvel.device, qvel.dtype
  ti, tf = _device_tables(model, dtype, dev)
  cdof, body10, qvel = (x.contiguous() for x in (cdof, body10, qvel))
  qm = torch.empty((nv * nv, b), dtype=dtype, device=dev)
  qfrc_bias = torch.empty((nv, b), dtype=dtype, device=dev)
  err = cuda_build.launch(
      lib.dex_tree_dyn, dev, qvel.element_size(), ti.data_ptr(),
      tf.data_ptr(), nb, nv, model.nq, model.ngeom, model.ntendon,
      model.nmocap, cdof.data_ptr(), body10.data_ptr(), qvel.data_ptr(),
      qm.data_ptr(), qfrc_bias.data_ptr(), b, _DYN_THREADS)
  if err != 0:
    raise RuntimeError(f'tree_sweep_dyn: kernel launch failed (cudaError '
                       f'{err})')
  launches['tree_sweep_dyn'] += 1
  return dict(qm=qm, qfrc_bias=qfrc_bias)


def build_tree_sweep(model: Model, B: Optional[int] = None):
  """Returns the fused sweep for `model` (see the module docstring): K5
  then K6 on CUDA tensors, the plain version on CPU tensors.  B, when
  given, is the only batch size fn accepts."""
  if not supports(model):
    raise ValueError('tree sweep: unsupported model (see supports)')
  tables_np(model)    # validates the tree once, at build time

  def fn(qpos, qvel, mocap_pos, mocap_quat):
    if B is not None and qpos.shape[-1] != B:
      raise ValueError(f'tree sweep: built for B={B}, got '
                       f'{qpos.shape[-1]}')
    out = tree_fk(model, qpos, qvel, mocap_pos, mocap_quat)
    body10 = out.pop('body10')
    out.update(tree_dyn(model, out['cdof'], body10, qvel))
    return out

  return fn
