"""Model compiler of the PyTorch port against the JAX package.

The port compiles the ShadowHand reorient scene itself (its own copies of
the spec compiler, serialization, hand/prop/arena models and asset); the
compiled Model must equal the JAX one: static ints, name tuples and index
tables exactly, float arrays to 1e-12, inverse weights to rtol 1e-9.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation
from dexterity_tpu.core import types as JT
from dexterity_tpu.planners import common as jcommon
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.planners import common as pcommon

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PLAN = dict(solver_iterations=4, ls_iterations=6, solver_refactor_every=2,
             plan_substeps=3, plan_midphase_cap=16, plan_contact_top_k=16,
             plan_implicit_damping=True, plan_self_collision=False)


@pytest.fixture(scope='module')
def tasks():
  jtask = manipulation.build_task('reorient', 'state_dense')
  ptask = pmanip.build_task('reorient', 'state_dense')
  return jtask, ptask


@pytest.fixture(scope='module')
def models(tasks):
  jtask, ptask = tasks
  return jtask.compile(), ptask.compile(device='cpu', dtype=torch.float64)


def _fields(kind):
  out = []
  for f in dataclasses.fields(PT.Model):
    if not f.init or f.name == 'opt':
      continue
    is_tensor = f.type in ('torch.Tensor',)
    if kind == 'static' and not is_tensor:
      out.append(f.name)
    elif kind == 'invweight' and is_tensor and 'invweight' in f.name:
      out.append(f.name)
    elif kind == 'arrays' and is_tensor and 'invweight' not in f.name:
      out.append(f.name)
  return out


def _compare_models(jm, pm):
  for name in _fields('static'):
    assert getattr(pm, name) == getattr(jm, name), name
  for name in _fields('arrays'):
    a, b = np.asarray(getattr(jm, name)), getattr(pm, name).numpy()
    assert a.shape == b.shape, name
    np.testing.assert_allclose(b, a, atol=1e-12, rtol=0, err_msg=name)
  for name in _fields('invweight'):
    np.testing.assert_allclose(getattr(pm, name).numpy(),
                               np.asarray(getattr(jm, name)), rtol=1e-9,
                               err_msg=name)
  for f in dataclasses.fields(PT.Option):
    a, b = getattr(jm.opt, f.name), getattr(pm.opt, f.name)
    if isinstance(b, torch.Tensor):
      np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-12)
    elif f.name == 'timestep':
      assert b == pytest.approx(float(np.asarray(a)), abs=1e-15)
    else:
      assert b == a, f.name


def test_asset_copy_is_byte_equal():
  name = os.path.join('models', 'assets', 'shadow_hand_e.json')
  assert filecmp.cmp(os.path.join(_ROOT, 'dexterity_tpu', name),
                     os.path.join(_ROOT, 'dexterity_tpu_torch', name),
                     shallow=False)


@pytest.mark.parametrize('kind', ['static', 'arrays', 'invweight'])
def test_compiled_model_fields_match_jax(models, kind):
  jm, pm = models
  names = _fields(kind)
  assert names
  for name in names:
    a, b = getattr(jm, name), getattr(pm, name)
    if kind == 'static':
      assert b == a, name
    elif kind == 'arrays':
      a = np.asarray(a)
      assert a.shape == tuple(b.shape), name
      np.testing.assert_allclose(b.numpy(), a, atol=1e-12, rtol=0,
                                 err_msg=name)
    else:
      np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                                 err_msg=name)


def test_compiled_options_match_jax(models):
  jm, pm = models
  _compare_models(jm, pm)
  assert pm.device.type == 'cpu' and pm.dtype == torch.float64


def test_planning_model_matches_jax(tasks):
  jtask, ptask = tasks
  jm, jn = jcommon.reduced_planning_model(jtask, **_PLAN)
  pm, pn = pcommon.reduced_planning_model(ptask, device='cpu',
                                          dtype=torch.float64, **_PLAN)
  assert pn == jn == 3
  assert pm.npair == jm.npair < 833
  _compare_models(jm, pm)
  assert PT.num_contact_points(pm) == JT.num_contact_points(jm)
  assert PT.moving_base_bodies(pm) == JT.moving_base_bodies(jm)


def test_subset_pairs_matches_jax(models):
  jm, pm = models
  keep = list(range(0, jm.npair, 7))
  _compare_models(JT.subset_pairs(jm, keep), PT.subset_pairs(pm, keep))


def test_model_from_numpy_carries_jax_model(models):
  jm, pm = models
  fields = {}
  for f in dataclasses.fields(PT.Model):
    if not f.init:
      continue
    v = getattr(jm, f.name)
    if f.name == 'opt':
      v = {o.name: getattr(v, o.name) for o in dataclasses.fields(PT.Option)}
      v['gravity'] = np.asarray(v['gravity'])
    elif not isinstance(v, (tuple, int)):
      v = np.asarray(v)
    fields[f.name] = v
  carried = PT.model_from_numpy(fields, device='cpu', dtype=torch.float64)
  _compare_models(jm, carried)
  f32 = PT.model_from_numpy(fields, device='cpu')
  assert f32.dtype == torch.float32


def test_data_from_numpy_carries_jax_data(models):
  jm, _ = models
  rng = np.random.default_rng(0)
  jd = JT.make_data(jm)
  jd = jd.replace(qpos=jd.qpos + 0.01 * rng.normal(size=jm.nq),
                  qvel=rng.normal(size=jm.nv))
  fields = {f.name: np.asarray(getattr(jd, f.name))
            for f in dataclasses.fields(PT.Data) if f.name != 'contact'}
  fields['contact'] = {f.name: np.asarray(getattr(jd.contact, f.name))
                       for f in dataclasses.fields(PT.Contact)}
  pd = PT.data_from_numpy(fields, device='cpu', dtype=torch.float64)
  for f in dataclasses.fields(PT.Data):
    if f.name != 'contact':
      np.testing.assert_array_equal(getattr(pd, f.name).numpy(),
                                    fields[f.name], err_msg=f.name)
  for f in dataclasses.fields(PT.Contact):
    np.testing.assert_array_equal(getattr(pd.contact, f.name).numpy(),
                                  fields['contact'][f.name])
  assert pd.contact.pair.dtype == torch.int64
  assert PT.data_from_numpy(fields, device='cpu').qpos.dtype == torch.float32


def test_make_data_matches_jax(models):
  jm, pm = models
  jd = JT.make_data(jm)
  pd = PT.make_data(pm, (2,))
  for f in dataclasses.fields(PT.Data):
    if f.name == 'contact':
      continue
    a = np.asarray(getattr(jd, f.name))
    b = getattr(pd, f.name).numpy()
    assert b.shape == (2,) + a.shape, f.name
    np.testing.assert_array_equal(b[1], a, err_msg=f.name)
  for f in dataclasses.fields(PT.Contact):
    a = np.asarray(getattr(jd.contact, f.name))
    np.testing.assert_array_equal(getattr(pd.contact, f.name).numpy()[0], a)


def test_compile_is_cached_per_device_and_dtype(tasks):
  _, ptask = tasks
  a = ptask.compile(device='cpu', dtype=torch.float64)
  assert ptask.compile(device='cpu', dtype=torch.float64) is a
  b = ptask.compile(device='cpu', dtype=torch.float32)
  assert b is not a and b.dtype == torch.float32
  np.testing.assert_allclose(b.body_mass.double().numpy(),
                             a.body_mass.numpy(), rtol=1e-6)


def test_unknown_task_raises():
  with pytest.raises(ValueError):
    pmanip.build_task('reorient', 'nope')
