"""The port's effector and environment wrappers, checkpoint and profiling
helpers against the JAX package.

The effector wrappers run inside a batched reorient environment of the
port (float64, CPU) and are held against JAX's `vmap` of the same wrapped
effector fed the same clipped commands: every row keeps its own smoothing
and previous action, and a row that resets starts its smoothing afresh
while the others keep theirs.  Both sides compute 0.3 · c + 0.7 · p in
float64, held to 1e-14.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.core import types as JT
from dexterity_tpu.effectors.wrappers import previous_action as jprev
from dexterity_tpu.effectors.wrappers import smooth_action as jsmooth
from dexterity_tpu.manipulation import wrappers as jwrappers
from dexterity_tpu.utils import checkpoint as jcheckpoint
from dexterity_tpu_torch import environment as penv_lib
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.effectors.wrappers import base as pbase
from dexterity_tpu_torch.effectors.wrappers import previous_action as pprev
from dexterity_tpu_torch.effectors.wrappers import smooth_action as psmooth
from dexterity_tpu_torch.envs import batched as pbatched
from dexterity_tpu_torch.manipulation import wrappers as pwrappers
from dexterity_tpu_torch.utils import checkpoint as pcheckpoint
from dexterity_tpu_torch.utils import profiling as pprofiling
from dexterity_tpu_torch.utils import structs

F64 = dict(device='cpu', dtype=torch.float64)
_ALPHA = 0.3
_B = 3
_RESET_ROW = 1


def _wrap(eff, smooth_mod, prev_mod):
  return smooth_mod.SmoothAction(prev_mod.PreviousAction(eff), _ALPHA)


@pytest.fixture(scope='module')
def run():
  """The port's batched reorient run with the wrapped hand effector:
  reset of 3 episodes, 2 steps, row 1 reset, a third step; the state after
  each step and the clipped commands."""
  task = pmanip.build_task('reorient', 'state_dense')
  task._hand_effectors = tuple(_wrap(e, psmooth, pprev)
                               for e in task._hand_effectors)
  env = penv_lib.GoalEnvironment(task, **F64)
  benv = pbatched.BatchedEnvironment(env, _B)
  gen = torch.Generator().manual_seed(0)
  state, _ = benv.reset(gen)
  spec = env.action_spec()
  rng = np.random.RandomState(0)
  lo, hi = spec.minimum, spec.maximum
  acts = lo + (hi - lo) * rng.uniform(-0.25, 1.25, (3, _B, len(lo)))
  states, resets = [], []
  for t in range(3):
    if t == 2:
      done = torch.zeros(_B, dtype=torch.bool)
      done[_RESET_ROW] = True
      state = benv._merge_resets(state, done, gen)
      resets.append(state)
    state, ts = benv.step(state, torch.as_tensor(acts[t]), gen)
    assert not bool(ts.last().any())  # no other row resets
    states.append(state)
  return dict(env=env, task=task, states=states, reset=resets[0],
              commands=np.clip(acts, lo, hi))


def test_wrapped_effector_state_per_row_matches_jax_vmap(run):
  jtask = jmanip.build_task('reorient', 'state_dense')
  jm = jtask.compile()
  jeff = _wrap(jtask.hand_effectors[0], jsmooth, jprev)
  init = jax.vmap(lambda _: jeff.initial_state(jm))(jnp.arange(_B))
  data = jax.tree_util.tree_map(
      lambda x: jnp.broadcast_to(x, (_B,) + x.shape), JT.make_data(jm))
  set_control = jax.jit(jax.vmap(
      lambda d, s, c: jeff.set_control(jm, d, s, c)))
  prefix = run['task'].hand_effectors[0].prefix
  state = init
  for t in range(3):
    if t == 2:
      state = jax.tree_util.tree_map(
          lambda x, y: x.at[_RESET_ROW].set(y[_RESET_ROW]), state, init)
      got = run['reset'].eff_state[prefix]
      for k, v in state.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-14, err_msg=k)
    jdata, state = set_control(data, state, jnp.asarray(run['commands'][t]))
    got = run['states'][t].eff_state[prefix]
    assert set(got) == {'smooth_prev', 'smooth_first', 'previous_action'}
    assert got['smooth_first'].shape == (_B,)
    assert got['smooth_prev'].shape == (_B, run['commands'].shape[-1])
    for k, v in state.items():
      np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0,
                                 atol=1e-14, err_msg=k)
    np.testing.assert_allclose(run['states'][t].data.ctrl.numpy(),
                               np.asarray(jdata.ctrl), rtol=0, atol=1e-14)


def test_reset_row_restarts_its_smoothing(run):
  """After the reset, row 1's first command passes through unsmoothed;
  the other rows go on smoothing from their own previous command."""
  prefix = run['task'].hand_effectors[0].prefix
  reset = run['reset'].eff_state[prefix]
  assert reset['smooth_first'].tolist() == [False, True, False]
  assert float(reset['smooth_prev'][_RESET_ROW].abs().max()) == 0.0
  assert float(reset['previous_action'][_RESET_ROW].abs().max()) == 0.0
  after = run['states'][2].eff_state[prefix]['smooth_prev'].numpy()
  before = run['states'][1].eff_state[prefix]['smooth_prev'].numpy()
  c = run['commands'][2]
  np.testing.assert_array_equal(after[_RESET_ROW], c[_RESET_ROW])
  for r in (0, 2):
    np.testing.assert_allclose(after[r],
                               _ALPHA * c[r] + (1 - _ALPHA) * before[r],
                               rtol=0, atol=1e-14)
    assert np.abs(after[r] - c[r]).max() > 1e-3


def test_effector_wrappers_delegate_and_validate(run):
  eff = run['task'].hand_effectors[0]
  assert isinstance(eff, pbase.Wrapper)
  inner = eff.wrapped.wrapped
  assert eff.prefix == inner.prefix and eff.hand is inner.hand
  one = eff.initial_state(run['env'].model)
  assert one['smooth_first'].shape == () and bool(one['smooth_first'])
  assert one['previous_action'].shape == (inner.action_spec(
      run['env'].model).shape[0],)
  for alpha in (0.0, 1.5):
    with pytest.raises(ValueError, match='alpha'):
      psmooth.SmoothAction(inner, alpha)


class _Recorder:
  """A stand-in environment that records the actions it is given."""

  def __init__(self, spec):
    self.spec, self.actions = spec, []

  def action_spec(self):
    return self.spec

  def step(self, action):
    self.actions.append(np.asarray(action))
    return len(self.actions)


def test_action_noise_matches_jax_with_one_seed(run, monkeypatch):
  """ActionNoise (seed 0, scale 0.05) over the port's
  InteractiveEnvironment gives the environment JAX's noisy actions."""
  env = run['env']
  seen, real = [], env.step

  def spy(state, action, gen=None):
    seen.append(np.asarray(action))
    return real(state, action, gen)

  monkeypatch.setattr(env, 'step', spy)
  spec = env.action_spec()
  noisy = pwrappers.ActionNoise(penv_lib.InteractiveEnvironment(env, seed=0),
                                scale=0.05, seed=0)
  assert noisy.action_spec() is spec and noisy.task is run['task']
  noisy.reset()
  rng = np.random.RandomState(1)
  acts = spec.minimum + (spec.maximum - spec.minimum) * rng.uniform(
      size=(2, spec.shape[0]))
  for a in acts:
    noisy.step(a)
  jrec = _Recorder(spec)
  jnoisy = jwrappers.ActionNoise(jrec, scale=0.05, seed=0)
  for a in acts:
    jnoisy.step(a)
  np.testing.assert_array_equal(np.stack(seen), np.stack(jrec.actions))
  assert np.abs(np.stack(seen) - acts).max() > 0


def test_checkpoint_roundtrip_and_layout(run, tmp_path):
  """save / load of a batched EnvState is bit-equal, each leaf on the
  like-state's device in its dtype; the files have the JAX package's
  layout, so each package loads the other's arrays."""
  state = run['states'][-1]
  path = str(tmp_path / 'state')
  pcheckpoint.save(path, state)
  like = structs.tree_map(torch.zeros_like, state)
  back = pcheckpoint.load(path + '.npz', like)
  leaves, got = structs.tree_leaves(state), structs.tree_leaves(back)
  assert len(leaves) == len(got) > 40
  for a, b in zip(leaves, got):
    assert a.dtype == b.dtype and a.device == b.device
    assert torch.equal(a, b)
  meta = json.load(open(path + '.treedef.json'))
  assert meta['num_leaves'] == len(leaves)
  with pytest.raises(ValueError, match='leaves'):
    pcheckpoint.load(path, {'one': torch.zeros(1)})

  tree = (torch.arange(6.0).reshape(2, 3), torch.tensor([True, False]))
  pcheckpoint.save(str(tmp_path / 'port'), tree)
  jback = jcheckpoint.load(str(tmp_path / 'port'),
                           tuple(jnp.asarray(x.numpy()) for x in tree))
  for a, b in zip(tree, jback):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
  jcheckpoint.save(str(tmp_path / 'jax'),
                   tuple(jnp.asarray(x.numpy()) for x in tree))
  back = pcheckpoint.load(str(tmp_path / 'jax'), tree)
  for a, b in zip(tree, back):
    assert torch.equal(a, b)


def test_assert_finite():
  tree = {'a': torch.zeros(2), 'n': torch.arange(3),
          'b': (torch.ones(1), torch.tensor([1.0, float('nan')]))}
  with pytest.raises(FloatingPointError, match='leaf 3'):
    pprofiling.assert_finite(tree)
  tree['b'] = (torch.ones(1), torch.ones(2))
  pprofiling.assert_finite(tree)


def test_device_trace_writes_the_annotated_region(tmp_path):
  with pprofiling.device_trace(str(tmp_path)):
    with pprofiling.trace_annotation('ik_region'):
      torch.ones(4).sum()
  trace = (tmp_path / 'trace.json').read_text()
  assert 'ik_region' in trace
