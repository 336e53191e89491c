"""The port's explorer CLI (manipulation/explore.py) against the JAX
package's (on the CPU).

--export writes JAX's export_mjcf text; the listing and the stdin choice
work; the random-policy rollout runs with --device cpu; run_interactive
drives a stub viewer for two control steps with JAX's action rule
(`uniform(lo, hi) * (action_noise or 1.0)`), and exits with its message
where no viewer window opens.
"""

import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.mjcf import export as jexport
from dexterity_tpu_torch import environment as penv
from dexterity_tpu_torch import manipulation as pmanip
from dexterity_tpu_torch.manipulation import explore

mujoco = pytest.importorskip('mujoco')
import mujoco.viewer  # noqa: E402  (the stub replaces launch_passive)


@pytest.mark.parametrize('name,by_stdin', [('reach.state_dense', True),
                                           ('reorient.state_dense', False)])
def test_export_matches_jax(tmp_path, monkeypatch, capsys, name, by_stdin):
  out = tmp_path / 'task.xml'
  argv = ['--export', str(out)]
  if by_stdin:
    idx = pmanip.ALL_NAMES.index(name)
    monkeypatch.setattr('builtins.input', lambda prompt: f' {idx}\n')
  else:
    argv += ['--environment_name', name]
  explore.main(argv)
  printed = capsys.readouterr().out
  assert ('Available environments:' in printed) == by_stdin
  if by_stdin:
    for i, n in enumerate(pmanip.ALL_NAMES):
      assert f'  [{i}] {n}' in printed
  assert f'exported {name} to {out}' in printed
  jtask = jmanip.build_task(*name.split('.'))
  assert out.read_text() == jexport.export_mjcf(jtask.arena.spec)


def test_listing_choice_by_name(tmp_path, monkeypatch, capsys):
  monkeypatch.setattr('builtins.input', lambda prompt: 'juggle.state_sparse')
  explore.main(['--export', str(tmp_path / 'j.xml')])
  assert 'exported juggle.state_sparse' in capsys.readouterr().out
  assert pmanip.ALL_NAMES == jmanip.ALL_NAMES


@pytest.mark.parametrize('noise', [0.0, 0.1])
def test_random_policy_rollout_on_cpu(capsys, noise):
  explore.main(['--environment_name', 'reach.state_dense', '--steps', '2',
                '--device', 'cpu', '--seed', '1',
                '--action_noise', str(noise)])
  printed = capsys.readouterr().out
  assert 'observation shapes:' in printed
  assert 'adroit_hand/joint_positions_sin_cos: (48,)' in printed
  assert 'step 0: reward=' in printed and 'step 1: reward=' in printed
  assert 'step 2:' not in printed


class _StubViewer:
  """What launch_passive returns: a context manager with opt, sync and
  is_running."""

  def __init__(self, mm, md):
    self.mm, self.md = mm, md
    self.opt = mujoco.MjvOption()
    self.opt.geomgroup[:] = 0
    self.syncs = []

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    return False

  def is_running(self):
    return True

  def sync(self):
    self.syncs.append(self.md.qpos.copy())


def test_run_interactive_drives_a_stub_viewer(monkeypatch):
  viewers, actions = [], []
  real_step = penv.GoalEnvironment.step

  def recording_step(self, state, action, gen=None):
    actions.append(np.array(action))
    return real_step(self, state, action, gen)

  def launch(mm, md):
    viewers.append(_StubViewer(mm, md))
    return viewers[-1]

  monkeypatch.setattr(penv.GoalEnvironment, 'step', recording_step)
  monkeypatch.setattr(mujoco.viewer, 'launch_passive', launch)
  explore.run_interactive('reach', 'state_dense', seed=5, action_noise=0.5,
                          max_steps=2, device='cpu')
  (v,) = viewers
  assert len(v.syncs) == 2 and len(actions) == 2
  np.testing.assert_array_equal(v.opt.geomgroup, [1, 1, 1, 0, 0, 0])
  assert v.mm.nmesh > 0
  # The state reached the bridge each control step, and moved.
  assert np.all(np.isfinite(v.syncs[1]))
  assert not np.array_equal(v.syncs[0], v.syncs[1])
  # JAX's action rule: uniform(lo, hi) scaled by action_noise.
  env = penv.GoalEnvironment(pmanip.build_task('reach', 'state_dense'),
                             device='cpu')
  aspec = env.action_spec()
  lo = np.where(np.isfinite(aspec.minimum), aspec.minimum, -1)
  hi = np.where(np.isfinite(aspec.maximum), aspec.maximum, 1)
  rng = np.random.RandomState(5)
  for got in actions:
    np.testing.assert_array_equal(got, rng.uniform(lo, hi) * 0.5)


def test_run_interactive_exits_on_a_headless_host(monkeypatch):
  def launch(mm, md):
    raise RuntimeError('no display')

  monkeypatch.setattr(mujoco.viewer, 'launch_passive', launch)
  with pytest.raises(SystemExit, match=r'could not open a viewer window '
                                       r'\(headless host\?\): no display'):
    explore.run_interactive('reach', 'state_dense', max_steps=1,
                            device='cpu')


def test_entry_points_run_on_cuda_unless_asked(monkeypatch):
  """With no device named, the environment goes to cuda, which fails
  here without a card (before any viewer opens); --device defaults to
  cuda."""
  if torch.cuda.is_available():
    pytest.skip('a card is present')
  monkeypatch.setattr(mujoco.viewer, 'launch_passive',
                      lambda mm, md: pytest.fail('viewer opened'))
  with pytest.raises(RuntimeError, match='no CUDA device'):
    explore.run_interactive('reach', 'state_dense', max_steps=1)
  with pytest.raises((RuntimeError, AssertionError), match='CUDA'):
    explore.main(['--environment_name', 'reach.state_dense', '--steps',
                  '1'])
