"""The port's host rendering against the JAX package's renderer (on the CPU).

The JAX side stays cheap: its StateBridge and HostRenderer run on numpy
states (the port's own reset and step states), with no jitted JAX
environment.  Both render the same MuJoCo model through EGL, so pixels
are held bit-equal:

  * StateBridge: md.qpos (and the mocap rows and body frames) after
    copy_state of one state, bit-equal to JAX's;
  * HostRenderer: two cameras, batched and single, bit-equal to JAX's on
    the same state, for reach and reorient;
  * the vision presets (reach and reorient VISION_ONLY on the CPU at
    batch (2,)): each camera observation's shape, dtype and device, and
    its pixels equal to JAX's renderer on the port's own states;
  * with mujoco made unimportable, an enabled camera raises.
"""

import sys

import numpy as np
import pytest
import torch

from dexterity_tpu import manipulation as jmanip
from dexterity_tpu import rendering as jrendering
from dexterity_tpu.manipulation.shared import cameras as jcameras
from dexterity_tpu_torch import environment as penv
from dexterity_tpu_torch import rendering as prendering
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.manipulation.shared import cameras as pcameras
from dexterity_tpu_torch.manipulation.shared import observations as pobs
from dexterity_tpu_torch.manipulation.tasks import reach as preach
from dexterity_tpu_torch.manipulation.tasks import reorient as preorient

mujoco = pytest.importorskip('mujoco')

F64 = dict(device='cpu', dtype=torch.float64)
_CAMS = ('FRONT_CLOSE', 'LEFT_CLOSE')


def _vision_task(domain):
  vision = pobs.ObservationSet.VISION_ONLY
  if domain == 'reach':
    return preach.reach_task(observation_set=vision, use_dense_reward=True)
  return preorient.reorient_task(observation_set=vision)


@pytest.fixture(scope='module', params=['reach', 'reorient'])
def run(request):
  """The port's VISION_ONLY environment at batch (2,): reset and one
  step (seeded), and JAX's renderer for the same task."""
  domain = request.param
  task = _vision_task(domain)
  env = penv.GoalEnvironment(task, **F64)
  gen = torch.Generator().manual_seed(3)
  state, ts0 = env.reset(gen, (2,))
  spec = env.action_spec()
  act = np.random.RandomState(4).uniform(spec.minimum, spec.maximum,
                                         (2,) + spec.shape)
  state1, ts1 = env.step(state, act, gen)
  jtask = jmanip.build_task(domain, 'state_dense')
  jmodel = jtask.compile()
  jr = jrendering.HostRenderer(jtask.arena.spec, jmodel,
                               [getattr(jcameras, c) for c in _CAMS])
  yield dict(domain=domain, task=task, env=env, states=(state, state1),
             steps=(ts0, ts1), jtask=jtask, jmodel=jmodel, jr=jr)
  task._camera_obs._renderer.close()
  # JAX's renderer has no close: free its GL context on its thread.
  if jr._renderer is not None:
    jr._executor.submit(jr._renderer.close).result()
  jr._executor.shutdown()


def test_host_state_is_one_copy_of_qpos_and_mocap(run):
  data = run['states'][1].data
  qpos, mpos, mquat = prendering.host_state(data)
  np.testing.assert_array_equal(qpos, data.qpos.numpy())
  np.testing.assert_array_equal(mpos, data.mocap_pos.numpy())
  np.testing.assert_array_equal(mquat, data.mocap_quat.numpy())
  assert mpos.shape == (2, run['env'].model.nmocap, 3)
  one = data.replace(qpos=data.qpos[1], mocap_pos=data.mocap_pos[1],
                     mocap_quat=data.mocap_quat[1])
  q1, p1, r1 = prendering.host_state(one)
  np.testing.assert_array_equal(q1, qpos[1])
  assert p1.shape == mpos.shape[1:] and r1.shape == mquat.shape[1:]


def test_state_bridge_matches_jax(run):
  """md after copy_state of one state is JAX's, bit for bit."""
  env = run['env']
  qpos, mpos, mquat = prendering.host_state(run['states'][1].data)
  pb = prendering.StateBridge(run['task'].arena.spec, env.model)
  jb = jrendering.StateBridge(run['jtask'].arena.spec, run['jmodel'])
  assert pb.mm.nmesh == jb.mm.nmesh > 0
  pb.copy_state(qpos[0], mpos[0], mquat[0])
  jb.copy_state(qpos[0], mpos[0], mquat[0])
  for name in ('qpos', 'mocap_pos', 'mocap_quat', 'xpos', 'xquat',
               'geom_xpos'):
    np.testing.assert_array_equal(getattr(pb.md, name),
                                  getattr(jb.md, name), err_msg=name)
  assert not np.array_equal(pb.md.qpos, pb.mm.qpos0)
  np.testing.assert_array_equal(pb.scene_option().geomgroup,
                                jb.scene_option().geomgroup)


def test_host_renderer_pixels_match_jax(run):
  """Two cameras, batched and single, bit-equal to JAX's renderer."""
  configs = [getattr(pcameras, c) for c in _CAMS]
  pr = prendering.HostRenderer(run['task'].arena.spec, run['env'].model,
                               configs)
  try:
    for state in run['states']:
      host = prendering.host_state(state.data)
      got = pr.render_batch(*host)
      assert got.shape == (2, 2, 84, 84, 3) and got.dtype == np.uint8
      np.testing.assert_array_equal(got, run['jr'].render_batch(*host))
      assert got.max() > 0
      # Distinct cameras see distinct images.
      assert not np.array_equal(got[:, 0], got[:, 1])
    single = pr.render_batch(*(h[1] for h in host))
    np.testing.assert_array_equal(single, got[1])
  finally:
    pr.close()


def test_vision_observations_match_jax_renderer(run):
  """The VISION_ONLY camera observation at batch (2,) on the CPU: shape,
  dtype, device, and JAX's renderer's pixels on the port's states."""
  task = run['task']
  assert task._camera_obs.enabled
  assert task._camera_obs._renderer._mm.nmesh > 0
  for state, ts in zip(run['states'], run['steps']):
    img = ts.observation['front_close']
    assert tuple(img.shape) == (2, 84, 84, 3)
    assert img.dtype == torch.uint8 and img.device.type == 'cpu'
    want = run['jr'].render_batch(*prendering.host_state(state.data))
    np.testing.assert_array_equal(img.numpy(), want[:, 0])
  # The two steps' images differ: the observation follows the state.
  assert not torch.equal(run['steps'][0].observation['front_close'],
                         run['steps'][1].observation['front_close'])
  spec = run['env'].observation_spec()['front_close']
  assert spec.shape == (84, 84, 3) and spec.dtype == np.uint8


def test_reorient_vision_preset_has_camera_and_no_prop_pose():
  """Reorient's observables carry the camera branch (JAX
  tasks/reorient.py:164-165), in VISION_ONLY and ALL alike."""
  for obs_set in (pobs.ObservationSet.VISION_ONLY, pobs.ObservationSet.ALL):
    task = preorient.reorient_task(observation_set=obs_set)
    model = task.compile(**F64)
    calls = []

    def fake(model, data, calls=calls):
      calls.append(data.qpos.shape)
      return {'front_close': torch.zeros(data.qpos.shape[:-1] + (84, 84, 3),
                                         dtype=torch.uint8)}

    task._camera_obs.as_dict = fake
    data = PT.make_data(model, (3,))
    tstate = penv.TaskState(
        goal=data.qpos.new_zeros(3, 4), goal_distance=None, successes=None,
        success_change_counter=None, solve_start_time=None,
        exceeded_single_goal_time=None, success_registered=None,
        goal_changed=None, failure_termination=None, goal_ok=None)
    obs = task.observables(model, data, tstate, None)
    assert calls == [(3, model.nq)]
    assert obs['front_close'].shape == (3, 84, 84, 3)
    assert ('prop/position' in obs) == (obs_set == pobs.ObservationSet.ALL)


def test_enabled_camera_without_mujoco_raises(monkeypatch):
  """No fallback: no empty or zero pixels when mujoco cannot load."""
  task = _vision_task('reach')
  model = task.compile(**F64)
  monkeypatch.setitem(sys.modules, 'mujoco', None)
  with pytest.raises(ImportError):
    task._camera_obs.as_dict(model, PT.make_data(model, (2,)))
  with pytest.raises(ImportError):
    penv.GoalEnvironment(task, **F64).reset(torch.Generator(), (1,))
