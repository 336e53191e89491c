"""Import hygiene and device rules of the PyTorch port.

The port (dexterity_tpu_torch/ and chip_smoke.py) never imports jax or the
JAX package; its entry points place tensors on cuda unless the caller
names a device, and raise when there is no card.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
  # The spawned ranks' helper of tests/test_torch_distributed.py runs in
  # processes that must not load JAX.
  out = [os.path.join(_ROOT, 'chip_smoke.py'),
         os.path.join(_ROOT, 'tests', 'torch_dist_ranks.py')]
  for base, _, files in os.walk(os.path.join(_ROOT, 'dexterity_tpu_torch')):
    out += [os.path.join(base, f) for f in files if f.endswith('.py')]
  return sorted(out)


def _forbidden(name):
  top = name.split('.')[0]
  return top in ('jax', 'jaxlib', 'dexterity_tpu')


def test_port_files_exist():
  files = _port_files()
  assert os.path.exists(files[0])
  assert len(files) > 20


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_jax_or_jax_package_imports(path):
  tree = ast.parse(open(path).read(), path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        assert not _forbidden(alias.name), (path, alias.name)
    elif isinstance(node, ast.ImportFrom):
      assert node.level or not _forbidden(node.module or ''), (
          path, node.module)


def test_importing_the_port_loads_no_jax():
  """Imports every module of the port and then looks for jax."""
  code = ('import importlib, pkgutil, sys\n'
          'import dexterity_tpu_torch as pkg\n'
          'names = [m.name for m in pkgutil.walk_packages(\n'
          '    pkg.__path__, "dexterity_tpu_torch.")]\n'
          'for name in names:\n'
          '  importlib.import_module(name)\n'
          'for name in ("planners.predictive_sampling", "physics.tree_cuda",\n'
          '             "physics.cuda_build", "effectors.hand_effector",\n'
          '             "manipulation.goals.prop_orientation",\n'
          '             "manipulation.shared.rewards", "utils.specs", "goal",\n'
          '             "effector", "task", "environment", "envs.batched",\n'
          '             "models.observables", "utils.collisions",\n'
          '             "utils.metrics", "utils.structs", "hints",\n'
          '             "exception", "models.hands", "models.props",\n'
          '             "models.arenas", "manipulation.tasks.reach",\n'
          '             "manipulation.tasks.juggle",\n'
          '             "manipulation.goals.fingertip_position",\n'
          '             "physics.constraint", "planners.ilqr",\n'
          '             "planners.sqp", "controllers.mapper",\n'
          '             "controllers.dls.dls", "inverse_kinematics.ik_solver",\n'
          '             "effectors.wrappers.base",\n'
          '             "effectors.wrappers.previous_action",\n'
          '             "effectors.wrappers.smooth_action",\n'
          '             "manipulation.wrappers", "utils.checkpoint",\n'
          '             "utils.profiling", "parallel.sharding",\n'
          '             "planners.distributed", "mjcf.stl",\n'
          '             "mjcf.primitive_fit", "mjcf.parser", "mjcf.export",\n'
          '             "mjcf.prune"):\n'
          '  assert "dexterity_tpu_torch." + name in sys.modules, name\n'
          'bad = [m for m in sys.modules if m.split(".")[0] in '
          '("jax", "dexterity_tpu")]\n'
          'assert not bad, bad\n')
  env = dict(os.environ, PYTHONPATH=_ROOT)
  subprocess.run([sys.executable, '-c', code], check=True, cwd=_ROOT,
                 env=env, timeout=120)


def test_tf32_is_off():
  import dexterity_tpu_torch  # noqa: F401
  assert torch.backends.cuda.matmul.allow_tf32 is False
  assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_raise_without_a_card(monkeypatch):
  from dexterity_tpu_torch import environment, manipulation
  from dexterity_tpu_torch.core import types
  from dexterity_tpu_torch.planners import common
  from dexterity_tpu_torch.planners import predictive_sampling as ps
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  task = manipulation.build_task('reorient', 'state_dense')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    task.compile()
  with pytest.raises(RuntimeError, match='no CUDA device'):
    common.reduced_planning_model(task, 4, 6)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    ps.PredictiveSampling(task, ps.PredictiveSamplingConfig(horizon=2))
  with pytest.raises(RuntimeError, match='no CUDA device'):
    manipulation.load('reorient', 'state_dense')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    manipulation.load_interactive('reorient', 'state_dense')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    environment.GoalEnvironment(task)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    types.resolve_device(None)
  assert types.resolve_device('cpu') == torch.device('cpu')


@pytest.mark.parametrize('planner', ['ilqr', 'sqp'])
def test_gradient_planners_need_a_card_or_the_cpu(monkeypatch, planner):
  """Without a card, ILQR and SQP raise unless the caller asks for the
  CPU; with device='cpu' the planning model and the plan live there."""
  import importlib
  from dexterity_tpu_torch import manipulation
  mod = importlib.import_module(f'dexterity_tpu_torch.planners.{planner}')
  cls, cfg = ((mod.ILQR, mod.ILQRConfig) if planner == 'ilqr'
              else (mod.SQP, mod.SQPConfig))
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  task = manipulation.build_task('reach', 'state_dense')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    cls(task, cfg(horizon=2))
  p = cls(task, cfg(horizon=2), device='cpu')
  assert p.model.device == torch.device('cpu')
  assert p.init_state(streams=3).us.shape == (3, 2, p.nu)


@pytest.mark.parametrize('domain,task', [('reach', 'state_dense'),
                                         ('reach', 'state_sparse'),
                                         ('juggle', 'state_sparse')])
def test_reach_and_juggle_load_on_a_card_or_the_cpu(monkeypatch, domain,
                                                    task):
  """Without a card, load / load_interactive raise unless the caller asks
  for the CPU; with device='cpu' the model lives there."""
  from dexterity_tpu_torch import manipulation
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    manipulation.load(domain, task)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    manipulation.load_interactive(domain, task)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    manipulation.build_task(domain, task).compile()
  env = manipulation.load(domain, task, device='cpu')
  assert env.model.device == torch.device('cpu')
  assert env.model.dtype == torch.float32
