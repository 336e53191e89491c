"""The frozen reference agrees with the program's plain path on the CPU
in float64, so that the copy is known to be faithful the day it is
frozen."""

import dataclasses
import os
import sys

import pytest
import torch
from conftest import BENCH

from reference import convert, planning, stepping
from reference.dex.utils import structs as ref_structs

ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
  sys.path.insert(1, ROOT)

from dexterity_tpu_torch import manipulation  # noqa: E402
from dexterity_tpu_torch.envs import batched  # noqa: E402
from dexterity_tpu_torch.planners import predictive_sampling as ps  # noqa: E402
from dexterity_tpu_torch.utils import metrics  # noqa: E402

F64 = torch.float64


def _leaves(tree):
  out = []
  ref_structs.tree_map(lambda x: out.append(x) or x,
                       convert.to_reference(tree, F64))
  return out


def _same(a, b):
  la, lb = _leaves(a), _leaves(b)
  assert len(la) == len(lb)
  for x, y in zip(la, lb):
    assert x.shape == y.shape
    assert torch.equal(x.double() if x.is_floating_point() else x,
                       y.double() if y.is_floating_point() else y)


@pytest.mark.parametrize('config', ['shadowhand_reorient', 'mpl_juggle'])
def test_environment_reset_and_step_agree(config):
  import json
  with open(os.path.join(BENCH, 'configs', config + '.json')) as f:
    cfg = json.load(f)
  env = manipulation.load(cfg['task'], cfg['variant'], device='cpu',
                          dtype=F64)
  benv = batched.BatchedEnvironment(env, 2)
  _, ref_benv = stepping.build(cfg, 2, 'cpu', F64)
  state, ts = benv.reset(torch.Generator().manual_seed(3))
  ref_state, ref_ts = ref_benv.reset(torch.Generator().manual_seed(3))
  _same(state, ref_state)
  spec = env.action_spec()
  u = torch.rand(2, spec.shape[0], generator=torch.Generator().manual_seed(4),
                 dtype=F64)
  acts = torch.as_tensor(spec.minimum) + (
      torch.as_tensor(spec.maximum) - torch.as_tensor(spec.minimum)) * u
  m = metrics.init(2, dtype=F64, device='cpu')
  gen = torch.Generator().manual_seed(5)
  gen_state = gen.get_state()
  out = benv.step_with_metrics(state, acts, m, gen)
  ref = stepping.step_call(ref_benv, convert.to_reference(state, F64), acts,
                           gen_state, convert.to_reference(m, F64),
                           out[1].step_type == stepping.LAST)
  for a, b in zip(out, ref):
    _same(a, b)
  nums = stepping.compare(out, ref, stepping.LAST)
  assert all(v == 0.0 for v in nums.values()), nums


def test_planner_call_agrees():
  import json
  with open(os.path.join(BENCH, 'configs', 'shadowhand_reorient.json')) as f:
    cfg = json.load(f)
  with open(os.path.join(BENCH, 'traffic', 'mpc.s32.json')) as f:
    traffic = dict(json.load(f), streams=2, samples=4, horizon=2)
  ref_env, ref_planner = planning.build(cfg, traffic, 'cpu', F64)
  rcfg = ref_planner.config
  task = manipulation.build_task(cfg['task'], cfg['variant'])
  planner = ps.PredictiveSampling(task, ps.PredictiveSamplingConfig(**{
      f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}),
      device='cpu', dtype=F64)
  env = manipulation.load(cfg['task'], cfg['variant'], device='cpu',
                          dtype=F64)
  state, _ = env.reset(torch.Generator().manual_seed(6), (2,))
  gen = torch.Generator().manual_seed(7)
  gen_state = gen.get_state()
  captured = []
  orig = planner.rollout_returns_flat
  planner.rollout_returns_flat = lambda *a: captured.append(
      (a[2], orig(*a))) or captured[-1][1]
  pst = planner.init_state(streams=2)
  actions, out = planner.solve_batch(state.data, state.task.goal, pst, gen)
  prog = {'cands': [a.reshape(2, 4, 2, -1) for a, _ in captured],
          'returns': [r.reshape(2, -1) for _, r in captured],
          'actions': actions, 'nominal': out.nominal}
  ref = planning.solve_call(ref_planner,
                            convert.to_reference(state.data, F64),
                            state.task.goal, pst.nominal, gen_state, F64)
  for k in ('actions', 'nominal'):
    assert torch.equal(prog[k], ref[k])
  for a, b in zip(prog['returns'], ref['returns']):
    assert torch.equal(a, b)
  assert all(v == 0.0 for v in planning.compare(prog, ref).values())
