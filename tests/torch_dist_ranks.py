"""Rank side of the port's multi-process sharding tests
(tests/test_torch_distributed.py).

Each spawned rank joins a gloo group through a FileStore, rebuilds the
small reach planner of the test on the CPU in float64, and holds the
port's sharded solves to JAX's arrays, which the parent computed and
passed in an .npz.  This module imports neither jax nor the JAX package,
so a spawned rank never loads JAX (see tests/conftest.py on the TPU
plugin).
"""

import numpy as np
import torch

F64 = dict(device='cpu', dtype=torch.float64)
# The planner of tests/test_multichip.py's _reach_planner: H = 4, N = 16,
# 2 knots, 2 CEM iterations.
CFG = dict(horizon=4, num_samples=16, num_knots=2, iterations=2,
           noise_decay=0.5)
TEMPERATURE = 0.5
STATE_FIELDS = ('qpos', 'qvel', 'qacc')
# Argmax actions and nominal: the same candidate is chosen on both sides,
# so they agree to rounding.  Returns through 4 control steps of contact
# physics agree to ~1e-9 relative (measured 1.0e-9).  MPPI's plan is the
# softmax-weighted average of the candidates, a smooth function of the
# returns: it moves with them, by the return error over T·spread times
# the candidates' spread, the same relative order (measured 1.0e-9).
ACT_TOL = 1e-12
RET_RTOL = 1e-8
MPPI_RTOL, MPPI_ATOL = 1e-8, 1e-10


def planner(temperature=0.0):
  from dexterity_tpu_torch import manipulation
  from dexterity_tpu_torch.planners import predictive_sampling as ps
  task = manipulation.build_task('reach', 'state_dense')
  return ps.PredictiveSampling(
      task, ps.PredictiveSamplingConfig(**CFG, temperature=temperature),
      **F64)


def port_data(pm, fields, batch=True):
  """A port Data carrying the state fields: all rows, or (batch=False)
  row 0 without a batch axis."""
  from dexterity_tpu_torch.core import types
  if not batch:
    return types.make_data(pm).replace(
        **{k: torch.as_tensor(fields[k][0]) for k in STATE_FIELDS})
  return types.make_data(pm, (fields['qpos'].shape[0],)).replace(
      **{k: torch.as_tensor(fields[k]) for k in STATE_FIELDS})


def inject(pp, noise, calls):
  """Makes `pp._sample_noise` return the i-th injected draw on its i-th
  call, tiled over the streams of a batched call."""

  def noise_fn(gen, n):
    del gen
    i = calls[0]
    calls[0] += 1
    z = noise[i]
    return torch.as_tensor(np.tile(z, (n // z.shape[0], 1, 1)))

  pp._sample_noise = noise_fn


SOLVES = ('argmax', 'mppi', 'batch')


def solve(mesh, ref, name):
  """One of the test's solves from the injected noise: 'argmax' and
  'mppi' are sharded_solve on stream 0, 'batch' is sharded_solve_batch on
  every stream; with mesh None, the planner's own solve / solve_batch.
  Returns (action, nominal, best return)."""
  from dexterity_tpu_torch.planners import distributed
  from dexterity_tpu_torch.planners import predictive_sampling as ps
  fields = {k: ref[f'state_{k}'] for k in STATE_FIELDS}
  pp = planner(TEMPERATURE if name == 'mppi' else 0.0)
  calls = [0]
  inject(pp, ref['noise'], calls)
  gen = torch.Generator().manual_seed(0)
  if name == 'batch':
    g = ref['goals'].shape[0]
    pst = ps.PlannerState(nominal=torch.as_tensor(ref['nominal']),
                          best_return=torch.full((g,), -np.inf,
                                                 dtype=torch.float64))
    args = (port_data(pp.model, fields), torch.as_tensor(ref['goals']), pst,
            gen)
    action, new = (pp.solve_batch(*args) if mesh is None else
                   distributed.sharded_solve_batch(pp, mesh, *args))
  else:
    pst = ps.PlannerState(nominal=torch.as_tensor(ref['nominal'][0]),
                          best_return=torch.tensor(-np.inf,
                                                   dtype=torch.float64))
    args = (port_data(pp.model, fields, batch=False),
            torch.as_tensor(ref['goals'][0]), pst, gen)
    action, new = (pp.solve(*args) if mesh is None else
                   distributed.sharded_solve(pp, mesh, *args))
  assert calls[0] == CFG['iterations'], calls
  return action, new.nominal, new.best_return


def check(name, out, ref):
  action, nominal, best = out
  tol = (dict(rtol=MPPI_RTOL, atol=MPPI_ATOL) if name == 'mppi'
         else dict(rtol=ACT_TOL, atol=ACT_TOL))
  np.testing.assert_allclose(action.numpy(), ref[f'{name}_action'], **tol,
                             err_msg=name)
  np.testing.assert_allclose(nominal.numpy(), ref[f'{name}_nominal'], **tol,
                             err_msg=name)
  np.testing.assert_allclose(best.numpy(), ref[f'{name}_best'],
                             rtol=RET_RTOL, err_msg=name)


def run_rank(rank, world, store_path, ref_path):
  """One rank of the spawned world: the sharding API on its slice, the
  sharded solves against JAX's arrays, then a generator that differs on
  one rank, which every rank must refuse."""
  import torch.distributed as dist

  from dexterity_tpu_torch.parallel import sharding
  from dexterity_tpu_torch.planners import distributed
  torch.set_num_threads(1)
  assert sharding.initialize_distributed(f'file://{store_path}', world, rank,
                                         device='cpu')
  try:
    mesh = sharding.make_mesh()
    assert mesh.size() == world
    x = torch.arange(world * 4.0).reshape(world * 2, 2)
    xs = sharding.shard_batch(mesh, {'x': x})['x']
    assert torch.equal(xs.to_local(), x[2 * rank:2 * rank + 2])
    assert torch.equal(xs.full_tensor(), x)
    assert torch.equal(sharding.replicate(mesh, x).to_local(), x)
    try:
      sharding.shard_batch(mesh, x[:world + 1])
      raise AssertionError('an indivisible leading axis was sharded')
    except ValueError:
      pass

    ref = dict(np.load(ref_path))
    for name in SOLVES:
      check(name, solve(mesh, ref, name), ref)

    pp = planner()
    data = port_data(pp.model, {k: ref[f'state_{k}'] for k in STATE_FIELDS},
                     batch=False)
    try:
      distributed.sharded_solve(
          pp, mesh, data, torch.as_tensor(ref['goals'][0]),
          pp.init_state(), torch.Generator().manual_seed(int(rank == 1)))
      raise AssertionError('a rank with another generator state was not '
                           'refused')
    except RuntimeError as e:
      assert 'generator state differs' in str(e), e
  finally:
    dist.destroy_process_group()
