"""The port's process-group sharding and sharded predictive sampling
against the JAX package.

JAX runs on the 8-device virtual CPU mesh of tests/conftest.py; the port
runs on the CPU in float64 on a gloo group of one rank (HashStore), and
of three spawned ranks (FileStore), where the candidate and rollout
batches do not divide and the padding runs.  Noise is injected into both
packages (JAX's threefry streams and torch's generators differ): each
`_sample_noise` call returns the next of two fixed draws.  Planner:
tests/test_multichip.py's `_reach_planner` (H = 4, N = 16, 2 knots, 2
iterations), G = 2 streams.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import torch_dist_ranks as R
from dexterity_tpu import manipulation as jmanip
from dexterity_tpu.core import types as JT
from dexterity_tpu.parallel import sharding as jsharding
from dexterity_tpu.planners import distributed as jdist
from dexterity_tpu.planners import predictive_sampling as jps
from dexterity_tpu_torch.core import types as PT
from dexterity_tpu_torch.parallel import sharding
from dexterity_tpu_torch.physics import step as pstep
from dexterity_tpu_torch.planners import distributed

_G = 2
_RANKS = 3           # G·N = 32 and N = 16 leave a remainder at 3 ranks


def _jdata(jm, fields, batch=True):
  if not batch:
    return JT.make_data(jm).replace(
        **{k: jnp.asarray(fields[k][0]) for k in R.STATE_FIELDS})
  b = fields['qpos'].shape[0]
  d = jax.tree_util.tree_map(
      lambda x: jnp.broadcast_to(x[None], (b,) + x.shape), JT.make_data(jm))
  return d.replace(**{k: jnp.asarray(fields[k]) for k in R.STATE_FIELDS})


def _case(pp):
  """Seeded reach states (joints in a band around qpos0, small
  velocities) on the planning model, fingertip goals a few cm from the
  fingertips, a perturbed nominal and two noise draws."""
  pm = pp.model
  rng = np.random.default_rng(17)
  qpos = np.repeat(pm.qpos0.numpy()[None], _G, 0)
  rngs = pm.jnt_range.numpy()
  for j in range(pm.njnt):
    if pm.jnt_limited[j]:
      lo, hi = rngs[j]
      qpos[:, pm.jnt_qposadr[j]] = lo + (hi - lo) * rng.uniform(0.3, 0.7, _G)
  fields = dict(qpos=qpos, qvel=0.1 * rng.normal(size=(_G, pm.nv)),
                qacc=np.zeros((_G, pm.nv)))
  d = pstep.forward(pm, R.port_data(pm, fields))
  gen = pp.task.goal_generator
  tips = gen.current_state(pm, d).numpy()
  goals = tips + 0.03 * rng.normal(size=tips.shape)
  nominal = pp.init_state(streams=_G).nominal.numpy()
  nominal = nominal + 0.05 * rng.normal(size=nominal.shape)
  noise = 0.3 * rng.normal(size=(2, R.CFG['num_samples'] - 1,
                                  R.CFG['horizon'], pp.nu))
  return dict(**{f'state_{k}': v for k, v in fields.items()}, goals=goals,
              nominal=nominal, noise=noise)


def _jax_solves(case):
  """JAX's sharded_solve (argmax and MPPI) on stream 0 and
  sharded_solve_batch on both streams, on the 8-device mesh, from the
  injected noise."""
  jtask = jmanip.build_task('reach', 'state_dense')
  mesh = jsharding.make_mesh()
  assert mesh.shape[jsharding.BATCH_AXIS] == 8
  fields = {k: case[f'state_{k}'] for k in R.STATE_FIELDS}
  out = {}
  for name in R.SOLVES:
    jp = jps.PredictiveSampling(jtask, jps.PredictiveSamplingConfig(
        **R.CFG, temperature=R.TEMPERATURE if name == 'mppi' else 0.0))
    calls = [0]

    def jnoise(key, n, calls=calls):
      # Traced once per CEM iteration; vmapped over the streams in the
      # batched form, where every stream gets the same draw.
      del key
      i = calls[0]
      calls[0] += 1
      return jnp.asarray(case['noise'][i % 2][:n])

    jp._sample_noise = jnoise
    with mesh:
      if name == 'batch':
        st = jps.PlannerState(nominal=jnp.asarray(case['nominal']),
                              best_return=jnp.full((_G,), -jnp.inf))
        a, new = jax.jit(lambda d, g, p, k: jdist.sharded_solve_batch(
            jp, mesh, d, g, p, k))(
                _jdata(jp.model, fields), jnp.asarray(case['goals']), st,
                jax.random.split(jax.random.PRNGKey(0), _G))
      else:
        st = jps.PlannerState(nominal=jnp.asarray(case['nominal'][0]),
                              best_return=jnp.asarray(-jnp.inf))
        a, new = jax.jit(lambda d, g, p, k: jdist.sharded_solve(
            jp, mesh, d, g, p, k))(
                _jdata(jp.model, fields, batch=False),
                jnp.asarray(case['goals'][0]), st, jax.random.PRNGKey(0))
    assert calls[0] >= R.CFG['iterations']
    out[f'{name}_action'] = np.asarray(a)
    out[f'{name}_nominal'] = np.asarray(new.nominal)
    out[f'{name}_best'] = np.asarray(new.best_return)
  return out


@pytest.fixture(scope='module')
def ref_path(tmp_path_factory):
  """JAX's sharded solves with their inputs, as an .npz the ranks load."""
  case = _case(R.planner())
  path = str(tmp_path_factory.mktemp('dist') / 'ref.npz')
  np.savez(path, **case, **_jax_solves(case))
  return path


@pytest.fixture(scope='module')
def world1():
  """A gloo group of one rank on a HashStore, and its mesh."""
  assert sharding.initialize_distributed(store=dist.HashStore(),
                                         num_processes=1, process_id=0,
                                         device='cpu')
  try:
    yield sharding.make_mesh()
  finally:
    dist.destroy_process_group()


def test_initialize_distributed_needs_a_configuration(monkeypatch):
  """Nothing configured: False, no group; configured with no card and no
  device: raises, like every entry point of the port."""
  for var in ('MASTER_ADDR', 'MASTER_PORT'):
    monkeypatch.delenv(var, raising=False)
  assert not dist.is_initialized()
  assert sharding.initialize_distributed() is False
  assert not dist.is_initialized()
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    sharding.initialize_distributed('localhost:29512', 1, 0)
  assert not dist.is_initialized()
  with pytest.raises(RuntimeError, match='initialize_distributed'):
    sharding.make_mesh()


def test_make_mesh_spans_the_process_group(world1):
  mesh = world1
  assert sharding.initialize_distributed() is True       # idempotent
  assert dist.get_backend() == 'gloo'
  assert mesh.size() == 1 and mesh.device_type == 'cpu'
  assert mesh.mesh_dim_names == (sharding.BATCH_AXIS,) == ('batch',)
  assert sharding.make_mesh(1).size() == 1
  with pytest.raises(ValueError, match='spans the process group'):
    sharding.make_mesh(2)
  assert sharding.batch_sharding(mesh) == (Shard(0),)
  assert sharding.replicated(mesh) == (Replicate(),)
  with pytest.raises(ValueError, match='no axis'):
    sharding.batch_sharding(mesh, 'model')


def test_shard_batch_and_replicate_values(world1):
  """JAX's test_shard_batch_places_leading_axis on a tree: the whole
  batch comes back, and at one rank the local slice is all of it."""
  mesh = world1
  x = torch.arange(16.0, dtype=torch.float64).reshape(8, 2)
  tree = {'x': x, 'pair': (x[:, 0], torch.arange(8))}
  xs = sharding.shard_batch(mesh, tree)
  for got, want in ((xs['x'], x), (xs['pair'][0], x[:, 0]),
                    (xs['pair'][1], torch.arange(8))):
    assert got.placements == (Shard(0),)
    assert torch.equal(got.full_tensor(), want)
    assert torch.equal(got.to_local(), want)
  rep = sharding.replicate(mesh, tree)
  assert rep['x'].placements == (Replicate(),)
  assert torch.equal(rep['x'].to_local(), x)
  with pytest.raises(ValueError, match='does not divide'):
    sharding.shard_batch(mesh, torch.tensor(1.0))


def test_sharded_adroit_step_matches_unsharded(world1):
  """JAX's test_sharded_physics_step: a batch of Adroit steps run on each
  rank's slice and gathered equals the unsharded step, and JAX's."""
  from dexterity_tpu.models import hands as jhands
  from dexterity_tpu.physics import step as jstep
  from dexterity_tpu_torch.models import hands as phands
  from dexterity_tpu_torch.utils import structs
  mesh = world1
  batch = 8
  qpos = np.random.RandomState(0).uniform(-0.1, 0.3, (batch, 24))
  pm = phands.AdroitHand().spec.compile(device='cpu', dtype=torch.float64)
  datas = PT.make_data(pm, (batch,)).replace(qpos=torch.as_tensor(qpos))
  local = pstep.step(pm, datas)
  sharded = sharding.shard_batch(mesh, datas)
  stepped = pstep.step(pm, structs.tree_map(lambda x: x.to_local(),
                                            sharded))
  gathered = structs.tree_map(
      lambda x: distributed.gather_rows(x, mesh.get_group())[0], stepped)
  assert torch.equal(gathered.qpos, local.qpos)
  assert torch.equal(gathered.qvel, local.qvel)
  jm = jhands.AdroitHand().spec.compile()
  jd = JT.make_data(jm)
  jdatas = jax.vmap(lambda q: jd.replace(qpos=q))(jnp.asarray(qpos))
  want = jax.jit(jax.vmap(lambda d: jstep.step(jm, d)))(jdatas)
  np.testing.assert_allclose(gathered.qpos.numpy(), np.asarray(want.qpos),
                             atol=1e-12)


@pytest.mark.parametrize('name', R.SOLVES)
def test_sharded_solves_match_jax_at_one_rank(world1, ref_path, name):
  """sharded_solve (argmax, MPPI) and sharded_solve_batch at one rank
  against JAX's on 8 devices, and bit-equal to the port's own solve /
  solve_batch from the same noise."""
  ref = dict(np.load(ref_path))
  out = R.solve(world1, ref, name)
  R.check(name, out, ref)
  for got, want in zip(out, R.solve(None, ref, name)):
    assert torch.equal(got, want)


def test_three_gloo_ranks_match_jax(ref_path, tmp_path):
  """Three spawned gloo ranks (FileStore, one thread each): the sharding
  API on each rank's slice, the three sharded solves with padding held
  to JAX's arrays on every rank, and a generator that differs on rank 1
  refused on every rank."""
  import torch.multiprocessing as mp
  ctx = mp.start_processes(
      R.run_rank, args=(_RANKS, str(tmp_path / 'store'), ref_path),
      nprocs=_RANKS, join=False, start_method='spawn')
  deadline = time.monotonic() + 300
  try:
    while not ctx.join(timeout=5):
      assert time.monotonic() < deadline, 'the ranks did not finish'
  finally:
    for p in ctx.processes:
      if p.is_alive():
        p.kill()
  assert all(p.exitcode == 0 for p in ctx.processes)


def test_generator_digest():
  """16 bytes, equal for equal states, changed by a draw."""
  a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
  assert len(distributed._generator_digest(a)) == 16
  assert distributed._generator_digest(a) == distributed._generator_digest(b)
  torch.randn(2, generator=b)
  assert distributed._generator_digest(a) != distributed._generator_digest(b)
