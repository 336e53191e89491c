"""Process-group sharding helpers (port of dexterity_tpu/parallel/sharding.py).

The dexterity domain's parallelism is data-parallel batching: environment
batches and MPC rollout populations split over the mesh's 'batch' axis.
The port runs one process per device on `torch.distributed`: NCCL between
cards, gloo on the CPU.  Where JAX places a pytree with a `NamedSharding`,
the port distributes each tensor as a DTensor with the matching placement
(`Shard(0)` for the batch axis, `Replicate()` for a replicated value).

A multi-card world is started with `torchrun --nproc-per-node N`, whose
environment variables `initialize_distributed` reads.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from dexterity_tpu_torch.core import types
from dexterity_tpu_torch.utils import structs

BATCH_AXIS = 'batch'


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None,
                           store: Optional[dist.Store] = None) -> bool:
  """Joins the default process group for multi-process meshes.

  Arguments default to torchrun's environment (MASTER_ADDR and
  MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).  `coordinator_address` is
  `host:port` or an init URL (`tcp://...`, `file://...`); `store` is an
  existing `torch.distributed.Store` used instead of an address.  Safe to
  call in single-process runs: returns False without initializing when
  neither an address nor a store is configured, True once the group is up
  (idempotent).

  The backend follows the device: NCCL for `cuda` (the default, which
  raises when there is no card), gloo for `device='cpu'`.  On cuda the
  process's current device is LOCAL_RANK (0 when unset).
  """
  if dist.is_initialized():
    return True
  env = os.environ
  address = coordinator_address
  if address is None and 'MASTER_ADDR' in env and 'MASTER_PORT' in env:
    address = f'{env["MASTER_ADDR"]}:{env["MASTER_PORT"]}'
  if address is None and store is None:
    return False
  n_proc = num_processes if num_processes is not None else int(
      env.get('WORLD_SIZE', 1))
  rank = process_id if process_id is not None else int(env.get('RANK', 0))
  device = types.resolve_device(device)
  if device.type == 'cuda':
    torch.cuda.set_device(int(env.get('LOCAL_RANK', 0)))
    backend = 'nccl'
  else:
    backend = 'gloo'
  if store is not None:
    dist.init_process_group(backend, store=store, world_size=n_proc,
                            rank=rank)
  else:
    url = address if '://' in address else f'tcp://{address}'
    dist.init_process_group(backend, init_method=url, world_size=n_proc,
                            rank=rank)
  return True


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = BATCH_AXIS) -> DeviceMesh:
  """A one-axis mesh over every process of the default group.

  A torch mesh spans its process group, so `n_devices` (JAX's count of
  devices to take) must be None or the world size; any other value
  raises ValueError.  The mesh's device type follows the group's
  backend: cuda under NCCL, cpu under gloo."""
  if not dist.is_initialized():
    raise RuntimeError('no process group: call initialize_distributed '
                       'first')
  world = dist.get_world_size()
  if n_devices is not None and n_devices != world:
    raise ValueError(f'a mesh spans the process group: n_devices must be '
                     f'{world}, got {n_devices}')
  device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
  return init_device_mesh(device_type, (world,),
                          mesh_dim_names=(axis_name,))


def batch_sharding(mesh: DeviceMesh, axis_name: str = BATCH_AXIS):
  """Placements that split the leading (batch) axis across the mesh."""
  if axis_name not in (mesh.mesh_dim_names or ()):
    raise ValueError(f'mesh has no axis {axis_name!r}')
  return (Shard(0),)


def replicated(mesh: DeviceMesh):
  del mesh
  return (Replicate(),)


def shard_batch(mesh: DeviceMesh, tree, axis_name: str = BATCH_AXIS):
  """Distributes every tensor of `tree` with its leading axis split over
  the mesh: each rank holds a contiguous slice (`to_local()`), and
  `full_tensor()` gives the whole.  A leading axis that the mesh does not
  divide raises ValueError, as JAX's device_put does."""
  placements = batch_sharding(mesh, axis_name)
  n = mesh.size()

  def put(x):
    if x.dim() == 0 or x.shape[0] % n:
      raise ValueError(f'leading axis of shape {tuple(x.shape)} does not '
                       f'divide over {n} devices')
    return distribute_tensor(x, mesh, placements)

  return structs.tree_map(put, tree)


def replicate(mesh: DeviceMesh, tree):
  placements = replicated(mesh)
  return structs.tree_map(lambda x: distribute_tensor(x, mesh, placements),
                          tree)
