"""Checkpoint and resume (port of dexterity_tpu/utils/checkpoint.py).

Environment, planner and physics states are nests of tensors
(dataclasses, dicts, lists, tuples), so a checkpoint is an array dump:
`save` writes each tensor of `structs.tree_map`'s walk as `leaf_{i}` of
`<base>.npz`, and the leaf count to `<base>.treedef.json`, the JAX
package's layout.  `load` reads the leaves back into the structure of a
`like` state, each on `like`'s device in its dtype.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from dexterity_tpu_torch.utils import structs


def _npz_path(path: str) -> str:
  return path if path.endswith('.npz') else path + '.npz'


def _treedef_path(path: str) -> str:
  base = path[:-4] if path.endswith('.npz') else path
  return base + '.treedef.json'


def save(path: str, tree: Any) -> None:
  """Saves the tensors of `tree` to `<path>.npz` (+ `.treedef.json`)."""
  leaves = structs.tree_leaves(tree)
  arrays = {f'leaf_{i}': leaf.detach().cpu().numpy()
            for i, leaf in enumerate(leaves)}
  np.savez_compressed(_npz_path(path), **arrays)
  with open(_treedef_path(path), 'w') as f:
    json.dump({'treedef': type(tree).__name__, 'num_leaves': len(leaves)},
              f)


def load(path: str, like: Any) -> Any:
  """Loads a state saved by `save`, in the structure of `like`."""
  with np.load(_npz_path(path)) as npz:
    saved = len(npz.files)
    n = len(structs.tree_leaves(like))
    if saved != n:
      raise ValueError(f'{path} holds {saved} leaves; `like` has {n}')
    it = iter([npz[f'leaf_{i}'] for i in range(n)])
  return structs.tree_map(
      lambda x: torch.as_tensor(next(it)).to(device=x.device, dtype=x.dtype),
      like)
