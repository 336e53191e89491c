"""Frozen dataclasses and row selection over nested state (the port's
counterpart of dexterity_tpu/utils/structs.py).

The port needs no pytree registration: `dataclass` makes a frozen
dataclass with `replace`.  Environment states nest dataclasses, dicts
and tuples of tensors that share the leading batch shape; `tree_map`
walks them, and the row helpers select whole environments:
`where_rows(mask, a, b)` takes each row from `a` where the (batch,) mask
holds and from `b` elsewhere, as `jnp.where` over `tree_map` does in the
JAX package (envs/batched.py, scripts/eval_closed_loop_batch.py);
`take_rows` / `put_rows` gather the masked rows and scatter them back.
Leaves that are not tensors pass through from the first tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def dataclass(cls):
  """Decorator: frozen dataclass with a `replace(**updates)` method."""
  cls = dataclasses.dataclass(frozen=True)(cls)

  def replace(self, **updates):
    return dataclasses.replace(self, **updates)

  cls.replace = replace
  return cls


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
  """fn over the tensors of `tree` (and the matching leaves of `rest`),
  through dataclasses, dicts, lists and tuples."""
  if isinstance(tree, torch.Tensor):
    return fn(tree, *rest)
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return dataclasses.replace(tree, **{
        f.name: tree_map(fn, getattr(tree, f.name),
                         *(getattr(r, f.name) for r in rest))
        for f in dataclasses.fields(tree) if f.init})
  if isinstance(tree, dict):
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                      for i, v in enumerate(tree))
  return tree


def tree_leaves(tree: Any) -> list:
  """The tensors of `tree` in `tree_map`'s order."""
  out = []
  tree_map(lambda x: out.append(x) or x, tree)
  return out


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def where_rows(mask: torch.Tensor, a: Any, b: Any) -> Any:
  """Row-wise select: each environment's state from `a` where `mask`
  (the batch shape, bool) holds, else from `b`."""
  return tree_map(lambda x, y: torch.where(_rows(mask, x), x, y), a, b)


def take_rows(mask: torch.Tensor, tree: Any) -> Any:
  """The environments where `mask` holds, stacked on one leading axis."""
  return tree_map(lambda x: x[mask], tree)


def put_rows(mask: torch.Tensor, base: Any, rows: Any) -> Any:
  """`base` with the environments where `mask` holds replaced by `rows`
  (as `take_rows` gives them)."""
  def put(x, r):
    out = x.clone()
    out[mask] = r.to(x.dtype)
    return out
  return tree_map(put, base, rows)
