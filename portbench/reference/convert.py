"""The program's state handed to the reference: each dataclass of the
program rebuilt as the reference's class of the same module path and
name, its floating tensors cast to the reference's dtype.  The program's
classes are only read here, never imported."""

import dataclasses
import importlib

import torch

_PROGRAM = 'dexterity_tpu_torch'
_REFERENCE = 'reference.dex'


def _ref_class(cls):
  mod = cls.__module__
  if mod.startswith(_REFERENCE + '.'):
    return cls
  if not mod.startswith(_PROGRAM + '.'):
    raise TypeError(f'not a class of the program: {cls}')
  return getattr(importlib.import_module(_REFERENCE + mod[len(_PROGRAM):]),
                 cls.__name__)


def to_reference(tree, dtype, device=None):
  """`tree` (program dataclasses, dicts, lists, tensors) with the
  reference's classes and floating tensors in `dtype`."""
  if isinstance(tree, torch.Tensor):
    x = tree.detach()
    if device is not None:
      x = x.to(device)
    return x.to(dtype) if x.is_floating_point() else x.clone()
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    cls = _ref_class(type(tree))
    return cls(**{f.name: to_reference(getattr(tree, f.name), dtype, device)
                  for f in dataclasses.fields(tree) if f.init})
  if isinstance(tree, dict):
    return {k: to_reference(v, dtype, device) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(to_reference(v, dtype, device) for v in tree)
  return tree


def cast(x, dtype):
  """A program tensor as the reference reads it."""
  x = x.detach()
  return x.to(dtype) if x.is_floating_point() else x
