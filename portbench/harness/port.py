"""Loading the program under test, the PyTorch/CUDA package beside the
benchmark's folder, and reading its launch counters."""

import importlib
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
PACKAGE = 'dexterity_tpu_torch'


class Missing(RuntimeError):
  """The checkout holds no program beside the benchmark."""


def load():
  """The program's modules by short name; raises Missing where the
  checkout does not hold the package."""
  if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
    raise Missing(f'no {PACKAGE}/ beside the benchmark in {ROOT}')
  if ROOT not in sys.path:
    sys.path.insert(1, ROOT)
  names = dict(
      package=PACKAGE, manipulation=f'{PACKAGE}.manipulation',
      batched=f'{PACKAGE}.envs.batched', environment=f'{PACKAGE}.environment',
      metrics=f'{PACKAGE}.utils.metrics', structs=f'{PACKAGE}.utils.structs',
      types=f'{PACKAGE}.core.types',
      ps=f'{PACKAGE}.planners.predictive_sampling',
      step=f'{PACKAGE}.physics.step',
      constraint=f'{PACKAGE}.physics.constraint',
      primitives=f'{PACKAGE}.physics.collision.primitives',
      linalg_cuda=f'{PACKAGE}.physics.linalg_cuda',
      tree_cuda=f'{PACKAGE}.physics.tree_cuda',
      cuda_build=f'{PACKAGE}.physics.cuda_build')
  return {k: importlib.import_module(v) for k, v in names.items()}


def build_kernels(pkg):
  """Builds (or loads from the checkout's build folder) every kernel
  library; returns the build record."""
  pkg['cuda_build'].build_all()
  info = pkg['cuda_build'].build_info
  return {'seconds': info.get('seconds'), 'built': info.get('built')}


def launches(pkg):
  """The program's launch counters, summed by name (read only)."""
  out = dict(pkg['linalg_cuda'].launches)
  out.update(pkg['tree_cuda'].launches)
  return out


def check_sizes(model, want, what):
  """Raises where the compiled model's sizes are not the configuration's."""
  got = {k: int(getattr(model, k)) for k in want}
  if got != want:
    raise RuntimeError(f'{what}: compiled sizes {got}, configuration {want}')
