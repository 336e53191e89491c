"""Name-for-name audit of the JAX package against its PyTorch port.

Reads both trees with `ast` and imports neither.  Every module of
dexterity_tpu/ has a module at the same path under dexterity_tpu_torch/
(`*_pallas.py` becoming `*_cuda.py`), and every public top-level name of a
JAX module is bound at the top level of its port counterpart.  A public
name is a function, a class or an assigned name (plain or annotated) not
starting with `_`, and, in a package's `__init__.py`, a name it imports
from the package itself.  `EXCEPTIONS` lists the names the port has no
counterpart for, each with its reason.  The audit runs one way: the port's
own extra modules and names are allowed.
"""

import ast
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX = os.path.join(_ROOT, 'dexterity_tpu')
_PORT = os.path.join(_ROOT, 'dexterity_tpu_torch')

# (JAX module, name) -> why the port has no counterpart.
EXCEPTIONS = {
    ('physics/constraint.py', 'DiagBlock'):
        'no caller in the JAX package',
    ('planners/distributed.py', 'shard_map'):
        "JAX's tracing workaround; torch.distributed needs none",
    ('utils/structs.py', 'pytree_dataclass'):
        'JAX pytree registration; the port uses frozen dataclasses',
    ('utils/structs.py', 'static_field'):
        'JAX pytree registration of a static field; the port has no pytrees',
}


def _jax_modules():
  out = []
  for base, _, files in os.walk(_JAX):
    out += [os.path.relpath(os.path.join(base, f), _JAX)
            for f in files if f.endswith('.py')]
  return sorted(out)


def _port_path(rel):
  if rel.endswith('_pallas.py'):
    rel = rel[:-len('_pallas.py')] + '_cuda.py'
  return os.path.join(_PORT, rel)


def _statements(body):
  """Top-level statements, with those inside top-level if / try / with
  blocks."""
  for node in body:
    if isinstance(node, (ast.If, ast.Try, ast.With)):
      for part in ('body', 'orelse', 'finalbody'):
        yield from _statements(getattr(node, part, []))
      for handler in getattr(node, 'handlers', []):
        yield from _statements(handler.body)
    else:
      yield node


def _defined(tree):
  """Names a module binds by def, class or assignment."""
  out = set()
  for node in _statements(tree.body):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
      out.add(node.name)
    elif isinstance(node, ast.Assign):
      for target in node.targets:
        out |= {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                        ast.Name):
      out.add(node.target.id)
  return out


def _imported(tree, package=None):
  """Names a module binds by import; with `package`, only those imported
  from that package or relatively."""
  out = set()
  for node in _statements(tree.body):
    if isinstance(node, ast.ImportFrom):
      mod = node.module or ''
      if package is None or node.level or mod.split('.')[0] == package:
        out |= {a.asname or a.name for a in node.names}
    elif isinstance(node, ast.Import) and package is None:
      out |= {(a.asname or a.name).split('.')[0] for a in node.names}
  return out


def _parse(path):
  with open(path) as f:
    return ast.parse(f.read(), path)


def _public_jax_names(rel):
  tree = _parse(os.path.join(_JAX, rel))
  names = _defined(tree)
  if os.path.basename(rel) == '__init__.py':
    names |= _imported(tree, 'dexterity_tpu')
  return {n for n in names if not n.startswith('_')}


def _port_names(rel):
  path = _port_path(rel)
  tree = _parse(path)
  return _defined(tree) | _imported(tree)


_MODULES = _jax_modules()


def test_the_jax_tree_is_read():
  assert len(_MODULES) > 50
  assert 'physics/linalg_pallas.py' in _MODULES


@pytest.mark.parametrize('rel', _MODULES)
def test_module_and_its_public_names_are_ported(rel):
  """The port has the module, and binds each of its public names."""
  assert os.path.isfile(_port_path(rel)), f'no port of {rel}'
  excepted = {name for (mod, name) in EXCEPTIONS if mod == rel}
  missing = _public_jax_names(rel) - excepted - _port_names(rel)
  assert not missing, f'{rel}: not in the port: {sorted(missing)}'


@pytest.mark.parametrize('rel,name', sorted(EXCEPTIONS))
def test_exceptions_stay_true(rel, name):
  """An excepted name is a public name of its JAX module and is absent
  from the port's module, so the list cannot go stale."""
  assert EXCEPTIONS[(rel, name)]
  assert name in _public_jax_names(rel)
  assert name not in _port_names(rel)
