"""Name-for-name audit of the JAX package against its PyTorch port.

Reads both trees with `ast` and imports neither.  Every module of
dexterity_tpu/ has a module at the same path under dexterity_tpu_torch/
(`*_pallas.py` becoming `*_cuda.py`), and every public top-level name of a
JAX module is bound at the top level of its port counterpart.  A public
name is a function, a class or an assigned name (plain or annotated) not
starting with `_`, and, in a package's `__init__.py`, a name it imports
from the package itself.  `EXCEPTIONS` lists the names the port has no
counterpart for, each with its reason.  Every class that a JAX module and
its port both define has each public member of the JAX class (a method, a
class attribute or an annotated field, bound in the class body) in the
port's class, except `MEMBER_EXCEPTIONS`.  The audit runs one way: the
port's own extra modules, names and members are allowed.
"""

import ast
import functools
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
    ('utils/profiling.py', 'Throughput'):
        'read by no benchmark reader and no operator: the benchmark times '
        "its own windows, and an operator reads the port's spans",
}


# (JAX module, class, member) -> why the port's class has no such member.
MEMBER_EXCEPTIONS = {
    ('environment.py', 'EnvState', 'key'):
        'the port passes a torch.Generator to each call; its state carries '
        'no key',
    ('planners/predictive_sampling.py', 'PredictiveSamplingConfig',
     'rollout_unroll'):
        "an XLA scan-unroll factor; the port's rollouts are an eager loop",
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


@functools.lru_cache(maxsize=None)
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


def _classes(path):
  """The classes a module defines at its top level, by name."""
  return {node.name: node for node in _statements(_parse(path).body)
          if isinstance(node, ast.ClassDef)}


def _members(cls):
  """The public names a class body binds: methods, nested classes, class
  attributes and annotated fields."""
  return {n for n in _defined(cls) if not n.startswith('_')}


def _shared_classes():
  out = []
  for rel in _MODULES:
    path = _port_path(rel)
    if os.path.isfile(path):
      port = _classes(path)
      out += [(rel, name) for name in _classes(os.path.join(_JAX, rel))
              if name in port]
  return out


_SHARED_CLASSES = _shared_classes()


def test_the_shared_classes_are_read():
  assert len(_SHARED_CLASSES) > 90
  assert ('models/arenas.py', 'Arena') in _SHARED_CLASSES


@pytest.mark.parametrize('rel,cls', _SHARED_CLASSES)
def test_class_members_are_ported(rel, cls):
  """The port's class binds each public member of the JAX class."""
  excepted = {m for (mod, c, m) in MEMBER_EXCEPTIONS if (mod, c) == (rel, cls)}
  missing = (_members(_classes(os.path.join(_JAX, rel))[cls]) - excepted -
             _members(_classes(_port_path(rel))[cls]))
  assert not missing, f'{rel} {cls}: not in the port: {sorted(missing)}'


@pytest.mark.parametrize('rel,cls,member', sorted(MEMBER_EXCEPTIONS))
def test_member_exceptions_stay_true(rel, cls, member):
  """An excepted member is a public member of its JAX class and is absent
  from the port's class, so the list cannot go stale."""
  assert MEMBER_EXCEPTIONS[(rel, cls, member)]
  assert member in _members(_classes(os.path.join(_JAX, rel))[cls])
  assert member not in _members(_classes(_port_path(rel))[cls])
