"""Render-only mesh assets for the vendored hand models (port of
dexterity_tpu/models/meshes.py).

Physics never loads mesh files: collision runs on fitted primitives
(mjcf/primitive_fit.py).  The reference renders the vendor STL meshes in
its camera observables (reference models/hands/shadow_hand_e.py:24), so
pixel observations show them too.  The port keeps its own copy of the
STL files under models/assets/meshes/ and of mesh_registry.json; this
module joins a hand ModelSpec's geom mesh provenance with that registry,
namespacing mesh names per model asset so that two hands (MPL left and
right, which share mesh names) can coexist in one arena.
"""

from __future__ import annotations

import functools
import json
import os

from reference.dex.core import spec as S

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'assets')


@functools.lru_cache(maxsize=1)
def registry() -> dict:
  path = os.path.join(_ASSETS, 'mesh_registry.json')
  if not os.path.exists(path):
    return {}
  with open(path) as f:
    return json.load(f)


def asset_path(rel_or_abs: str) -> str:
  if os.path.isabs(rel_or_abs):
    return rel_or_abs
  return os.path.join(_ASSETS, rel_or_abs)


def attach_mesh_assets(spec: S.ModelSpec, model_key: str) -> None:
  """Joins `spec`'s geom mesh provenance with the packaged registry.

  For every geom whose `mesh` provenance resolves under
  '<model_key>/<name>' in mesh_registry.json, rewrites the provenance to
  the namespaced name and records a MeshSpec in spec.meshes.  Missing
  registry entries (or a missing registry) leave the spec unchanged;
  rendering then shows the fitted primitives.  No Model field depends on
  either, so the compiled model is the same with or without the join.
  """
  reg = registry()
  if not reg:
    return
  for body in spec.worldbody.walk():
    for g in body.geoms:
      if not g.mesh or '/' in g.mesh:
        continue
      key = f'{model_key}/{g.mesh}'
      ent = reg.get(key)
      if ent is None:
        continue
      g.mesh = key
      if key not in spec.meshes:
        spec.meshes[key] = S.MeshSpec(
            name=key, file=ent['file'], scale=tuple(ent['scale']),
            emit_on_body=bool(ent.get('emit_on_body', False)),
            pos=tuple(ent.get('pos', (0.0, 0.0, 0.0))),
            quat=tuple(ent.get('quat', (1.0, 0.0, 0.0, 0.0))))
