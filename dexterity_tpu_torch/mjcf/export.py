"""ModelSpec -> MJCF XML export (port of dexterity_tpu/mjcf/export.py).

Serves two purposes:
  * standalone-XML interchange, the parity feature for the reference's
    scripts/export_task.py:31-45 (a compiled task can be re-opened in any
    MuJoCo tool / viewer);
  * conformance testing — the exported model contains exactly the fitted
    primitives this framework simulates, so MuJoCo can be run on identical
    geometry to validate the constraint solver.

Export is a host tool that returns text: where it reads the compiled pair
tables it compiles on the CPU in float64, so no tensor reaches a card.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from dexterity_tpu_torch.core import spec as S
from dexterity_tpu_torch.core.types import (ActuatorTrn, BiasType, EqType,
                                            GeomType, JointType)
from dexterity_tpu_torch.models import meshes as mesh_assets

_GEOM_NAMES = {
    GeomType.PLANE: 'plane', GeomType.SPHERE: 'sphere',
    GeomType.CAPSULE: 'capsule', GeomType.ELLIPSOID: 'ellipsoid',
    GeomType.CYLINDER: 'cylinder', GeomType.BOX: 'box', GeomType.MESH: 'mesh',
}
_JOINT_NAMES = {JointType.FREE: 'free', JointType.BALL: 'ball',
                JointType.SLIDE: 'slide', JointType.HINGE: 'hinge'}


def _fmt(arr) -> str:
  return ' '.join(f'{float(x):.12g}' for x in np.atleast_1d(np.asarray(arr)))


def export_for_conformance(spec: S.ModelSpec) -> str:
  """Exports with the compiled candidate pair list as explicit <pair>s.

  All contype/conaffinity are zeroed so MuJoCo collides exactly the pairs
  this framework tests — byte-identical geometry and pair parameters for
  solver cross-validation.
  """
  import copy
  model = spec.compile(device='cpu', dtype=torch.float64)
  spec = copy.deepcopy(spec)
  geoms = {}
  for b in spec.worldbody.walk():
    for g in b.geoms:
      g.contype = 0
      g.conaffinity = 0
      # The narrow phase collides cylinders as extent-matched capsules
      # (collision_size); export that shape so both engines collide
      # byte-identical geometry.  Inertia is unaffected for bodies with
      # explicit <inertial> (all vendored hands).
      if g.type == GeomType.CYLINDER:
        g.type = GeomType.CAPSULE
        g.size = np.array([g.size[0], max(g.size[1] - g.size[0], 1e-6),
                           0.0])
      geoms[g.name] = g
  spec.pairs = []
  fr = model.pair_friction.numpy()
  sr = model.pair_solref.numpy()
  si = model.pair_solimp.numpy()
  mg = model.pair_margin.numpy()
  for i in range(model.npair):
    spec.pairs.append(S.PairSpec(
        geom1=model.geom_names[model.pair_geom1[i]],
        geom2=model.geom_names[model.pair_geom2[i]],
        condim=model.pair_condim[i], friction=tuple(fr[i]),
        solref=tuple(sr[i]), solimp=tuple(si[i]), margin=float(mg[i])))
  # keep_visual: geoms all have contype/conaffinity 0 here, but must still
  # exist for the explicit pair list to reference them.
  return export_mjcf(spec, keep_visual=True)


def export_mjcf(spec: S.ModelSpec, keep_visual: bool = False,
                include_meshes: bool = False) -> str:
  """Returns an MJCF XML string for the spec.

  include_meshes=False (default): mesh geoms dropped — the exported model
  contains exactly the fitted primitives physics simulates (conformance
  interchange).  include_meshes=True: visual mesh geoms are emitted with
  <asset><mesh> entries resolved through spec.meshes (models/meshes.py),
  dual-use provenance meshes (MPL) are re-emitted as visual-only geoms,
  and the collision primitives they replace move to geom group 4 so
  renderers can hide them (rendering.py shows groups 0-2 when meshes are
  present) — pixels then show the real vendor hand geometry the reference
  renders.
  """
  root = ET.Element('mujoco', model=spec.name)
  ET.SubElement(root, 'compiler', angle='radian', autolimits='true')
  ET.SubElement(root, 'option', timestep=f'{spec.option.timestep:.12g}',
                gravity=_fmt(spec.option.gravity))

  ctx = {'used': {}} if include_meshes else None
  world = ET.SubElement(root, 'worldbody')
  _export_body_children(world, spec.worldbody, keep_visual, spec, ctx)
  for child in spec.worldbody.children:
    _export_body(world, child, keep_visual, spec, ctx)

  if ctx and ctx['used']:
    asset = ET.SubElement(root, 'asset')
    for name, m in sorted(ctx['used'].items()):
      ET.SubElement(asset, 'mesh', name=name,
                    file=mesh_assets.asset_path(m.file),
                    scale=_fmt(m.scale))

  if spec.tendons:
    tend = ET.SubElement(root, 'tendon')
    for t in spec.tendons:
      attrs = dict(name=t.name)
      if t.limited:
        attrs['range'] = _fmt(t.range)
        attrs['limited'] = 'true'
      else:
        attrs['limited'] = 'false'
      f = ET.SubElement(tend, 'fixed', **attrs)
      for jname, coef in t.joints:
        ET.SubElement(f, 'joint', joint=jname, coef=f'{coef:.12g}')

  if spec.actuators:
    act = ET.SubElement(root, 'actuator')
    for a in spec.actuators:
      attrs = dict(name=a.name)
      if a.trntype == ActuatorTrn.JOINT:
        attrs['joint'] = a.target
      else:
        attrs['tendon'] = a.target
      attrs['gainprm'] = _fmt(a.gainprm)
      if a.biastype == BiasType.AFFINE:
        attrs['biastype'] = 'affine'
        attrs['biasprm'] = _fmt(a.biasprm)
      if np.all(np.isfinite(a.ctrlrange)):
        attrs['ctrlrange'] = _fmt(a.ctrlrange)
        attrs['ctrllimited'] = 'true'
      else:
        attrs['ctrllimited'] = 'false'
      if np.all(np.isfinite(a.forcerange)):
        attrs['forcerange'] = _fmt(a.forcerange)
        attrs['forcelimited'] = 'true'
      if a.gear != 1.0:
        attrs['gear'] = f'{a.gear:.12g}'
      ET.SubElement(act, 'general', **attrs)

  if spec.equalities:
    eq = ET.SubElement(root, 'equality')
    for e in spec.equalities:
      attrs = dict(name=e.name, solref=_fmt(e.solref), solimp=_fmt(e.solimp))
      if e.type == EqType.JOINT:
        attrs['joint1'] = e.obj1
        if e.obj2:
          attrs['joint2'] = e.obj2
        attrs['polycoef'] = _fmt(e.data[:5])
        ET.SubElement(eq, 'joint', **attrs)
      elif e.type == EqType.TENDON:
        attrs['tendon1'] = e.obj1
        if e.obj2:
          attrs['tendon2'] = e.obj2
        attrs['polycoef'] = _fmt(e.data[:5])
        ET.SubElement(eq, 'tendon', **attrs)
      elif e.type == EqType.WELD:
        attrs['body1'] = e.obj1
        if e.obj2:
          attrs['body2'] = e.obj2
        ET.SubElement(eq, 'weld', **attrs)
      elif e.type == EqType.CONNECT:
        attrs['body1'] = e.obj1
        if e.obj2:
          attrs['body2'] = e.obj2
        attrs['anchor'] = _fmt(e.data[:3])
        ET.SubElement(eq, 'connect', **attrs)

  if spec.pairs or spec.excludes or spec.pruned_pairs:
    contact = ET.SubElement(root, 'contact')
    for p in spec.pairs:
      fr = p.friction
      ET.SubElement(
          contact, 'pair', geom1=p.geom1, geom2=p.geom2,
          condim=str(p.condim),
          friction=_fmt([fr[0], fr[0], fr[1], fr[2], fr[2]]),
          solref=_fmt(p.solref), solimp=_fmt(p.solimp),
          margin=f'{p.margin:.12g}')
    for x in spec.excludes:
      ET.SubElement(contact, 'exclude', body1=x.body1, body2=x.body2)
    # Pruned dynamic pairs exported as explicit geom-pair exclusions is not
    # supported by MJCF (exclude is body-level); re-emit kept dynamic pairs
    # instead when pruning was applied.
  ET.indent(root)
  return ET.tostring(root, encoding='unicode')


def _export_body_children(elem: ET.Element, body: S.BodySpec,
                          keep_visual: bool, spec=None, ctx=None):
  if body.inertial is not None:
    ET.SubElement(elem, 'inertial', pos=_fmt(body.inertial.pos),
                  quat=_fmt(body.inertial.quat),
                  mass=f'{body.inertial.mass:.12g}',
                  diaginertia=_fmt(body.inertial.diaginertia))
  for j in body.joints:
    if j.type == JointType.FREE:
      ET.SubElement(elem, 'freejoint', name=j.name)
      continue
    attrs = dict(name=j.name, type=_JOINT_NAMES[j.type], pos=_fmt(j.pos),
                 axis=_fmt(j.axis), damping=f'{j.damping:.12g}',
                 armature=f'{j.armature:.12g}',
                 frictionloss=f'{j.frictionloss:.12g}',
                 stiffness=f'{j.stiffness:.12g}',
                 margin=f'{j.margin:.12g}',
                 solreflimit=_fmt(j.solref), solimplimit=_fmt(j.solimp))
    if j.limited:
      attrs['range'] = _fmt(j.range)
      attrs['limited'] = 'true'
    else:
      attrs['limited'] = 'false'
    ET.SubElement(elem, 'joint', **attrs)
  def _mesh_for(g):
    if ctx is None or spec is None or not g.mesh:
      return None
    return spec.meshes.get(g.mesh)

  emitted_dual = set()
  for g in body.geoms:
    if g.type == GeomType.MESH:
      m = _mesh_for(g)
      if m is not None:
        # Visual mesh geom (never collides in this framework).
        ctx['used'][g.mesh] = m
        ET.SubElement(elem, 'geom', name=g.name, type='mesh', mesh=g.mesh,
                      pos=_fmt(g.pos), quat=_fmt(g.quat), contype='0',
                      conaffinity='0', group=str(min(g.group, 2)),
                      rgba=_fmt(g.rgba))
      continue  # mesh geoms are visual-only in this framework
    if not g.collidable and not keep_visual:
      continue
    m = _mesh_for(g)
    dual = m is not None and m.emit_on_body
    group = 4 if dual else min(g.group, 5)
    if dual and g.mesh not in emitted_dual:
      # Dual-use vendor mesh (MPL): the fitted primitive simulates it;
      # re-emit the source mesh as the visible geometry.
      emitted_dual.add(g.mesh)
      ctx['used'][g.mesh] = m
      ET.SubElement(elem, 'geom', name=f'{g.name}__visual', type='mesh',
                    mesh=g.mesh, pos=_fmt(m.pos), quat=_fmt(m.quat),
                    contype='0', conaffinity='0', group='1',
                    rgba=_fmt(g.rgba))
    attrs = dict(name=g.name, type=_GEOM_NAMES[g.type], pos=_fmt(g.pos),
                 quat=_fmt(g.quat), friction=_fmt(g.friction),
                 solref=_fmt(g.solref), solimp=_fmt(g.solimp),
                 margin=f'{g.margin:.12g}', condim=str(g.condim),
                 contype=str(g.contype), conaffinity=str(g.conaffinity),
                 group=str(group), rgba=_fmt(g.rgba))
    size = np.asarray(g.size)
    if g.type == GeomType.PLANE:
      attrs['size'] = _fmt([max(size[0], 1), max(size[1], 1), 0.1])
    elif g.type == GeomType.SPHERE:
      attrs['size'] = _fmt(size[:1])
    elif g.type in (GeomType.CAPSULE, GeomType.CYLINDER):
      attrs['size'] = _fmt(size[:2])
    else:
      attrs['size'] = _fmt(size)
    if g.mass is not None:
      attrs['mass'] = f'{g.mass:.12g}'
    else:
      attrs['density'] = f'{g.density:.12g}'
    ET.SubElement(elem, 'geom', **attrs)
  for s in body.sites:
    ET.SubElement(elem, 'site', name=s.name, pos=_fmt(s.pos),
                  quat=_fmt(s.quat), size=_fmt(np.maximum(s.size, 1e-4)),
                  type=_GEOM_NAMES.get(s.type, 'sphere'),
                  group=str(min(s.group, 5)), rgba=_fmt(s.rgba))


def _export_body(parent: ET.Element, body: S.BodySpec, keep_visual: bool,
                 spec=None, ctx=None):
  attrs = dict(name=body.name, pos=_fmt(body.pos), quat=_fmt(body.quat))
  if body.mocap:
    attrs['mocap'] = 'true'
  elem = ET.SubElement(parent, 'body', **attrs)
  _export_body_children(elem, body, keep_visual, spec, ctx)
  for child in body.children:
    _export_body(elem, child, keep_visual, spec, ctx)
