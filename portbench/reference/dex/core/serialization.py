"""ModelSpec <-> JSON serialization (port of
dexterity_tpu/core/serialization.py).

Hand models ship as JSON assets under dexterity_tpu_torch/models/assets, a
byte-equal copy of the JAX package's assets.  Both directions are ported:
`save_spec` writes the bytes the JAX package's writer writes for the same
spec, and `load_spec` reads them back.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np

from reference.dex.core import spec as S
from reference.dex.core.types import (ActuatorTrn, BiasType, EqType,
                                            GeomType, JointType)

_ENUMS = {'type': None}  # the JAX module's name; no encoder reads it


def _enc(value):
  if isinstance(value, np.ndarray):
    return value.tolist()
  if isinstance(value, (np.floating, np.integer)):
    return value.item()
  if isinstance(value, (JointType, GeomType, ActuatorTrn, BiasType, EqType)):
    return int(value)
  if isinstance(value, tuple):
    return [_enc(v) for v in value]
  if isinstance(value, list):
    return [_enc(v) for v in value]
  if isinstance(value, float) and (value == np.inf or value == -np.inf):
    return 'inf' if value > 0 else '-inf'
  return value


def _enc_dataclass(obj) -> Dict[str, Any]:
  out = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    if isinstance(v, list) and v and dataclasses.is_dataclass(v[0]):
      out[f.name] = [_enc_dataclass(c) for c in v]
    elif f.name == 'inertial':
      out[f.name] = _enc_dataclass(v) if v is not None else None
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
      out[f.name] = _enc_dataclass(v)
    else:
      out[f.name] = _enc(v)
  return out


def spec_to_dict(spec: S.ModelSpec) -> Dict[str, Any]:
  return {
      'name': spec.name,
      'option': _enc_dataclass(spec.option),
      'worldbody': _enc_dataclass(spec.worldbody),
      'tendons': [_enc_dataclass(t) for t in spec.tendons],
      'actuators': [_enc_dataclass(a) for a in spec.actuators],
      'equalities': [_enc_dataclass(e) for e in spec.equalities],
      'pairs': [_enc_dataclass(p) for p in spec.pairs],
      'excludes': [_enc_dataclass(x) for x in spec.excludes],
      'pruned_pairs': sorted([list(p) for p in spec.pruned_pairs]),
      'meshes': {k: _enc_dataclass(m) for k, m in sorted(spec.meshes.items())},
  }


def _dec_float(v):
  if v == 'inf':
    return np.inf
  if v == '-inf':
    return -np.inf
  return v


def _dec_tuple(v):
  return tuple(_dec_float(x) for x in v)


def _dec_inertial(d):
  if d is None:
    return None
  return S.InertialSpec(pos=np.asarray(d['pos']), quat=np.asarray(d['quat']),
                        mass=d['mass'], diaginertia=np.asarray(d['diaginertia']))


def _dec_body(d) -> S.BodySpec:
  body = S.BodySpec(
      name=d['name'], pos=np.asarray(d['pos']), quat=np.asarray(d['quat']),
      inertial=_dec_inertial(d.get('inertial')), mocap=d.get('mocap', False))
  for j in d.get('joints', []):
    body.joints.append(S.JointSpec(
        name=j['name'], type=JointType(j['type']), pos=np.asarray(j['pos']),
        axis=np.asarray(j['axis']), range=_dec_tuple(j['range']),
        limited=j['limited'], damping=j['damping'], armature=j['armature'],
        frictionloss=j['frictionloss'], stiffness=j['stiffness'],
        springref=j.get('springref', 0.0), margin=j['margin'],
        solref=_dec_tuple(j['solref']), solimp=_dec_tuple(j['solimp'])))
  for g in d.get('geoms', []):
    body.geoms.append(S.GeomSpec(
        name=g['name'], type=GeomType(g['type']), pos=np.asarray(g['pos']),
        quat=np.asarray(g['quat']), size=np.asarray(g['size']),
        friction=_dec_tuple(g['friction']), solref=_dec_tuple(g['solref']),
        solimp=_dec_tuple(g['solimp']), margin=g['margin'], gap=g['gap'],
        condim=g['condim'], contype=g['contype'],
        conaffinity=g['conaffinity'], group=g['group'],
        density=g['density'], mass=g['mass'], rgba=_dec_tuple(g['rgba']),
        mesh=g.get('mesh')))
  for s in d.get('sites', []):
    body.sites.append(S.SiteSpec(
        name=s['name'], pos=np.asarray(s['pos']), quat=np.asarray(s['quat']),
        size=np.asarray(s['size']), type=GeomType(s['type']),
        group=s['group'], rgba=_dec_tuple(s['rgba'])))
  for c in d.get('children', []):
    body.children.append(_dec_body(c))
  return body


def spec_from_dict(d: Dict[str, Any]) -> S.ModelSpec:
  opt = d['option']
  spec = S.ModelSpec(
      name=d['name'],
      option=S.OptionSpec(
          timestep=opt['timestep'], gravity=_dec_tuple(opt['gravity']),
          solver_iterations=opt['solver_iterations'],
          ls_iterations=opt['ls_iterations'],
          contact_top_k=opt.get('contact_top_k', 64)),
      worldbody=_dec_body(d['worldbody']))
  for t in d.get('tendons', []):
    spec.tendons.append(S.TendonSpec(
        name=t['name'], joints=[(j, c) for j, c in t['joints']],
        range=_dec_tuple(t['range']), limited=t['limited'],
        margin=t['margin'], solref=_dec_tuple(t['solref']),
        solimp=_dec_tuple(t['solimp'])))
  for a in d.get('actuators', []):
    spec.actuators.append(S.ActuatorSpec(
        name=a['name'], trntype=ActuatorTrn(a['trntype']), target=a['target'],
        gainprm=_dec_tuple(a['gainprm']), biastype=BiasType(a['biastype']),
        biasprm=_dec_tuple(a['biasprm']), ctrlrange=_dec_tuple(a['ctrlrange']),
        ctrllimited=a.get('ctrllimited', True),
        forcerange=_dec_tuple(a['forcerange']), gear=a['gear']))
  for e in d.get('equalities', []):
    spec.equalities.append(S.EqualitySpec(
        name=e['name'], type=EqType(e['type']), obj1=e['obj1'], obj2=e['obj2'],
        data=np.asarray(e['data']), solref=_dec_tuple(e['solref']),
        solimp=_dec_tuple(e['solimp']), active=e.get('active', True)))
  for p in d.get('pairs', []):
    spec.pairs.append(S.PairSpec(
        geom1=p['geom1'], geom2=p['geom2'], condim=p['condim'],
        friction=_dec_tuple(p['friction']), solref=_dec_tuple(p['solref']),
        solimp=_dec_tuple(p['solimp']), margin=p['margin']))
  for x in d.get('excludes', []):
    spec.excludes.append(S.ExcludeSpec(body1=x['body1'], body2=x['body2']))
  spec.pruned_pairs = {tuple(p) for p in d.get('pruned_pairs', [])}
  for k, m in d.get('meshes', {}).items():
    spec.meshes[k] = S.MeshSpec(
        name=m['name'], file=m['file'], scale=_dec_tuple(m['scale']),
        emit_on_body=m.get('emit_on_body', False),
        pos=_dec_tuple(m.get('pos', (0.0, 0.0, 0.0))),
        quat=_dec_tuple(m.get('quat', (1.0, 0.0, 0.0, 0.0))))
  return spec


def save_spec(spec: S.ModelSpec, path: str) -> None:
  with open(path, 'w') as f:
    json.dump(spec_to_dict(spec), f, indent=1)


def load_spec(path: str) -> S.ModelSpec:
  with open(path) as f:
    return spec_from_dict(json.load(f))
