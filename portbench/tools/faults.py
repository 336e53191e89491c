"""Faults planted underneath the program, for the checks that the
comparison deciding `correct` fails them: the tests
(`tests/test_portbench_control.py`) and the readings on the chip
(`tools/readings.py --fault NAME`).  Each takes the program's modules,
the cell's driver name and a `setattr` (pytest's monkeypatch.setattr in
the tests), and patches the program in place."""

import dataclasses

import torch


def _unchanged(pkg, driver, setattr_):
  """Every physics step returns the state it was given."""
  name = 'step_n_b' if driver == 'mpc' else 'step_n'
  setattr_(pkg['step'], name, lambda model, data, n, **kw: data)


def _half_batch(pkg, driver, setattr_):
  """Half of the batch left out; its rows take the mean of the rest."""
  if driver == 'mpc':
    cls = pkg['ps'].PredictiveSampling
    orig = cls.rollout_returns_flat

    def half(self, bdata, goals, actions):
      m = actions.shape[0] // 2
      r = orig(self, pkg['types'].map_data(bdata, lambda x: x[:m]),
               goals[:m], actions[:m])
      return torch.cat([r, r.mean().expand(actions.shape[0] - m)])

    setattr_(cls, 'rollout_returns_flat', half)
    return
  cls = pkg['environment'].GoalEnvironment
  orig = cls.step

  def half(self, state, action, gen=None):
    new, ts = orig(self, state, action, gen)
    m = action.shape[0] // 2
    data = new.data
    qpos = torch.cat([data.qpos[:m], data.qpos[:m].mean(0).expand_as(
        data.qpos[m:])])
    qvel = torch.cat([data.qvel[:m], data.qvel[:m].mean(0).expand_as(
        data.qvel[m:])])
    return new.replace(data=data.replace(qpos=qpos, qvel=qvel)), ts

  setattr_(cls, 'step', half)


def _altered(pkg, driver, setattr_):
  """An answer altered where it is produced: the first stream's action,
  or each environment's reward."""
  if driver == 'mpc':
    cls = pkg['ps'].PredictiveSampling
    orig = cls.solve_batch

    def altered(self, *args):
      actions, st = orig(self, *args)
      actions = actions.clone()
      actions[0, 0] += 1e-3
      return actions, st

    setattr_(cls, 'solve_batch', altered)
    return
  cls = pkg['environment'].GoalEnvironment
  orig = cls.step

  def altered(self, state, action, gen=None):
    new, ts = orig(self, state, action, gen)
    return new, dataclasses.replace(ts, reward=ts.reward + 1e-3)

  setattr_(cls, 'step', altered)


def _step_types(pkg, setattr_, alter):
  cls = pkg['environment'].GoalEnvironment
  orig = cls.step

  def altered(self, state, action, gen=None):
    new, ts = orig(self, state, action, gen)
    return new, dataclasses.replace(ts, step_type=alter(ts.step_type))

  setattr_(cls, 'step', altered)


def _first_flipped(pkg, driver, setattr_):
  """Termination altered where it is produced: the first environment's
  step type flipped (an episode ended that did not end, or the other
  way), and the row reset accordingly."""
  del driver

  def flip(step_type):
    out = step_type.clone()
    out[0] = 3 - out[0] if int(out[0]) in (1, 2) else out[0]
    return out

  _step_types(pkg, setattr_, flip)


def _never_last(pkg, driver, setattr_):
  """No episode ends: every step type MID."""
  del driver
  _step_types(pkg, setattr_, lambda t: torch.where(t == 2, 1, t).to(t.dtype))


FAULTS = {'unchanged': _unchanged, 'half_batch': _half_batch,
          'altered': _altered, 'first_flipped': _first_flipped,
          'never_last': _never_last}
