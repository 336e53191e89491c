"""Kernel records per call in the traced window, which stands only where
the records of the kernels the program counts equal its launch
counters."""

LAYER = 'host dispatch'
UNIT = 'launches/call'
MOVES = 'solves_per_s'
DRIVERS = ('mpc',)


def read(w):
  return w.records() / w.calls or None
