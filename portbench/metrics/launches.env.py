"""Kernel records per step in the traced window, which stands only where
the records of the kernels the program counts equal its launch
counters."""

LAYER = 'host dispatch'
UNIT = 'launches/step'
MOVES = 'env_steps_per_s'
DRIVERS = ('suite',)


def read(w):
  return w.records() / w.calls or None
