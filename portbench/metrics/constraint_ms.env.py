"""Host ms per step inside the constraint solve (`constraint.solve`),
from the benchmark's span."""

LAYER = 'constraint'
UNIT = 'ms/step'
MOVES = 'env_steps_per_s'
DRIVERS = ('suite',)


def read(w):
  spans = w.spans()
  if 'constraint.solve' not in spans:
    return None
  return 1e3 * spans['constraint.solve'][1] / w.calls
