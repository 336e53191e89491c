"""Host ms per call inside the constraint solve (`constraint.solve`),
from the benchmark's span."""

LAYER = 'constraint'
UNIT = 'ms/call'
MOVES = 'solves_per_s'
DRIVERS = ('mpc',)


def read(w):
  spans = w.spans()
  if 'constraint.solve' not in spans:
    return None
  return 1e3 * spans['constraint.solve'][1] / w.calls
