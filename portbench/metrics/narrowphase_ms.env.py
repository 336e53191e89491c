"""Host ms per step inside the narrow phase (`primitives.midphase_selinfo`
and `collide_group_planes`), from the benchmark's spans."""

LAYER = 'collision'
UNIT = 'ms/step'
MOVES = 'env_steps_per_s'
DRIVERS = ('suite',)


def read(w):
  spans = w.spans()
  names = ('collision.midphase_selinfo', 'collision.collide_group_planes')
  if not any(n in spans for n in names):
    return None
  return 1e3 * sum(spans.get(n, [0, 0.0])[1] for n in names) / w.calls
