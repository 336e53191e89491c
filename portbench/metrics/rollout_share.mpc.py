"""Share of the planner's host wall (`solve_batch`) spent inside
`rollout_returns_flat`, from the benchmark's spans around both."""

LAYER = 'planner'
UNIT = '%'
MOVES = 'solves_per_s'
DRIVERS = ('mpc',)


def read(w):
  spans = w.spans()
  if 'planner.solve_batch' not in spans:
    return None
  inner = spans.get('planner.rollout_returns_flat', [0, 0.0])[1]
  return 100.0 * inner / spans['planner.solve_batch'][1]
