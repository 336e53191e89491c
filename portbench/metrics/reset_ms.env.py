"""Host ms per batched step inside `BatchedEnvironment._merge_resets`
(the resets of done rows with their goal sampling), from the
benchmark's span; nothing where no row was reset in the window."""

LAYER = 'environment'
UNIT = 'ms/step'
MOVES = 'env_steps_per_s'
DRIVERS = ('suite',)


def read(w):
  if not w.counters.get('rows_reset'):
    return None
  spans = w.spans()
  return 1e3 * spans.get('env.merge_resets', [0, 0.0])[1] / w.calls
