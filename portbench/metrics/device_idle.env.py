"""Share of the traced window's wall (whole steps, first launch to the
last synchronize) in which no kernel ran on the device: one less the
union of the kernel records' intervals over the wall."""

LAYER = 'device'
UNIT = '%'
MOVES = 'env_steps_per_s'
DRIVERS = ('suite',)


def read(w):
  if not w.kernels:
    return None
  return 100.0 * (1.0 - w.busy_s / w.wall_s)
