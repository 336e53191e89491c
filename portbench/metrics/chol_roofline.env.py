"""The Cholesky kernel's share of its roofline on the environment step:
the least time for the window's steps' Cholesky work, counted from the
cell's shapes (harness.roofline.env_step_cholesky_s), over the device
time of the Cholesky kernel records in the window.  The resets' own
solves, on the few rows reset, are in the device time and not in the
work, so the share reads them as waste."""

from harness import roofline, trace

LAYER = 'kernels'
UNIT = '%'
MOVES = 'env_steps_per_s'
DRIVERS = ('suite',)


def read(w):
  device_s = w.device_s(trace.CHOLESKY_KERNELS)
  if not device_s:
    return None
  least = roofline.env_step_cholesky_s(w.cell['config']['env'],
                                       w.cell['traffic']['batch'])
  return 100.0 * least * w.calls / device_s
