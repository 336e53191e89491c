"""The Cholesky kernels' share of their roofline on the planner path: the
least time for the Cholesky work of the window's calls, counted from the
cell's shapes (harness.roofline.planner_cholesky_s), over the device time
of the Cholesky kernel records in the window."""

from harness import roofline, trace

LAYER = 'kernels'
UNIT = '%'
MOVES = 'solves_per_s'
DRIVERS = ('mpc',)


def read(w):
  device_s = w.device_s(trace.CHOLESKY_KERNELS)
  if not device_s:
    return None
  least = roofline.planner_cholesky_s(w.cell['config']['plan'],
                                      w.cell['traffic'])
  return 100.0 * least * w.calls / device_s
