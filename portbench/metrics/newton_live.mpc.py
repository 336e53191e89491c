"""Share of the Newton solve's row-iterations whose line search still
moved (step > 0), from the program's `constraint.newton` counters
`moved` and `row_iters`: a row at step 0 repeats the same arithmetic in
every later iteration."""

from harness import program

LAYER = 'constraint'
UNIT = '%'
MOVES = 'solves_per_s'
DRIVERS = ('mpc',)


def read(w):
  return program.counter_share(w, 'constraint.newton', 'moved', 'row_iters')
