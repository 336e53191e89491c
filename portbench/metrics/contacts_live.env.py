"""Share of the narrow phase's contact slots that the constraint solve
keeps as active contacts (its top-k mask: dist - margin < 0, at most
contact_top_k a row), over the window's solves, from the program's
`constraint.assemble` counters `live` and `slots`."""

from harness import program

LAYER = 'collision'
UNIT = '%'
MOVES = 'env_steps_per_s'
DRIVERS = ('suite',)


def read(w):
  return program.counter_share(w, 'constraint.assemble', 'live', 'slots')
