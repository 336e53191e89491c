"""Host ms per call in the kinematics (the tree sweep's planes and the
refresh's frames and velocities), from the program's own spans:
`physics.planes` plus the self time of `physics.refresh` less its
narrow phase."""

from harness import program

LAYER = 'kinematics'
UNIT = 'ms/call'
MOVES = 'solves_per_s'
DRIVERS = ('mpc',)


def read(w):
  return program.kinematics_ms(w)
