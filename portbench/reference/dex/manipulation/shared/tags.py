"""String constants annotating task constructors (port of
dexterity_tpu/manipulation/shared/tags.py)."""

# Complexity.
EASY = 'easy'
HARD = 'hard'

# Observation type.
STATE = 'features'
VISION = 'vision'

# Reward type.
SPARSE = 'sparse'
DENSE = 'dense'
