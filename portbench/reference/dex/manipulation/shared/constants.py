"""Shared constants (port of dexterity_tpu/manipulation/shared/constants.py)."""

RED = (1.0, 0.0, 0.0, 0.3)
GREEN = (0.0, 1.0, 0.0, 0.3)
BLUE = (0.0, 0.0, 1.0, 0.3)
CYAN = (0.0, 1.0, 1.0, 0.3)
MAGENTA = (1.0, 0.0, 1.0, 0.3)
YELLOW = (1.0, 1.0, 0.0, 0.3)

TASK_SITE_GROUP = 3
