"""Exceptions (port of dexterity_tpu/exception.py)."""


class GoalInitializationError(RuntimeError):
  """Raised when goal rejection sampling exhausts its budget.

  The batched environment reports this as the `goal_ok` flag of its task
  state; the stateful InteractiveEnvironment raises it after its reset
  retries, as the reference's reset does.
  """
