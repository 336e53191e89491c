"""Task suite entry point (port of dexterity_tpu/manipulation's
build_task; only reorient.state_dense is ported)."""

from __future__ import annotations

from dexterity_tpu_torch.manipulation.tasks import reorient

_TASKS = {('reorient', 'state_dense'): reorient.state_dense}


def build_task(domain_name: str, task_name: str):
  """Builds the named task (no tensors yet: `task.compile(device=...)`)."""
  try:
    return _TASKS[(domain_name, task_name)]()
  except KeyError:
    raise ValueError(
        f'unknown task {domain_name}.{task_name}; ported: '
        f'{sorted(".".join(k) for k in _TASKS)}') from None
