"""Reduced-fidelity planning models (port of dexterity_tpu/planners/common.py).

Fewer Newton/line-search iterations, a coarser integration timestep, a
smaller contact budget, optional implicit joint damping, and a
moving-base-only collision pair set.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from reference.dex.core import types as T


def reduced_planning_model(
    task,
    solver_iterations: int,
    ls_iterations: int,
    solver_refactor_every: int = 1,
    plan_substeps: Optional[int] = None,
    plan_midphase_cap: Optional[int] = None,
    plan_contact_top_k: Optional[int] = None,
    plan_implicit_damping: bool = False,
    plan_self_collision: bool = True,
    device=None,
    dtype=torch.float32,
):
  """Builds (model, n_substeps) for planning rollouts on `device` (cuda
  unless given).

  `n_substeps` is how many planning-model substeps integrate one control
  step; when `plan_substeps` is set the timestep coarsens to
  control_timestep / plan_substeps.
  """
  model = task.compile(device=device, dtype=dtype)
  opt = model.opt.replace(
      solver_iterations=solver_iterations,
      ls_iterations=ls_iterations,
      solver_refactor_every=solver_refactor_every)
  if plan_midphase_cap:
    opt = opt.replace(midphase_cap=plan_midphase_cap)
  if plan_contact_top_k:
    opt = opt.replace(contact_top_k=plan_contact_top_k)
  n_substeps = plan_substeps if plan_substeps else task.n_substeps
  if plan_substeps:
    opt = opt.replace(timestep=task.control_timestep / plan_substeps)
  if plan_implicit_damping:
    opt = opt.replace(implicit_damping=True)
  plan_model = model.replace(opt=opt)
  if not plan_self_collision:
    moving = T.moving_base_bodies(model)
    gb = np.asarray(model.geom_bodyid)
    keep = [i for i in range(model.npair)
            if int(gb[model.pair_geom1[i]]) in moving
            or int(gb[model.pair_geom2[i]]) in moving]
    if len(keep) < model.npair:
      plan_model = T.subset_pairs(plan_model, keep)
  return plan_model, n_substeps
