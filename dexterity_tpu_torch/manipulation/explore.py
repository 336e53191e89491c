"""Interactive exploration CLI (port of dexterity_tpu/manipulation/explore.py;
reference: dexterity/manipulation/explore.py).

Lists registered environments, loads one, optionally wraps actions with
Gaussian noise, and rolls a random policy printing observations and
rewards.  The reference launches the dm_control GUI viewer
(explore.py:58-62); equivalents here:

  --interactive   live mujoco.viewer window driven by the environment —
                  physics steps on --device, the state streams to the
                  host model (vendor meshes) once per control step
                  (rendering.StateBridge); needs a display/GLFW.
  --export p.xml  headless: write the compiled task as MJCF and exit.

The environment runs on --device (cuda unless another is named).

Run: python -m dexterity_tpu_torch.manipulation.explore \
        --environment_name=reach.state_dense --steps 20 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--environment_name', type=str, default=None)
  parser.add_argument('--seed', type=int, default=None)
  parser.add_argument('--steps', type=int, default=10)
  parser.add_argument('--action_noise', type=float, default=0.0)
  parser.add_argument('--export', type=str, default=None,
                      help='write the compiled task as MJCF XML and exit')
  parser.add_argument('--interactive', action='store_true',
                      help='launch a live mujoco.viewer window driven by '
                           'the environment (needs a display)')
  parser.add_argument('--device', type=str, default='cuda',
                      help='device of the environment (default: cuda)')
  args = parser.parse_args(argv)

  from dexterity_tpu_torch import manipulation

  if args.environment_name is None:
    print('Available environments:')
    for i, name in enumerate(manipulation.ALL_NAMES):
      print(f'  [{i}] {name}')
    choice = input('Select environment (index or name): ').strip()
    name = (manipulation.ALL_NAMES[int(choice)] if choice.isdigit()
            else choice)
  else:
    name = args.environment_name
  domain, task_name = name.split('.')

  if args.export:
    from dexterity_tpu_torch.mjcf import export
    task = manipulation.build_task(domain, task_name)
    xml = export.export_mjcf(task.arena.spec)
    with open(args.export, 'w') as f:
      f.write(xml)
    print(f'exported {name} to {args.export}')
    return

  if args.interactive:
    return run_interactive(domain, task_name, seed=args.seed,
                           action_noise=args.action_noise,
                           device=args.device)

  env = manipulation.load_interactive(domain, task_name, seed=args.seed,
                                      device=args.device)
  from dexterity_tpu_torch.manipulation.wrappers import ActionNoise
  if args.action_noise > 0:
    env = ActionNoise(env, scale=args.action_noise)

  ts = env.reset()
  print('observation shapes:')
  for k, v in ts.observation.items():
    print(f'  {k}: {np.asarray(v).shape}')
  spec = env.action_spec()
  rng = np.random.RandomState(args.seed or 0)
  for t in range(args.steps):
    lo = np.where(np.isfinite(spec.minimum), spec.minimum, -1)
    hi = np.where(np.isfinite(spec.maximum), spec.maximum, 1)
    action = rng.uniform(lo, hi)
    ts = env.step(action)
    print(f'step {t}: reward={float(ts.reward):+.4f} '
          f'discount={float(ts.discount):.1f} '
          f'type={int(ts.step_type)}')


def run_interactive(domain, task_name, seed=None, action_noise=0.0,
                    max_steps=None, device=None):
  """Live viewer: the environment's physics on `device` (cuda unless
  given), pixels through mujoco.viewer.

  The counterpart of the reference's dm_control.viewer launch (reference
  explore.py:58-62): a passive mujoco.viewer window shows the host model
  (vendor meshes) while the environment steps a random policy; the state
  crosses once per control step through rendering.StateBridge.  Exits
  with a clear message on headless hosts (no GLFW/display): use --export
  and any MuJoCo viewer instead.
  """
  import time

  import torch

  from dexterity_tpu_torch import manipulation
  from dexterity_tpu_torch.rendering import StateBridge, host_state

  try:
    import mujoco.viewer
  except Exception as e:  # pragma: no cover - environment-dependent
    raise SystemExit(
        f'--interactive needs the mujoco viewer (GLFW + a display): {e}\n'
        'Headless alternatives: --export task.xml, scripts/render_rollout.py')

  task = manipulation.build_task(domain, task_name)
  env = manipulation._environment.GoalEnvironment(task, device=device)
  bridge = StateBridge(task.arena.spec, env.model)

  gen = torch.Generator().manual_seed(seed or 0)
  state, ts = env.reset(gen)
  spec = env.action_spec()
  rng = np.random.RandomState(seed or 0)
  lo = np.where(np.isfinite(spec.minimum), spec.minimum, -1)
  hi = np.where(np.isfinite(spec.maximum), spec.maximum, 1)

  try:
    viewer_ctx = mujoco.viewer.launch_passive(bridge.mm, bridge.md)
  except Exception as e:  # pragma: no cover - environment-dependent
    raise SystemExit(
        f'could not open a viewer window (headless host?): {e}\n'
        'Headless alternatives: --export task.xml, scripts/render_rollout.py')
  control_dt = task.control_timestep
  t = 0
  with viewer_ctx as v:
    opt = bridge.scene_option()
    v.opt.geomgroup[:] = opt.geomgroup
    while v.is_running() and (max_steps is None or t < max_steps):
      t0 = time.time()
      action = rng.uniform(lo, hi) * (action_noise if action_noise else 1.0)
      state, ts = env.step(state, action, gen)
      bridge.copy_state(*host_state(state.data))
      v.sync()
      t += 1
      time.sleep(max(0.0, control_dt - (time.time() - t0)))


if __name__ == '__main__':
  main()
