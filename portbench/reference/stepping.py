"""The reference's side of an auto-resetting batched environment step
(`BatchedEnvironment.step_with_metrics`).

`step_call` works one step out again from the program's input state, the
actions, the state of the generator the step drew from and the episode
metrics it received: the goal switches, the physics of every
environment, rewards, observations and termination, then the resets of
the rows the program found done, drawn from the same generator where the
program's draws continued, and the metrics' update.  It follows the
program's done rows, so that the states of both sides stay comparable;
the program's termination is judged against the reference's own.  With
the state it gives each row's margins from its own termination
thresholds (`margins`).

`compare` gives the numbers that decide `correct`, over every row:
  qpos_*, qvel_*   each row's next state (reset rows included), max-abs;
  reward_*         each row's reward, over the larger of 1 and its own
                   |reward| (reorient's shaped reward carries a success
                   bonus of weight 800: one row's scale would hide the
                   others');
  obs_*            each row's observations, each over the larger of 1 and
                   its largest |value|;
  each as its 50th and 99th percentile over the rows (_p50, _p99) and its
  largest (_max);
  flag_share       rows whose step type, success counters or task flags
                   differ from the reference's own, as a share of the
                   batch, leaving out the rows that lie within rounding of
                   a termination threshold (`near`);
  flag_near        the rows so left out that differ, as a share;
  reset_gap        the rows the program reset: their new joint positions,
                   goals and mass matrices (over the larger of 1 and the
                   largest |entry|), max-abs (0 where no row was reset);
  goal_gap         the goals of the rows the program did not reset, after
                   the step, max-abs;
  metrics_gap      the episode metrics' sums and running returns, over the
                   larger of 1 and each one's largest |value|.

A row lies within rounding of a threshold where the reference's margin
from it is under NEAR_GAIN times the row's gap in the observed pose of
the bodies that the thresholds read (observations named `*/position`,
`*/orientation`), plus NEAR_FLOOR; or, for the time per goal, under
NEAR_TIME seconds.  A decision there can go either way by rounding; the
row's state is judged by the other numbers.
"""

import torch

from reference.dex import manipulation
from reference.dex.envs import batched
from reference.dex.utils import metrics as metrics_lib

LAST = 2      # StepType.LAST
NEAR_GAIN = 10.0     # margin per unit of pose gap (metres, radians)
NEAR_FLOOR = 1e-5    # float32 rounding of a distance or an angle, with room
NEAR_TIME = 1e-3     # seconds: a fifth of a physics step
_FLAGS = ('successes', 'success_change_counter', 'exceeded_single_goal_time',
          'success_registered', 'goal_changed', 'failure_termination',
          'goal_ok')


def build(config, batch, device, dtype):
  env = manipulation.load(config['task'], config['variant'], device=device,
                          dtype=dtype)
  return env, batched.BatchedEnvironment(env, batch)


def _least(x):
  """The least of each row's entries of a (B, k) tensor, inf where k = 0."""
  if x.shape[-1] == 0:
    return torch.full(x.shape[:-1], float('inf'), dtype=torch.float64,
                      device=x.device)
  return x.double().amin(-1)


def margins(env, state):
  """Each row's distance from the thresholds that end its episode, from
  the state after the step (before any reset): {'contact': the least
  |dist| of the contacts whose penetration ends it (m), 'success':
  |goal distance - success threshold| (rad), 'time': |time on the goal -
  its limit| (s)}; inf where the task has no such rule."""
  task, data, tstate = env.task, state.data, state.task
  batch = data.qpos.shape[:-1]
  inf = torch.full(batch, float('inf'), dtype=torch.float64,
                   device=data.qpos.device)
  out = {'contact': inf, 'success': inf, 'time': inf}
  mask = getattr(task, '_fall_mask', None)
  if getattr(task, '_fall_termination', False) and mask is not None:
    pair = data.contact.pair
    sel = torch.as_tensor(mask, device=pair.device)[pair.clamp_min(0)] & (
        pair >= 0)
    dist = data.contact.dist.double().abs().masked_fill(~sel, float('inf'))
    out['contact'] = _least(dist)
  out['success'] = _least(
      (tstate.goal_distance.double() - task.success_threshold).abs())
  if task.max_time_per_goal is not None:
    out['time'] = (data.time.double() - tstate.solve_start_time.double()
                   - task.max_time_per_goal).abs().expand(batch)
  return out


def step_call(benv, state, actions, gen_state, metrics, done_prog=None):
  """(next state, timestep, metrics, margins) of the reference; done_prog:
  the program's done rows, which the reference resets (None: its own,
  where it stands in the program's place)."""
  gen = torch.Generator()
  gen.set_state(gen_state)
  new_state, ts = benv.env.step(state, actions, gen)
  if done_prog is None:
    done_prog = ts.step_type == LAST
  metrics = metrics_lib.update(metrics, ts.reward, done_prog,
                               new_state.task.successes)
  return (benv._merge_resets(new_state, done_prog, gen), ts, metrics,
          margins(benv.env, new_state))


def _gap(a, b):
  if a.numel() == 0:
    return 0.0
  return (a.double() - b.double()).abs().max().item()


def _rel(a, b):
  if a.numel() == 0:
    return 0.0
  return _gap(a, b) / max(b.double().abs().max().item(), 1.0)


def _row_gap(a, b):
  """Per-row max-abs gap of (B, ...) tensors."""
  d = (a.double() - b.double()).abs()
  return d.reshape(d.shape[0], -1).amax(1) if d.ndim > 1 else d


def _spread(name, rows, out):
  """The 50th and 99th percentiles and the largest of a per-row gap."""
  rows = torch.nan_to_num(rows, nan=float('inf'))
  q = torch.quantile(rows.double().cpu(), torch.tensor(
      [0.5, 0.99], dtype=torch.float64)).tolist()
  out[name + '_p50'], out[name + '_p99'] = q
  out[name + '_max'] = rows.max().item()


def _near(prog_obs, ref_obs, margin):
  """The rows within rounding of a termination threshold (see above)."""
  pose = torch.zeros_like(margin['contact'])
  for k, want in ref_obs.items():
    if k.endswith(('/position', '/orientation')):
      pose = torch.maximum(pose, _row_gap(prog_obs[k], want))
  room = NEAR_GAIN * pose + NEAR_FLOOR
  return ((margin['contact'] <= room) | (margin['success'] <= room)
          | (margin['time'] <= NEAR_TIME))


def compare(prog, ref, last):
  """prog: (state, timestep, metrics, ...) after the step; ref: the same
  with the reference's margins last; `last`: the step type that ends an
  episode."""
  (ps_, pts, pm), (rs, rts, rm, margin) = prog[:3], ref
  nums = {}
  _spread('qpos', _row_gap(ps_.data.qpos, rs.data.qpos), nums)
  _spread('qvel', _row_gap(ps_.data.qvel, rs.data.qvel), nums)
  _spread('reward', _row_gap(pts.reward, rts.reward)
          / rts.reward.double().abs().clamp_min(1.0), nums)
  obs = torch.zeros_like(rts.reward, dtype=torch.float64)
  for k, want in rts.observation.items():
    s = max(want.double().abs().max().item(), 1.0)
    obs = torch.maximum(obs, _row_gap(pts.observation[k], want) / s)
  _spread('obs', obs, nums)
  rows = pts.step_type != rts.step_type
  for f in _FLAGS:
    a, b = getattr(ps_.task, f), getattr(rs.task, f)
    rows = rows | (a.to(b.dtype) != b)
  near = _near(pts.observation, rts.observation, margin)
  nums['flag_share'] = (rows & ~near).double().mean().item()
  nums['flag_near'] = (rows & near).double().mean().item()
  reset = pts.step_type == last
  qm_scale = max(rs.data.qM.double().abs().max().item(), 1.0)
  nums['reset_gap'] = max(
      _gap(ps_.data.qpos[reset], rs.data.qpos[reset]),
      _gap(ps_.data.qM[reset], rs.data.qM[reset]) / qm_scale,
      _gap(ps_.task.goal[reset], rs.task.goal[reset]))
  nums['goal_gap'] = _gap(ps_.task.goal[~reset], rs.task.goal[~reset])
  nums['metrics_gap'] = max(_rel(getattr(pm, f), getattr(rm, f)) for f in (
      'episodes', 'env_steps', 'length_sum', 'success_sum', 'return_sum',
      'cur_return', 'cur_length'))
  return {k: (v if v == v else float('inf')) for k, v in nums.items()}


def start_gaps(start, ref_start):
  """The batch's first states and goals, (qpos, goal), against the
  reference's reset from the same generator seed."""
  return {'start_qpos_gap': _gap(start[0], ref_start[0]),
          'start_goal_gap': _gap(start[1], ref_start[1])}
