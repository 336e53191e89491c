"""Driver of the sampling planner: a farm of MPC streams served by one
`PredictiveSampling.solve_batch` call at a time.

Set-up compiles the planning model and the environment model, resets one
episode per stream (`GoalEnvironment.reset`, a CPU generator drawn from
the seed), and warms the call.  Each timed call solves every stream once
from those start states and goals, warm-started from the previous call's
nominal plan, as a controller re-plans each control step; one solve is a
stream's CEM iterations over its samples.

The check: after the window, one call drawn from the seed is worked out
again by the reference in float64 (`reference.planning`) from the call's
own inputs, and its candidates, returns, kept plans and actions judged;
the start states and goals are held against the reference's reset.
"""

import contextlib
import gc

import torch

from harness import port
from reference import convert, planning, precision

RATE = ('solves_per_s', 'solves/s')


class Mpc:
  rate_name, rate_unit = RATE

  def __init__(self, ctx):
    pkg, cfg, tr = ctx.pkg, ctx.cell.config, ctx.cell.traffic
    self.ctx = ctx
    self.device = ctx.device
    self.traffic = tr
    s_reset, s_plan, s_pick = ctx.seeds(3)
    self.pick_seed = s_pick
    task = pkg['manipulation'].build_task(cfg['task'], cfg['variant'])
    ref_cfg = planning.planner_config(cfg['plan'], tr)
    pcfg = pkg['ps'].PredictiveSamplingConfig(**{
        f: getattr(ref_cfg, f) for f in ref_cfg.__dataclass_fields__})
    self.planner = pkg['ps'].PredictiveSampling(
        task, pcfg, device=ctx.device, dtype=ctx.dtype)
    port.check_sizes(self.planner.model, cfg['plan']['model'],
                     'planning model')
    env = pkg['manipulation'].load(cfg['task'], cfg['variant'],
                                   device=ctx.device, dtype=ctx.dtype)
    port.check_sizes(env.model, cfg['env']['model'], 'environment model')
    self.streams = tr['streams']
    self.units = self.streams
    self.reset_seed = s_reset
    state, _ = env.reset(torch.Generator().manual_seed(s_reset),
                         (self.streams,))
    self.data, self.goals = state.data, state.task.goal
    self.gen = torch.Generator(device=ctx.device).manual_seed(s_plan)
    self.pstate = self.planner.init_state(streams=self.streams)
    self.calls = []
    self._iters = None
    orig = self.planner.rollout_returns_flat

    def captured(bdata, goals, actions):
      returns = orig(bdata, goals, actions)
      if self._iters is not None:
        self._iters.append((actions, returns))
      return returns

    self.planner.rollout_returns_flat = captured
    for _ in range(tr['warm_calls']):
      self._solve()
    self.calls.clear()
    del env, state

  def _solve(self):
    rec = {'gen_state': self.gen.get_state(),
           'nominal_in': self.pstate.nominal}
    self._iters = []
    actions, self.pstate = self.planner.solve_batch(
        self.data, self.goals, self.pstate, self.gen)
    rec.update(iters=self._iters, actions=actions,
               nominal_out=self.pstate.nominal)
    self._iters = None
    self.calls.append(rec)

  def call(self):
    self._solve()
    if self.device.type == 'cuda':
      torch.cuda.synchronize()

  def span_targets(self):
    pkg = self.ctx.pkg
    return [(self.planner, 'solve_batch', 'planner.solve_batch'),
            (self.planner, 'rollout_returns_flat',
             'planner.rollout_returns_flat'),
            (pkg['step'], 'step_n_b', 'physics.step_n_b'),
            (pkg['primitives'], 'midphase_selinfo',
             'collision.midphase_selinfo'),
            (pkg['primitives'], 'collide_group_planes',
             'collision.collide_group_planes'),
            (pkg['constraint'], 'solve', 'constraint.solve')]

  def counters(self):
    return {}

  def release(self):
    """Keeps what the check reads: the start, and the calls' records."""
    self.planner = None
    self.pstate = None
    gc.collect()
    if self.device.type == 'cuda':
      torch.cuda.empty_cache()

  def _record(self):
    g = torch.Generator().manual_seed(self.pick_seed)
    return self.calls[int(torch.randint(len(self.calls), (), generator=g))]

  def _program(self, rec):
    shape = (self.streams, self.traffic['samples'], self.traffic['horizon'],
             -1)
    return {'cands': [a.reshape(shape) for a, _ in rec['iters']],
            'returns': [r.reshape(self.streams, -1)
                        for _, r in rec['iters']],
            'actions': rec['actions'], 'nominal': rec['nominal_out']}

  def _reference(self, rec, picks, dtype):
    """The reference's call from `rec`'s inputs, in `dtype`."""
    _, planner = planning.build(self.ctx.cell.config, self.traffic,
                                self.device, dtype)
    return planning.solve_call(
        planner, convert.to_reference(self.data, dtype),
        convert.cast(self.goals, dtype),
        convert.cast(rec['nominal_in'], dtype), rec['gen_state'],
        self.ctx.dtype, picks=picks)

  def _start(self, dtype):
    """The reference's reset of the streams from the run's seed."""
    env, _ = planning.build(self.ctx.cell.config, self.traffic, self.device,
                            dtype)
    state, _ = env.reset(torch.Generator().manual_seed(self.reset_seed),
                         (self.streams,))
    return state.data, state.task.goal

  def numbers(self):
    """The numbers that decide `correct` (reference.planning), and the
    stream-solves of the checked call with non-finite actions."""
    rec = self._record()
    nums = planning.start_gaps(self.data, self.goals,
                               *self._start(torch.float64))
    prog = self._program(rec)
    ref = self._reference(rec, planning.picks_of(prog['returns']),
                          torch.float64)
    nums.update(planning.compare(prog, ref))
    return nums, int((~torch.isfinite(rec['actions']).all(-1)).sum())

  def control_numbers(self, tf32=True):
    """The control: the reference in float32 (TF32 products with tf32) in
    the program's place on the checked call's inputs, judged as the
    program is."""
    rec = self._record()
    with precision.TF32Products() if tf32 else contextlib.nullcontext():
      start = self._start(torch.float32)
      ctrl = self._reference(rec, None, torch.float32)
    nums = planning.start_gaps(*start, *self._start(torch.float64))
    ref = self._reference(rec, ctrl['picks'], torch.float64)
    nums.update(planning.compare(ctrl, ref))
    return nums


def setup(ctx):
  return Mpc(ctx)
