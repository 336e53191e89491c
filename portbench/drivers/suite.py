"""Driver of the batched RL suite: `BatchedEnvironment.step_with_metrics`
over B auto-resetting episodes under uniform random actions.

Set-up compiles the environment model, resets B episodes (a CPU
generator drawn from the seed, as the environment takes its draws),
and takes the warm-up steps.  Each timed call is one batched step; its
actions are drawn on the device from the seed over the action range.
Episodes that end are reset in place inside the step.

The check: after the window, the last step is worked out again by the
reference in float64 (`reference.stepping`) from the step's own input
state, actions and generator state, over every row, and judged; the
first states and goals are held against the reference's reset.
"""

import contextlib
import gc

import torch

from harness import port
from reference import convert, precision, stepping

RATE = ('env_steps_per_s', 'steps/s')


class Suite:
  rate_name, rate_unit = RATE

  def __init__(self, ctx):
    pkg, cfg, tr = ctx.pkg, ctx.cell.config, ctx.cell.traffic
    self.ctx = ctx
    self.device = ctx.device
    s_reset, s_act = ctx.seeds(2)
    self.reset_seed = s_reset
    env = pkg['manipulation'].load(cfg['task'], cfg['variant'],
                                   device=ctx.device, dtype=ctx.dtype)
    port.check_sizes(env.model, cfg['env']['model'], 'environment model')
    self.batch = tr['batch']
    self.units = self.batch
    self.benv = pkg['batched'].BatchedEnvironment(env, self.batch)
    spec = env.action_spec()
    self.lo = torch.as_tensor(spec.minimum, dtype=ctx.dtype,
                              device=ctx.device)
    self.hi = torch.as_tensor(spec.maximum, dtype=ctx.dtype,
                              device=ctx.device)
    self.gen = torch.Generator().manual_seed(s_reset)
    self.agen = torch.Generator(device=ctx.device).manual_seed(s_act)
    self.state, _ = self.benv.reset(self.gen)
    self.start = (self.state.data.qpos.clone(),
                  self.state.task.goal.clone())
    self.metrics = pkg['metrics'].init(self.batch, dtype=ctx.dtype,
                                       device=ctx.device)
    self.rows_reset = torch.zeros((), dtype=torch.int64, device=ctx.device)
    self.last = None
    for _ in range(tr['warm_steps']):
      self.call()
    self.rows_reset.zero_()

  def call(self):
    actions = self.lo + (self.hi - self.lo) * torch.rand(
        self.batch, self.lo.shape[0], generator=self.agen,
        device=self.device, dtype=self.lo.dtype)
    before = (self.state, actions, self.gen.get_state(), self.metrics)
    self.state, ts, self.metrics = self.benv.step_with_metrics(
        self.state, actions, self.metrics, self.gen)
    self.rows_reset += (ts.step_type == 2).sum()
    self.last = (before, (self.state, ts, self.metrics))
    if self.device.type == 'cuda':
      torch.cuda.synchronize()

  def span_targets(self):
    pkg = self.ctx.pkg
    return [(self.benv, 'step_with_metrics', 'env.step_with_metrics'),
            (self.benv.env, 'step', 'env.step'),
            (self.benv, '_merge_resets', 'env.merge_resets'),
            (pkg['step'], 'step_n', 'physics.step_n'),
            (pkg['primitives'], 'midphase_selinfo',
             'collision.midphase_selinfo'),
            (pkg['primitives'], 'collide_group_planes',
             'collision.collide_group_planes'),
            (pkg['constraint'], 'solve', 'constraint.solve')]

  def counters(self):
    return {'rows_reset': int(self.rows_reset)}

  def release(self):
    """Keeps what the check reads: the start and the last step."""
    self.state = self.metrics = self.benv = None
    gc.collect()
    if self.device.type == 'cuda':
      torch.cuda.empty_cache()

  def _reference(self, done, dtype):
    """The reference's last step from its inputs, in `dtype`; done: the
    rows it resets (None: its own)."""
    (state_in, actions, gen_state, metrics_in), _ = self.last
    _, benv = stepping.build(self.ctx.cell.config, self.batch, self.device,
                             dtype)
    return stepping.step_call(
        benv, convert.to_reference(state_in, dtype),
        convert.cast(actions, dtype), gen_state,
        convert.to_reference(metrics_in, dtype), done)

  def _start(self, dtype):
    """The reference's first states and goals from the run's seed."""
    _, benv = stepping.build(self.ctx.cell.config, self.batch, self.device,
                             dtype)
    state, _ = benv.reset(torch.Generator().manual_seed(self.reset_seed))
    return state.data.qpos, state.task.goal

  def numbers(self):
    """The numbers that decide `correct` (reference.stepping), and the
    rows of the checked step whose next state is not finite."""
    nums = stepping.start_gaps(self.start, self._start(torch.float64))
    prog = self.last[1]
    ref = self._reference(prog[1].step_type == stepping.LAST, torch.float64)
    nums.update(stepping.compare(prog, ref, stepping.LAST))
    return nums, int((~torch.isfinite(prog[0].data.qpos).all(-1)).sum())

  def control_numbers(self, tf32=True):
    """The control: the reference in float32 (TF32 products with tf32) in
    the program's place on the last step's inputs, judged as the program
    is."""
    with precision.TF32Products() if tf32 else contextlib.nullcontext():
      start = self._start(torch.float32)
      ctrl = self._reference(None, torch.float32)
    nums = stepping.start_gaps(start, self._start(torch.float64))
    ref = self._reference(ctrl[1].step_type == stepping.LAST, torch.float64)
    nums.update(stepping.compare(ctrl, ref, stepping.LAST))
    return nums


def setup(ctx):
  return Suite(ctx)
