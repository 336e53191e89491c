"""The card's published peaks and the least time for the Cholesky work a
path needs, counted from the cell's own shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): 3.35 TB/s of HBM, 67 TFLOP/s FP32 and 34 TFLOP/s
FP64 outside the tensor cores.  Bytes: each input read once and each
output written once; a matrix moves one triangle with its diagonal (an
SPD matrix is determined by it, and a packed factor holds nothing else).
Operations: n^3/3 multiply-adds to factor, n^2 to solve against a factor.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}


def least_s(nbytes, flops, elem):
  """(seconds, 'bytes' or 'operations'): the larger of the two bounds."""
  t_bytes = nbytes / PEAK_BYTES_PER_S
  t_ops = flops / PEAK_FLOPS[elem]
  return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations')


def cholesky_work(b, n, elem, kind):
  """(bytes, flops) of one Cholesky launch over b matrices of n x n.

  kind: 'solve_factor' (factor H, solve H x = g, emit the factor),
  'resolve' (solve against a packed factor), 'solve' (factor and solve,
  no factor out), 'factor' (the factor alone)."""
  mat = b * (n * (n + 1) // 2) * elem
  vec = b * n * elem
  if kind == 'solve_factor':
    nbytes, fmas = mat + vec + vec + mat, b * (n ** 3 / 3 + n * n)
  elif kind == 'resolve':
    nbytes, fmas = mat + vec + vec, b * n * n
  elif kind == 'factor':
    nbytes, fmas = mat + mat, b * n ** 3 / 3
  elif kind == 'solve':
    nbytes, fmas = mat + vec + vec, b * (n ** 3 / 3 + n * n)
  else:
    raise ValueError(kind)
  return nbytes, 2 * fmas


def newton_launches(solver_iterations, refactor_every):
  """(factoring launches, re-solving launches) of one constraint solve:
  with refactor_every > 1 the Hessian is factored every refactor_every
  iterations and re-solved against the stale factor in between; with 1
  every iteration factors and solves at once."""
  if refactor_every <= 1:
    return solver_iterations, 0
  factors = -(-solver_iterations // refactor_every)
  return factors, solver_iterations - factors


def planner_cholesky_s(plan, traffic, elem=4):
  """Least seconds of one sampling-planner call's Cholesky work: each CEM
  iteration rolls streams x samples rows through horizon control steps
  of plan_substeps substeps, each with one constraint solve at the
  planning model's nv (implicit damping: no second solve)."""
  rows = traffic['streams'] * traffic['samples']
  substeps = traffic['iterations'] * traffic['horizon'] * plan['plan_substeps']
  factors, resolves = newton_launches(plan['solver_iterations'],
                                      plan['solver_refactor_every'])
  n = plan['model']['nv']
  kind = 'solve_factor' if plan['solver_refactor_every'] > 1 else 'solve'
  total = 0.0
  for k, count in ((kind, factors), ('resolve', resolves)):
    if count:
      nbytes, flops = cholesky_work(rows, n, elem, k)
      total += substeps * count * least_s(nbytes, flops, elem)[0]
  return total


def env_step_cholesky_s(env, batch, elem=4):
  """Least seconds of one environment step's Cholesky work: n_substeps
  substeps, each a constraint solve at refactor 1 (one factor-and-solve
  per Newton iteration) and, without implicit damping, the Euler
  damping solve."""
  per_substep = newton_launches(env['solver_iterations'],
                                env['solver_refactor_every'])[0]
  if not env['implicit_damping']:
    per_substep += 1
  nbytes, flops = cholesky_work(batch, env['model']['nv'], elem, 'solve')
  return env['n_substeps'] * per_substep * least_s(nbytes, flops, elem)[0]
