"""The roofline's operations and bytes against hand counts."""

import pytest

from harness import roofline


def test_cholesky_work_hand_counts():
  # b = 2 matrices of n = 3 in float32: a triangle is 6 numbers (24 B a
  # matrix, 48 for two), a vector 3 (24 B for two).
  assert roofline.cholesky_work(2, 3, 4, 'solve_factor') == (
      48 + 24 + 24 + 48, 2 * 2 * (9 + 9))
  assert roofline.cholesky_work(2, 3, 4, 'resolve') == (48 + 24 + 24,
                                                        2 * 2 * 9)
  assert roofline.cholesky_work(2, 3, 4, 'solve') == (48 + 24 + 24,
                                                      2 * 2 * (9 + 9))
  assert roofline.cholesky_work(2, 3, 8, 'factor') == (96 + 96, 2 * 2 * 9)


def test_bytes_bind_at_the_planner_shape():
  # (16384, 30, 30) float32: 465 + 30 + 30 + 465 numbers a matrix.
  nbytes, flops = roofline.cholesky_work(16384, 30, 4, 'solve_factor')
  assert nbytes == 16384 * 990 * 4
  assert flops == 2 * 16384 * (9000 + 900)
  s, bound = roofline.least_s(nbytes, flops, 4)
  assert bound == 'bytes' and s == pytest.approx(nbytes / 3.35e12)


def test_newton_launches():
  assert roofline.newton_launches(4, 2) == (2, 2)
  assert roofline.newton_launches(5, 2) == (3, 2)
  assert roofline.newton_launches(8, 1) == (8, 0)


def test_planner_call_counts_120_factors_and_120_resolves():
  # 32 streams x 256 samples: 8,192 rows in each CEM iteration.
  plan = {'model': {'nv': 30}, 'plan_substeps': 3, 'solver_iterations': 4,
          'solver_refactor_every': 2}
  traffic = {'streams': 32, 'samples': 256, 'iterations': 2, 'horizon': 10}
  k1 = roofline.least_s(*roofline.cholesky_work(8192, 30, 4, 'solve_factor'),
                        4)[0]
  k2 = roofline.least_s(*roofline.cholesky_work(8192, 30, 4, 'resolve'),
                        4)[0]
  assert roofline.planner_cholesky_s(plan, traffic) == pytest.approx(
      120 * (k1 + k2))


def test_env_step_counts_nine_solves_a_substep():
  env = {'model': {'nv': 62}, 'n_substeps': 1, 'solver_iterations': 8,
         'solver_refactor_every': 1, 'implicit_damping': False}
  k3 = roofline.least_s(*roofline.cholesky_work(16384, 62, 4, 'solve'),
                        4)[0]
  assert roofline.env_step_cholesky_s(env, 16384) == pytest.approx(9 * k3)
