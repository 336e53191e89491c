"""The port's sampling-based pair pruning against the JAX package, on the
CPU in float64: the per-pair distance statistics over the same joint
draws, and the dropped-pair set, for a small capsule-finger model and
for the Adroit hand.
"""

import numpy as np
import pytest
import torch

from dexterity_tpu.mjcf import parser as jparser
from dexterity_tpu.mjcf import prune as jprune
from dexterity_tpu.models import hands as jhands
from dexterity_tpu_torch.mjcf import parser as pparser
from dexterity_tpu_torch.mjcf import prune as pprune
from dexterity_tpu_torch.models import hands as phands

F64 = dict(device='cpu', dtype=torch.float64)

# Two two-link fingers and a thumb on a palm, and a post far off to the
# side.  The first links overlap the palm at every pose (a primitive-fit
# artifact in miniature), the post is never near anything, and each
# finger's second link comes within a few mm of the other's first.
FINGERS_XML = """
<mujoco model="fingers">
  <compiler angle="radian"/>
  <worldbody>
    <body name="palm" pos="0 0 0.1">
      <geom name="palm" type="box" size="0.04 0.01 0.03" mass="0.2"/>
      <body name="f1a" pos="-0.01 0 0.04">
        <joint name="f1a" axis="1 0 0" range="-0.2 1.2"/>
        <geom name="f1a" type="capsule" fromto="0 0 0 0 0 0.03"
              size="0.012" mass="0.02"/>
        <body name="f1b" pos="0 0 0.035">
          <joint name="f1b" axis="1 0 0" range="0 1.5"/>
          <geom name="f1b" type="capsule" fromto="0 0 0 0 0 0.025"
                size="0.007" mass="0.01"/>
        </body>
      </body>
      <body name="f2a" pos="0.01 0 0.04">
        <joint name="f2a" axis="1 0 0" range="-0.2 1.2"/>
        <geom name="f2a" type="capsule" fromto="0 0 0 0 0 0.03"
              size="0.012" mass="0.02"/>
        <body name="f2b" pos="0 0 0.035">
          <joint name="f2b" axis="1 0 0" range="0 1.5"/>
          <geom name="f2b" type="capsule" fromto="0 0 0 0 0 0.025"
                size="0.007" mass="0.01"/>
        </body>
      </body>
      <body name="thumb" pos="0 0.03 0.0">
        <joint name="thumb" axis="0 1 0"/>
        <geom name="thumb" type="capsule" fromto="0 0 0 0 0.02 0.06"
              size="0.008" mass="0.02"/>
      </body>
      <body name="post" pos="0.3 0 0">
        <geom name="post" type="sphere" size="0.02" mass="0.05"/>
      </body>
    </body>
  </worldbody>
  <contact>
    <pair geom1="f1a" geom2="f2a"/>
  </contact>
</mujoco>
"""

_SAMPLES = {'fingers': 64, 'adroit': 16}


def _specs(name):
  if name == 'fingers':
    return (jparser.load_mjcf_string(FINGERS_XML),
            pparser.load_mjcf_string(FINGERS_XML))
  return jhands.AdroitHand().spec, phands.AdroitHand().spec


@pytest.fixture(scope='module', params=sorted(_SAMPLES))
def case(request):
  """JAX's statistics (one compile per model) and the port's."""
  name = request.param
  jspec, pspec = _specs(name)
  n = _SAMPLES[name]
  jstats = jprune.pair_distance_stats(jspec.compile(), num_samples=n, seed=3)
  pm = pspec.compile(**F64)
  pstats = pprune.pair_distance_stats(pm, num_samples=n, seed=3)
  return dict(name=name, n=n, jspec=jspec, pspec=pspec, pm=pm,
              jstats=jstats, pstats=pstats)


def test_pair_distance_stats_match_jax(case):
  names = ('min', 'd0', 'frac', 'median')
  for name, got, want in zip(names, case['pstats'], case['jstats']):
    want = np.asarray(want)
    assert got.dtype == np.float64 and got.shape == (case['pm'].npair,)
    if name == 'frac':
      np.testing.assert_array_equal(got, want)
    else:
      np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                 err_msg=name)


def test_prune_spec_pairs_matches_jax(case, monkeypatch):
  """The dropped set from the same statistics: JAX's classification on
  its own statistics (its pair_distance_stats returns the fixture's, so
  nothing compiles again) against the port's full prune_spec_pairs."""
  jspec, pspec = case['jspec'], case['pspec']
  before = set(pspec.pruned_pairs)
  assert before == set(jspec.pruned_pairs)
  monkeypatch.setattr(jprune, 'pair_distance_stats',
                      lambda model, num_samples, seed: case['jstats'])
  jprune.prune_spec_pairs(jspec, num_samples=case['n'], seed=3)
  pprune.prune_spec_pairs(pspec, num_samples=case['n'], seed=3, **F64)
  assert pspec.pruned_pairs == jspec.pruned_pairs
  if case['name'] == 'fingers':
    dropped, n_far, n_artifact = pprune.dropped_pairs(
        case['pm'], case['pstats'], {('f1a', 'f2a')})
    # Every branch ran: far pairs, an overlap artifact, kept pairs, and
    # the explicit pair kept although it always overlaps.
    assert n_far >= 1 and n_artifact >= 1
    assert len(dropped) < case['pm'].npair - 1
    assert ('f1a', 'f2a') not in dropped
    assert ('f1a', 'post') in dropped                    # far
    assert ('f1a', 'palm') in dropped                    # always overlaps
    assert ('f1a', 'f2b') not in dropped                 # meets at times


def test_pruning_runs_on_a_card_unless_asked(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  spec = pparser.load_mjcf_string(FINGERS_XML)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    pprune.prune_spec_pairs(spec, num_samples=4)
  pprune.prune_spec_pairs(spec, num_samples=4, device='cpu')
  assert spec.pruned_pairs
