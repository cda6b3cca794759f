"""Default-tier sharded smoke slice: every `pytest -q`
run must compile and execute at least one shard_map program with ppermute
ghost exchange + mover migration on the 8-virtual-device CPU mesh.  The
exhaustive sharded equivalence matrix stays in the heavy tier
(tests/test_sharded.py); this is the regression tripwire.
"""

import numpy as np
import pytest

from gpufluidsimulator_tpu import scenes, run
from gpufluidsimulator_tpu.parallel import mesh as meshmod
from gpufluidsimulator_tpu.parallel import sharded


def test_sharded_inc_smoke_2dev():
    """2 devices, ~500 particles, a handful of steps on pallas_inc: the
    trajectory matches the unsharded full-rebuild path, nothing is lost,
    and both capacity counters are clean.  jitter + a dam breaking toward
    the slab boundary exercise ghost-plane exchange and (over enough
    steps in the heavy tier) mover migration; here the ppermute paths
    compile and run every round."""
    params, state = scenes.dam_break(n=500, dim=2, jitter=0.2, seed=3)
    sim = sharded.ShardedSim(params, state, mesh=meshmod.make_mesh(2),
                             method="pallas_inc")
    sim.step(5)
    g = sim.gather()                      # raises if particles were lost
    ref = run(state, params, 5, method="pallas")
    order = np.argsort(np.asarray(ref.ids))
    rp = np.asarray(ref.pos)[order]
    assert np.abs(np.asarray(g.pos) - rp).max() < 1e-5
    assert np.asarray(sim.sstate.overflow).sum() == 0
    assert np.asarray(sim.sstate.mig_overflow).sum() == 0
