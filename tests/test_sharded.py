"""Distributed tests on the 8-virtual-device CPU mesh (SURVEY.md §4.5):
sharded-vs-unsharded equality, halo-exchange correctness, cross-boundary
migration, conservation of particles, observable capacity counters."""

import numpy as np
import pytest

import jax

from gpufluidsimulator_tpu import scenes, run
from gpufluidsimulator_tpu.parallel import mesh as meshmod
from gpufluidsimulator_tpu.parallel import sharded

pytestmark = pytest.mark.heavy    # multi-step shard_map tier


def _ref_aligned(state, params, steps):
    ref = run(state, params, steps, method="pallas")
    order = np.argsort(np.asarray(ref.ids))
    return np.asarray(ref.pos)[order], np.asarray(ref.vel)[order]


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_matches_single_2d(n_dev):
    params, state = scenes.dam_break(n=1200, dim=2, jitter=0.2, seed=7)
    sim = sharded.ShardedSim(params, state, mesh=meshmod.make_mesh(n_dev))
    sim.step(25)
    g = sim.gather()
    rp, rv = _ref_aligned(state, params, 25)
    assert np.abs(np.asarray(g.pos) - rp).max() < 1e-5
    assert np.asarray(sim.sstate.overflow).sum() == 0
    assert np.asarray(sim.sstate.mig_overflow).sum() == 0


def test_sharded_matches_single_3d():
    params, state = scenes.dam_break(n=2000, dim=3, jitter=0.2, seed=8)
    sim = sharded.ShardedSim(params, state, mesh=meshmod.make_mesh(4))
    sim.step(15)
    g = sim.gather()
    rp, _ = _ref_aligned(state, params, 15)
    assert np.abs(np.asarray(g.pos) - rp).max() < 1e-5


def test_migration_across_boundary():
    """A particle crossing a shard boundary must land on the neighbor shard
    and none may be lost (SURVEY.md §4.5)."""
    import jax.numpy as jnp
    from gpufluidsimulator_tpu.models.state import make_state

    params, _ = scenes.dam_break(n=800, dim=2)
    params = params.replace(gravity=(0.0, 0.0))
    mesh = meshmod.make_mesh(4)
    _, nxl = sharded.local_params(params, 4)
    xb = params.bounds_min[0] + nxl * params.cell      # shard 0/1 boundary
    # one particle heading right across the boundary, one heading left
    v = 0.05 * params.cell / params.dt                 # crosses in ~20 steps
    pos = jnp.asarray([[xb - 0.5 * params.cell, 0.5],
                       [xb + 0.5 * params.cell, 0.3]], jnp.float32)
    vel = jnp.asarray([[v, 0.0], [-v, 0.0]], jnp.float32)
    st = make_state(pos, vel)
    sim = sharded.ShardedSim(params, st, mesh=mesh, n_cap=256, m_cap=16)
    before = [set(np.asarray(sim.sstate.ids)[d].tolist()) for d in range(4)]
    assert 0 in before[0] and 1 in before[1]
    sim.step(30)
    after = [set(np.asarray(sim.sstate.ids)[d].tolist()) for d in range(4)]
    assert 0 in after[1], "rightward particle did not migrate to shard 1"
    assert 1 in after[0], "leftward particle did not migrate to shard 0"
    g = sim.gather()                      # also asserts none were lost
    assert np.isfinite(np.asarray(g.pos)).all()
    assert np.asarray(sim.sstate.mig_overflow).sum() == 0


def test_no_particles_lost_long_run():
    params, state = scenes.double_dam_break(n=1500, dim=2)
    sim = sharded.ShardedSim(params, state, mesh=meshmod.make_mesh(8))
    sim.step(150)
    g = sim.gather()                      # raises if particle count changed
    ids = np.sort(np.asarray(g.ids))
    assert np.array_equal(ids, np.arange(state.n))


def test_ghost_interaction_across_boundary():
    """Two particles straddling a shard boundary within h must repel:
    pressure interaction through the ghost halo."""
    params, state = scenes.dam_break(n=800, dim=2)
    params = params.replace(gravity=(0.0, 0.0))
    mesh = meshmod.make_mesh(4)
    n_dev = 4
    _, nxl = sharded.local_params(params, n_dev)
    xb = params.bounds_min[0] + nxl * params.cell    # shard 0/1 boundary
    eps = 0.2 * params.h
    import jax.numpy as jnp
    from gpufluidsimulator_tpu.models.state import make_state
    pos = jnp.asarray([[xb - eps, 0.5], [xb + eps, 0.5]], jnp.float32)
    st = make_state(pos)
    sim = sharded.ShardedSim(params, st, mesh=mesh, n_cap=256, m_cap=16)
    sim.step(5)
    g = sim.gather()
    p = np.asarray(g.pos)
    gap = abs(p[1, 0] - p[0, 0])
    assert gap > 2 * eps, f"no repulsion through shard boundary: gap={gap}"


def test_single_device_mesh_works():
    params, state = scenes.dam_break(n=600, dim=2)
    sim = sharded.ShardedSim(params, state, mesh=meshmod.make_mesh(1))
    sim.step(10)
    g = sim.gather()
    rp, _ = _ref_aligned(state, params, 10)
    assert np.abs(np.asarray(g.pos) - rp).max() < 1e-6


# ---------------------------------------------------------------------------
# incremental (planes-resident) sharded pipeline — ops/inc.exchange_movers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_inc_matches_single_2d(n_dev):
    """Sharded incremental rollout == single-chip full-rebuild trajectory;
    slab-crossing movers ride ICI (ops/inc.exchange_movers)."""
    params, state = scenes.dam_break(n=1200, dim=2, jitter=0.2, seed=7)
    sim = sharded.ShardedSim(params, state, mesh=meshmod.make_mesh(n_dev),
                             method="pallas_inc")
    sim.step(25)
    g = sim.gather()                      # raises if particles were lost
    rp, _ = _ref_aligned(state, params, 25)
    assert np.abs(np.asarray(g.pos) - rp).max() < 1e-5
    # the two capacity failure modes are independently observable on the
    # inc path too: cell/physics overflow vs mover-buffer misses
    assert np.asarray(sim.sstate.overflow).sum() == 0
    assert np.asarray(sim.sstate.mig_overflow).sum() == 0


def test_sharded_inc_no_particles_lost_long_run():
    """Conservation through many mover exchanges: the edge devices'
    ppermute zero-fill must decode as dead rows, never phantom arrivals."""
    params, state = scenes.double_dam_break(n=1500, dim=2)
    sim = sharded.ShardedSim(params, state, mesh=meshmod.make_mesh(8),
                             method="pallas_inc")
    sim.step(150)
    g = sim.gather()                      # raises if particle count changed
    ids = np.sort(np.asarray(g.ids))
    assert np.array_equal(ids, np.arange(state.n))
    assert np.asarray(sim.sstate.overflow).sum() == 0
    assert np.asarray(sim.sstate.mig_overflow).sum() == 0


def test_sharded_inc_mig_overflow_observable():
    """An undersized ICI mover buffer must surface as mig_overflow while
    leaving the physics ``overflow`` counter untouched — the two capacity
    failure modes are independently observable."""
    import jax.numpy as jnp
    from gpufluidsimulator_tpu.models.state import make_state

    params, _ = scenes.dam_break(n=800, dim=2)
    params = params.replace(gravity=(0.0, 0.0))
    mesh = meshmod.make_mesh(2)
    _, nxl = sharded.local_params(params, 2)
    xb = params.bounds_min[0] + nxl * params.cell      # shard 0/1 boundary
    v = 0.6 * params.cell / params.dt                  # crosses in ~2 steps
    # four rightward crossers in distinct cells vs mig_cap=2: exactly two
    # per step can ship; the rest are dropped and must be counted
    ys = [0.2, 0.35, 0.5, 0.65]
    pos = jnp.asarray([[xb - 0.5 * params.cell, y] for y in ys], jnp.float32)
    vel = jnp.asarray([[v, 0.0]] * 4, jnp.float32)
    st = make_state(pos, vel)
    sstate, _ = sharded.distribute(params, st, mesh, n_cap=256, m_cap=16)
    out = sharded.run_sharded_inc(sstate, params, mesh, n_steps=3,
                                  mig_cap=2)
    mig = int(np.asarray(out.mig_overflow).sum())
    ovf = int(np.asarray(out.overflow).sum())
    assert mig == 2, f"expected 2 migration capacity misses, got {mig}"
    assert ovf == 0, f"physics overflow must stay clean, got {ovf}"


def test_sharded_inc_matches_single_3d():
    """3D sharded-inc end-to-end on a tiny grid; asserts trajectory equality
    with the unsharded full-rebuild path + zero overflow, exercising the
    3D-specific pieces (slab mover flags, z-ghost interaction) integrated."""
    params, state = scenes.dam_break(n=350, dim=3, jitter=0.2, seed=5)
    sim = sharded.ShardedSim(params, state, mesh=meshmod.make_mesh(2),
                             method="pallas_inc")
    sim.step(8)
    g = sim.gather()
    rp, _ = _ref_aligned(state, params, 8)
    assert np.abs(np.asarray(g.pos) - rp).max() < 1e-5
    assert np.asarray(sim.sstate.overflow).sum() == 0


def test_sharded_inc_cont_matches_single_2d():
    """Sharded CONTINUITY tier == single-device pallas_inc_cont trajectory
   : the carried-rho ghost-plane exchange and the
    resum cond under shard_map produce the same physics as the unsharded
    continuity rollout; both capacity counters stay clean."""
    params, state = scenes.dam_break(n=1200, dim=2, jitter=0.2, seed=7)
    sim = sharded.ShardedSim(params, state, mesh=meshmod.make_mesh(2),
                             method="pallas_inc_cont")
    sim.step(25)
    g = sim.gather()                      # raises if particles were lost
    ref = run(state, params, 25, method="pallas_inc_cont")
    order = np.argsort(np.asarray(ref.ids))
    rp = np.asarray(ref.pos)[order]
    assert np.abs(np.asarray(g.pos) - rp).max() < 1e-5
    assert np.asarray(sim.sstate.overflow).sum() == 0
    assert np.asarray(sim.sstate.mig_overflow).sum() == 0


def test_sharded_inc_cont_mover_carries_rho():
    """A slab-crossing mover on the continuity tier ships its carried rho
    as the 8th mover channel over ICI (ops/inc.py nf=8 path): the sharded
    trajectory must keep matching the single-device continuity run through
    the migration, and no particle/capacity loss may occur."""
    import jax.numpy as jnp
    from gpufluidsimulator_tpu.models.state import make_state

    params, state = scenes.dam_break(n=700, dim=2, jitter=0.2, seed=3)
    mesh = meshmod.make_mesh(2)
    _, nxl = sharded.local_params(params, 2)
    xb = params.bounds_min[0] + nxl * params.cell      # shard 0/1 boundary
    v = 0.25 * params.cell / params.dt                 # crosses in ~2 steps
    # two engineered crossers flying above the fluid surface, one per
    # direction (the dryrun's with_crossers pattern); separated in y so
    # they never meet each other's viscosity field (round-5 dryrun find)
    pos = np.asarray(state.pos).copy()
    vel = np.asarray(state.vel).copy()
    pos[0], vel[0] = [xb - 0.4 * params.cell, 0.86], [v, 0.0]
    pos[1], vel[1] = [xb + 0.4 * params.cell, 0.95], [-v, 0.0]
    st = make_state(jnp.asarray(pos, jnp.float32),
                    jnp.asarray(vel, jnp.float32))
    sim = sharded.ShardedSim(params, st, mesh=mesh,
                             method="pallas_inc_cont")
    before = [set(np.asarray(sim.sstate.ids)[d].tolist()) for d in range(2)]
    assert 0 in before[0] and 1 in before[1]
    sim.step(10)
    after = [set(np.asarray(sim.sstate.ids)[d].tolist()) for d in range(2)]
    assert 0 in after[1], "rightward mover did not migrate to shard 1"
    assert 1 in after[0], "leftward mover did not migrate to shard 0"
    g = sim.gather()                      # raises if particles were lost
    ref = run(st, params, 10, method="pallas_inc_cont")
    order = np.argsort(np.asarray(ref.ids))
    rp = np.asarray(ref.pos)[order]
    assert np.abs(np.asarray(g.pos) - rp).max() < 1e-5
    assert np.asarray(sim.sstate.overflow).sum() == 0
    assert np.asarray(sim.sstate.mig_overflow).sum() == 0


def test_sharded_checkpoint_resume_bitwise(tmp_path):
    """save_sharded/load_sharded resume matches an uninterrupted sharded run
    bitwise (no gather round-trip in the snapshot path)."""
    from gpufluidsimulator_tpu.utils import checkpoint

    params, state = scenes.dam_break(n=900, dim=2, jitter=0.2, seed=2)
    mesh = meshmod.make_mesh(4)
    sstate, m_cap = sharded.distribute(params, state, mesh)
    full = sharded.run_sharded(sstate, params, mesh, 20, m_cap)

    half = sharded.run_sharded(sstate, params, mesh, 10, m_cap)
    path = str(tmp_path / "shard.npz")
    checkpoint.save_sharded(path, half, params, step=10, n_total=state.n)
    loaded, p2, step, n_total = checkpoint.load_sharded(path, mesh)
    assert (step, n_total) == (10, state.n)
    assert p2 == params
    resumed = sharded.run_sharded(loaded, p2, mesh, 10, m_cap)
    for a, b in zip(full, resumed):
        assert np.array_equal(np.asarray(a), np.asarray(b))
