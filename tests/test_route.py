"""Placement of particles into rank planes (ops/planes.build_planes) and
extraction of per-particle values back out of them (planes.gather_slots):
every particle lands in exactly one slot of its own cell, and reading a
plane at the particle's slot returns what was placed there."""

import jax.numpy as jnp
import numpy as np
import pytest

from gpufluidsimulator_tpu import scenes
from gpufluidsimulator_tpu.ops import planes as pm


def _setup(n=1500, dim=2, seed=11):
    params, state = scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=seed)
    geom = pm.geometry(params)
    table = pm.build_planes(state.pos, state.vel, state.ids, params, geom,
                            with_ids=True)
    return params, state, geom, table


@pytest.mark.parametrize("dim", [2, 3])
def test_place_puts_each_particle_in_its_cell(dim):
    """Each placed slot holds its particle's position, velocity and id,
    at the particle's own cell."""
    params, state, geom, table = _setup(dim=dim, n=1200)
    ok = np.asarray(table.ok)
    slot = np.asarray(table.slot)[ok]
    flat = np.asarray(table.planes).reshape(table.planes.shape[0], -1)
    np.testing.assert_array_equal(flat[:dim, slot].T,
                                  np.asarray(table.pos_s)[ok])
    np.testing.assert_array_equal(flat[3:3 + dim, slot].T,
                                  np.asarray(table.vel_s)[ok])
    np.testing.assert_array_equal(flat[6, slot],
                                  np.asarray(table.ids_s)[ok])
    cid = np.asarray(pm.cell_linear_parts(table.pos_s, params, geom))[ok]
    np.testing.assert_array_equal(slot % geom.cells, cid)


def test_extract_kernel_inverts_place():
    """place -> extract round trip through the plain path: gathering any
    value stack at the particles' slots returns the per-slot values."""
    params, state, geom, table = _setup()
    vals = jnp.stack([table.planes[0] * 2.0, table.planes[1] + 1.0,
                      table.planes[3] * 0.5 + 3.0])
    out = np.asarray(pm.gather_slots(vals, table.slot, table.ok, -7.0))
    okm = np.asarray(table.ok)
    pos = np.asarray(table.pos_s)
    vel = np.asarray(table.vel_s)
    np.testing.assert_allclose(out[okm, 0], 2.0 * pos[okm, 0], rtol=0,
                               atol=0)
    np.testing.assert_allclose(out[okm, 1], pos[okm, 1] + 1.0, rtol=0,
                               atol=0)
    np.testing.assert_allclose(out[okm, 2], vel[okm, 0] * 0.5 + 3.0, rtol=0,
                               atol=0)
    assert (out[~okm] == -7.0).all()


def test_place_fills_every_particle_once():
    params, state, geom, table = _setup(n=2500, seed=4)
    px = np.asarray(table.planes[pm.FIELD_X])
    filled = px < pm.SENTINEL * 0.5
    assert filled.sum() == int(np.asarray(table.ok).sum()) == state.n
    ids = np.asarray(table.planes[6])[filled].astype(int)
    assert np.array_equal(np.sort(ids), np.arange(state.n))
    # empty slots carry the empty-slot fills
    assert (np.asarray(table.planes[6])[~filled] == -1.0).all()
    assert (np.asarray(table.planes[3])[~filled] == 0.0).all()


def test_place_drops_rank_overflow():
    """Cells holding more than K particles keep K of them; the rest are
    counted, not placed, and never overwrite another slot."""
    params, state, geom, table = _setup(n=2000, seed=6)
    params = params.replace(cell_capacity=1)
    geom = pm.geometry(params)
    t = pm.build_planes(state.pos, state.vel, state.ids, params, geom)
    ok = np.asarray(t.ok)
    filled = np.asarray(t.planes[pm.FIELD_X]) < pm.SENTINEL * 0.5
    assert filled.sum() == ok.sum()
    assert int(t.overflow) == state.n - ok.sum() > 0


def test_slots_unique_and_ranks_dense():
    """Slots of placed particles are unique (the scatter never collides)
    and ranks are dense within each cell."""
    params, state, geom, table = _setup(n=3000, seed=9)
    slot = np.asarray(table.slot)[np.asarray(table.ok)]
    assert np.unique(slot).size == slot.size
    rank, cell = slot // geom.cells, slot % geom.cells
    for c in np.unique(cell)[:200]:
        assert sorted(rank[cell == c]) == list(range((cell == c).sum()))
