"""Rank-plane path (plain sweeps on the CPU) vs naive O(N^2) path
(SURVEY.md §4.3).

The pallas path returns particles cell-sorted; comparisons re-align by `ids`.
"""

import numpy as np
import pytest

from gpufluidsimulator_tpu import scenes, run, SimParams
from gpufluidsimulator_tpu.models import solver
from gpufluidsimulator_tpu.ops import planes as pm

pytestmark = pytest.mark.heavy   # multi-step integration tier; chip_smoke.py
# repeats these comparisons on the card


def _aligned(state):
    order = np.argsort(np.asarray(state.ids))
    return (np.asarray(state.pos)[order], np.asarray(state.vel)[order],
            np.asarray(state.rho)[order])


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


@pytest.mark.parametrize("dim,n", [(2, 600), (3, 1200)])
def test_step_matches_naive(dim, n):
    params, state = scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=11)
    sn = solver.step(state, params, method="naive")
    sp = solver.step(state, params, method="pallas")
    pn, vn, rn = _aligned(sn)
    pp, vp, rp = _aligned(sp)
    assert int(sp.overflow) == 0
    assert _rel(rp, rn) < 1e-5
    assert _rel(pp, pn) < 1e-6
    assert _rel(vp, vn) < 1e-4


def test_trajectory_matches_naive_50_steps():
    params, state = scenes.dam_break(n=600, dim=2)
    sn = run(state, params, 50, method="naive")
    sp = run(state, params, 50, method="pallas")
    pn, _, _ = _aligned(sn)
    pp, _, _ = _aligned(sp)
    assert _rel(pp, pn) < 1e-5
    assert int(sp.overflow) == 0


def test_obstacle_scene_matches_naive():
    params, state = scenes.double_dam_break(n=1200, dim=3)
    sn = run(state, params, 20, method="naive")
    sp = run(state, params, 20, method="pallas")
    pn, _, _ = _aligned(sn)
    pp, _, _ = _aligned(sp)
    assert _rel(pp, pn) < 1e-5


def test_multi_x_tile_matches_naive():
    """Domain wider than one 126-cell x tile (n_bx > 1): the halo-lane
    exchange must reproduce single-tile physics."""
    params, _ = scenes.dam_break(n=900, dim=2, jitter=0.2, seed=5)
    # widen the domain so the grid needs multiple x tiles, and spawn the
    # fluid straddling the tile boundary (x-cell 126)
    params = params.replace(bounds_min=(0.0, 0.0), bounds_max=(4.0, 1.0))
    geom = pm.geometry(params)
    assert geom.n_bx > 1, f"test needs n_bx>1, got grid {params.grid_res}"
    boundary_x = 126 * params.cell
    state = scenes.spawn_box(
        params, [boundary_x - 0.2, 0.0], [boundary_x + 0.2, 0.25],
        jitter=0.2, seed=5)
    sn = run(state, params, 10, method="naive")
    sp = run(state, params, 10, method="pallas")
    pn, _, _ = _aligned(sn)
    pp, _, _ = _aligned(sp)
    assert _rel(pp, pn) < 1e-5


def test_ids_are_permutation():
    params, state = scenes.dam_break(n=500, dim=2)
    sp = run(state, params, 30, method="pallas")
    ids = np.sort(np.asarray(sp.ids))
    assert np.array_equal(ids, np.arange(state.n))


def test_pallas_occupancy_bounds_conservative():
    """occ_q/occ_s must bound true per-cell occupancy (missing a rank would
    silently drop interactions)."""
    params, state = scenes.dam_break(n=2000, dim=2, jitter=0.4, seed=9)
    geom = pm.geometry(params)
    t = pm.build_planes(state.pos, state.vel, state.ids, params, geom)
    occ_q_j, _ = pm.occupancy_bounds(t.planes, params, geom)
    valid = np.asarray(t.planes[pm.FIELD_X] < pm.SENTINEL * 0.5)
    occ = valid.sum(axis=0)                   # (pz, n_bx, py, 128)
    occ_q = np.asarray(occ_q_j)               # (pz, n_bx, n_by)
    nb = geom.n_by
    blocks = occ[:, :, pm.ROWS_PER_BLOCK:(nb + 1) * pm.ROWS_PER_BLOCK, :]
    blocks = blocks.reshape(occ.shape[0], occ.shape[1], nb,
                            pm.ROWS_PER_BLOCK, pm.LANES)
    true_max = blocks.max(axis=(3, 4))
    assert np.all(occ_q >= true_max)


def test_overflow_drops_observable_and_finite():
    """Force rank >= K overflow (tiny cell capacity): the counter must be
    positive, ids stay a permutation, and every particle — including the
    deterministically dropped ones, whose within-cell order the unstable
    sort #1 assigns arbitrarily and whose sentinel slot keys tie in
    sort #2 — integrates to a finite in-bounds position."""
    params, state = scenes.dam_break(n=800, dim=2, jitter=0.4, seed=3)
    params = params.replace(cell_capacity=1)
    sp = solver.step(state, params, method="pallas")
    assert int(sp.overflow) > 0
    assert np.array_equal(np.sort(np.asarray(sp.ids)), np.arange(state.n))
    pos = np.asarray(sp.pos)
    assert np.isfinite(pos).all()
    assert (pos >= np.asarray(params.bounds_min) - 1e-6).all()
    assert (pos <= np.asarray(params.bounds_max) + 1e-6).all()
    # a second evaluation is bitwise identical (unstable != nondeterministic)
    sp2 = solver.step(state, params, method="pallas")
    assert np.array_equal(np.asarray(sp.pos), np.asarray(sp2.pos))
    assert np.array_equal(np.asarray(sp.ids), np.asarray(sp2.ids))
