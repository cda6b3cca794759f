"""Gridded path vs naive O(N^2) path (SURVEY.md §4.3): where cell capacity
suffices, the grid must find exactly the same neighbor sets, so densities and
trajectories must agree to float tolerance.
"""

import numpy as np
import pytest

from gpufluidsimulator_tpu import scenes, run
from gpufluidsimulator_tpu.models import solver
from gpufluidsimulator_tpu.ops import naive, gridded, physics


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1e-9)


@pytest.mark.parametrize("dim,n", [(2, 1200), (3, 1500)])
def test_density_matches_naive(dim, n):
    params, state = scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=7)
    rho_n = naive.density_naive(state.pos, params)
    _, _, rho_g, _, overflow = gridded.step_gridded(
        state.pos, state.vel, params)
    assert int(overflow) == 0
    assert _rel(rho_g, rho_n) < 1e-5


@pytest.mark.parametrize("dim", [2, 3])
def test_step_matches_naive(dim):
    params, state = scenes.dam_break(n=1000, dim=dim, jitter=0.3, seed=8)
    sn = solver.step(state, params, method="naive")
    sg = solver.step(state, params, method="gridded")
    assert _rel(sg.pos, sn.pos) < 1e-6
    assert _rel(sg.vel, sn.vel) < 1e-5
    assert _rel(sg.rho, sn.rho) < 1e-5


def test_trajectory_matches_naive_100_steps():
    # lattice (no-jitter) scene: orderly regime, so op-order f32 noise is not
    # chaos-amplified and the two paths must track each other tightly
    params, state = scenes.dam_break(n=600, dim=2)
    sn = run(state, params, 100, method="naive")
    sg = run(state, params, 100, method="gridded")
    assert _rel(sg.pos, sn.pos) < 1e-4
    assert int(sg.overflow) == 0


def test_obstacle_scene_matches_naive():
    params, state = scenes.double_dam_break(n=1200, dim=2)
    sn = run(state, params, 50, method="naive")
    sg = run(state, params, 50, method="gridded")
    assert _rel(sg.pos, sn.pos) < 1e-4


def test_gridded_handles_compression_without_overflow():
    """Dam break compresses cells beyond rest occupancy — default K must
    absorb it over a long run."""
    params, state = scenes.dam_break(n=1000, dim=2)
    sg = run(state, params, 150, method="gridded")
    assert int(sg.overflow) == 0
    assert np.all(np.isfinite(np.asarray(sg.pos)))


def test_gridded_anisotropic_cells_match_naive():
    """Per-axis binning cells (SimParams.cell_aniso): a finer-than-h x cell
    widens the x stencil to ceil(h/cell_x) offsets and must find exactly
    the same neighbor sets as the naive path.  (The pallas planes tier
    rejects cell_x < h by design — docs/ARCHITECTURE.md, occupancy.)"""
    from gpufluidsimulator_tpu.ops import planes as pm

    params, state = scenes.dam_break(n=1000, dim=2, jitter=0.3, seed=3)
    dx = pm.lattice_dx(params)
    pa = params.replace(cell_aniso=(dx, 2 * dx))
    assert pa.x_halfwidth == 2
    # density = the neighbor sets themselves: must match naive to fp noise
    rho_n = naive.density_naive(state.pos, params)
    _, _, rho_g, _, overflow = gridded.step_gridded(
        state.pos, state.vel, pa)
    assert int(overflow) == 0
    assert _rel(rho_g, rho_n) < 1e-5
    # short trajectory (the different stencil changes fp summation order,
    # so long runs diverge at the chaos rate — see docs/ARCHITECTURE.md, chaos bound)
    sn = run(state, params, 30, method="naive")
    sg = run(state, pa, 30, method="gridded")
    assert _rel(sg.pos, sn.pos) < 1e-4
    assert int(sg.overflow) == 0


def test_planes_tier_rejects_fine_x_cells():
    from gpufluidsimulator_tpu.ops import planes as pm

    params, _ = scenes.dam_break(n=500, dim=2)
    dx = pm.lattice_dx(params)
    pa = params.replace(cell_aniso=(dx, 2 * dx))
    with pytest.raises(ValueError, match="halfwidth"):
        pm.geometry(pa)
