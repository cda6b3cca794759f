"""Config-1 acceptance: the jitted f32 naive path vs the float64 NumPy oracle
(SURVEY.md §4.3; BASELINE.json north_star: trajectories within 1e-3 relative
error over 1000 steps — run at reduced step count in CI, full in slow mode).
"""

import numpy as np
import pytest

from gpufluidsimulator_tpu import scenes, run, make_state
from gpufluidsimulator_tpu.models import solver
from gpufluidsimulator_tpu.oracle import numpy_ref


def _rel_err(a, b):
    scale = np.maximum(np.abs(b).max(), 1e-9)
    return np.abs(a - b).max() / scale


@pytest.mark.parametrize("dim", [2, 3])
def test_single_step_matches_oracle(dim):
    params, state = scenes.dam_break(n=256 if dim == 2 else 512, dim=dim,
                                     jitter=0.2, seed=1)
    p0 = np.asarray(state.pos, np.float64)
    v0 = np.asarray(state.vel, np.float64)
    op, ov, orho, opres = numpy_ref.step(p0, v0, params)
    st = solver.step(state, params, method="naive")
    assert _rel_err(np.asarray(st.rho), orho) < 1e-5
    assert _rel_err(np.asarray(st.pos), op) < 1e-5
    assert _rel_err(np.asarray(st.vel), ov) < 1e-4


def test_trajectory_matches_oracle_200_steps():
    """Lattice (no-jitter) dam break: the orderly collapse regime where f32
    rounding noise is not chaos-amplified; 200 steps must track the float64
    oracle far inside the 1e-3 acceptance band."""
    params, state = scenes.dam_break(n=400, dim=2)
    p, v = np.asarray(state.pos, np.float64), np.asarray(state.vel, np.float64)
    p, v, _, _ = numpy_ref.run(p, v, params, 200)
    st = run(state, params, 200, method="naive")
    # displacement-scale relative error (positions are O(1))
    assert _rel_err(np.asarray(st.pos), p) < 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("method", ["pallas_inc", "pallas_inc_cont"])
def test_full_cfl_1000_steps_statistical_acceptance(method):
    """FULL-dt 1000-step acceptance for the headline pipeline: per-particle
    trajectories are fp-theoretically
    unrecoverable at full CFL (chaos bound below), but DISTRIBUTION-level
    observables are not — the attractor is stable even when particle
    identity scrambles.  This compares pallas_inc against the float64 C++
    oracle on binned density fields, center of mass, and kinetic energy
    at 4 checkpoints, with tolerances SELF-CALIBRATED from the oracle's
    own 1-f32-ulp self-divergence (the envelope any f32 path lives in —
    scripts/chaos_bound.py methodology, run inline here on the same
    scene): accept within 8x the ulp envelope (+ small absolute floors
    for zero-envelope early checkpoints).

    Parametrized over the summation-density pipeline AND the round-4
    continuity-density tier — its adoption gate.
    """
    from gpufluidsimulator_tpu.oracle import native
    if not native.available():
        pytest.skip("native fluidcore not built")

    params, state = scenes.dam_break(n=4096, dim=2)     # FULL CFL dt
    n = state.n
    lo = np.asarray(params.bounds_min)
    hi = np.asarray(params.bounds_max)

    def observables(pos, vel):
        hist, _, _ = np.histogram2d(
            pos[:, 0], pos[:, 1], bins=20,
            range=[[lo[0], hi[0]], [lo[1], hi[1]]])
        return (hist / n,
                pos.mean(axis=0),
                0.5 * params.particle_mass * float((vel ** 2).sum()))

    def diffs(oa, ob):
        tv = 0.5 * np.abs(oa[0] - ob[0]).sum()          # total variation
        com = np.abs(oa[1] - ob[1]).max()
        ke = abs(oa[2] - ob[2]) / max(abs(ob[2]), 1e-12)
        return np.asarray([tv, com, ke])

    p0 = np.asarray(state.pos, np.float64)
    v0 = np.zeros_like(p0)
    # 1-ulp perturbed twin: round to f32, take one ulp step, back to f64 —
    # the smallest initial difference any f32 implementation could avoid
    pf = np.float32(p0)
    p0u = np.asarray(np.nextafter(pf, np.float32(2.0) * hi.max()),
                     np.float64)

    checkpoints = [250, 250, 250, 250]                  # cumulative 1000
    pa, va = p0.copy(), v0.copy()
    pb, vb = p0u.copy(), v0.copy()
    st = state
    step_no = 0
    for k in checkpoints:
        pa, va, _, _ = native.run(pa, va, params, k)
        pb, vb, _, _ = native.run(pb, vb, params, k)
        st = run(st, params, k, method=method)
        step_no += k
        oa = observables(pa, va)
        envelope = diffs(observables(pb, vb), oa)
        got = diffs(observables(np.asarray(st.pos, np.float64),
                                np.asarray(st.vel, np.float64)), oa)
        floors = np.asarray([0.02, 2e-3, 0.05])
        tol = np.maximum(8.0 * envelope, floors)
        assert (got <= tol).all(), (
            f"step {step_no}: [tv, com, ke_rel] diff {got} exceeds "
            f"8x ulp-envelope {envelope} (floors {floors})")
        assert int(st.overflow) == 0
    # the run must have actually evolved: the column's center of mass has
    # fallen (at 4k/full-CFL, 1000 steps is ~0.1 s of sim time — the dam
    # slumps vertically; the front reaches the far wall much later)
    assert np.asarray(st.pos)[:, 1].mean() < p0[:, 1].mean() - 0.02


@pytest.mark.slow
@pytest.mark.parametrize("method,bound", [("pallas", 1e-3),
                                          ("pallas_inc_cont", 1e-2)])
def test_trajectory_matches_oracle_1000_steps(method, bound):
    """Config-1 acceptance (BASELINE.json north_star): <=1e-3 relative error
    over 1000 steps vs the CPU float64 O(N^2) reference, full 4k scene,
    exercising the production pallas path.

    The continuity tier (round 4) is held to a LOOSER 1e-2 bound here: its
    density evolution is an O(dt)-different (deferred-correction) WCSPH
    formulation, measured at 4.8e-3 @1000 steps dt/2 — ~23x the f64
    oracle's own 1-ulp self-divergence envelope at dt/2 (2.1e-4), so
    per-particle 1e-3 parity is a summation-tier guarantee; the tier's
    formal acceptance is the full-CFL STATISTICAL test above, which it
    passes at every checkpoint (docs/ARCHITECTURE.md, continuity tier).

    Run at half the CFL dt because at full CFL the acceptance bound is
    FLOATING-POINT-THEORETICALLY unreachable, independent of
    implementation: perturbing the float64 oracle's OWN initial positions
    by one f32 ulp (1.2e-7) and re-running the identical float64 engine
    crosses 1e-3 at step 550 and ends at 1.6e-2 by step 1000 (dam-impact
    Lyapunov growth, lambda = 0.024/step, e-fold 42 steps — measured
    curves: scripts/chaos_bound.py, committed docs/chaos_bound.json,
    docs/ARCHITECTURE.md, chaos bound).  Any f32 implementation differs from the
    f64 oracle by >= 1 ulp somewhere, so NO f32 path (ours or the
    reference CUDA one) can meet 1e-3@1000 in that regime.  At dt/2 the
    same 1-ulp perturbation stays at 2.1e-4 and our f32 path measures
    4.9e-5 — 20x inside the band.  Uses the native C++ oracle
    (csrc/fluidcore) when built: the NumPy O(N^2) path needs >1h at
    4k x 1000.
    """
    params, state = scenes.dam_break(n=4096, dim=2)
    params = params.replace(dt=params.dt * 0.5)
    p = np.asarray(state.pos, np.float64)
    v = np.asarray(state.vel, np.float64)
    from gpufluidsimulator_tpu.oracle import native
    if native.available():
        p, v, _, _ = native.run(p, v, params, 1000, use_grid=False)
    else:
        p, v, _, _ = numpy_ref.run(p, v, params, 1000)
    st = run(state, params, 1000, method=method)
    order = np.argsort(np.asarray(st.ids))
    err = _rel_err(np.asarray(st.pos)[order], p)
    assert err < bound, (
        f"rel_err {err:.2e} at dt/2 (full-CFL acceptance is fp-impossible:"
        " a 1-ulp f64-oracle self-perturbation exceeds 1e-3 by step 550 —"
        " docs/chaos_bound.json)")
    assert int(st.overflow) == 0
