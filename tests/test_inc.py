"""Incremental-binning path (ops/inc.py): mover detection, flagged
compaction, mover re-insertion/consolidation, the fused
force+integrate sweep, and full-step equivalence with the full-rebuild
pallas path (SURVEY.md §4.3 oracle strategy applied to the new tier)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpufluidsimulator_tpu import scenes
from gpufluidsimulator_tpu.models import solver
from gpufluidsimulator_tpu.ops import inc, physics
from gpufluidsimulator_tpu.ops import planes as pm

pytestmark = pytest.mark.heavy   # multi-step integration tier


def _scene(n=700, dim=2, seed=3, jitter=0.3):
    return scenes.dam_break(n=n, dim=dim, jitter=jitter, seed=seed)


def _cell_id_sets(fields6, idp, geom):
    """{cell: frozenset(ids)} from a plane stack (interior slots only)."""
    valid = np.asarray((fields6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    ids = np.asarray(idp)
    out = {}
    k = valid.shape[0]
    flat_v = valid.reshape(k, -1)
    flat_i = ids.reshape(k, -1)
    for c in np.nonzero(flat_v.any(axis=0))[0]:
        out[int(c)] = frozenset(int(flat_i[r, c]) for r in range(k)
                                if flat_v[r, c])
    return out


def test_fresh_state_has_no_movers():
    params, state = _scene()
    geom = pm.geometry(params)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom)
    _, _, flags = inc.detect_movers(s.fields6, s.idp, params, geom)
    assert int(jnp.sum(flags)) == 0
    assert int(s.overflow) == 0


@pytest.mark.parametrize("density", [0.003, 0.3, 1.0])
def test_compact_flagged_every_flag_once(density):
    """Every flagged slot's values come out exactly once, in slot order,
    with the count; the columns past the count are zero."""
    params, state = _scene(n=500)
    geom = pm.geometry(params)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom)
    rng = np.random.default_rng(0)
    valid = np.asarray((s.fields6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    flags = valid & (rng.random(valid.shape) < density)
    cap = state.n + 128
    vals, m = inc.compact_flagged([s.fields6, s.idp], jnp.asarray(flags),
                                  cap)
    m = int(m)
    assert m == int(flags.sum())
    vals = np.asarray(vals)
    want = np.concatenate([np.asarray(s.fields6)[:, flags],
                           np.asarray(s.idp)[flags][None]], axis=0)
    np.testing.assert_array_equal(vals[:, :m], want)
    assert (vals[:, m:] == 0.0).all()
    assert sorted(vals[6, :m].astype(int)) == sorted(
        np.asarray(s.idp)[flags].astype(int))


def test_compact_flagged_grouped_equals_split():
    """A grouped (6, ...) channel stack and the same channels passed one by
    one give identical rows."""
    params, state = _scene(n=500)
    geom = pm.geometry(params)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom)
    valid = np.asarray((s.fields6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    flags = jnp.asarray(valid & (np.random.default_rng(7).random(
        valid.shape) < 0.1))
    cap = inc.mover_capacity(state.n)
    a, ma = inc.compact_flagged([s.fields6, s.idp], flags, cap)
    b, mb = inc.compact_flagged([s.fields6[i] for i in range(6)] + [s.idp],
                                flags, cap)
    assert int(ma) == int(mb)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_compact_flagged_caps_at_max_out():
    """More flags than capacity: the count saturates at max_out (the step
    charges the excess to overflow) and the kept rows are the first ones
    in slot order."""
    params, state = _scene(n=500)
    geom = pm.geometry(params)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom)
    valid = (s.fields6[0] < pm.SENTINEL * 0.5) & inc.interior_mask(geom)[None]
    vals, m = inc.compact_flagged([s.idp], valid, 128)
    assert int(m) == 128
    want = np.asarray(s.idp)[np.asarray(valid)][:128]
    np.testing.assert_array_equal(np.asarray(vals)[0], want)


def _movers_one_per_cell(params, geom, m, max_out, seed=11):
    rng = np.random.default_rng(seed)
    sel = rng.choice(geom.nx * geom.ny, size=m, replace=False)
    mv = np.zeros((7, max_out), np.float32)
    mv[0, :m] = (sel % geom.nx + 0.5) * params.cells_axis[0]
    mv[1, :m] = (sel // geom.nx + 0.5) * params.cells_axis[1]
    mv[3:6, :m] = rng.normal(size=(3, m)).astype(np.float32)
    mv[6, :m] = np.arange(m, dtype=np.float32)
    return mv


@pytest.mark.parametrize("m", [37, 500, 2000])
def test_consolidate_places_every_live_mover(m):
    """Movers arriving into empty planes land once each, in their own
    cell, at rank 0; dead columns are ignored."""
    params, _ = scenes.dam_break(n=10000, dim=2)
    geom = pm.geometry(params)
    max_out = 4096
    mv = _movers_one_per_cell(params, geom, m, max_out)
    empty6 = jnp.concatenate([
        jnp.full((3,) + (geom.k, geom.pz, geom.n_bx, geom.py, pm.LANES),
                 pm.SENTINEL, jnp.float32),
        jnp.zeros((3, geom.k, geom.pz, geom.n_bx, geom.py, pm.LANES),
                  jnp.float32)])
    idp = jnp.full(empty6.shape[1:], -1.0, jnp.float32)
    live = jnp.arange(max_out) < m
    f6, idp_o, lost = inc.consolidate(
        empty6, idp, jnp.zeros_like(idp), jnp.asarray(mv), live, params,
        geom)
    assert int(lost) == 0
    valid = np.asarray(f6[0] < pm.SENTINEL * 0.5)
    assert valid.sum() == m and valid[1:].sum() == 0
    ids = np.asarray(idp_o)[valid].astype(int)
    np.testing.assert_array_equal(np.sort(ids), np.arange(m))
    cid = np.asarray(pm.cell_linear_parts(
        jnp.asarray(mv[:2, :m].T), params, geom))
    slot_of = {int(i): int(c) for i, c in zip(
        np.asarray(idp_o).reshape(geom.k, -1)[0][valid[0].reshape(-1)],
        np.nonzero(valid[0].reshape(-1))[0])}
    assert all(slot_of[j] == cid[j] for j in range(m))


def test_incremental_rebin_matches_full_rebuild():
    """Perturb positions, rebin incrementally, compare per-cell id sets with
    a from-scratch build_planes of the same positions."""
    params, state = _scene(n=900, dim=2)
    geom = pm.geometry(params)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom)

    # push particles by up to ~0.7 cells so a healthy fraction change cell
    rng = np.random.default_rng(1)
    delta = (rng.random(np.asarray(state.pos).shape) - 0.5) * 1.4 * params.cell
    new_pos = jnp.clip(jnp.asarray(np.asarray(state.pos) + delta, jnp.float32),
                       jnp.asarray(params.bounds_min, jnp.float32),
                       jnp.asarray(params.bounds_max, jnp.float32))

    # write the perturbed positions into the plane state (slot-aligned):
    # extract ids per slot, look up each slot's new position by id
    ids_slot = np.asarray(s.idp).astype(np.int64)
    valid = np.asarray((s.fields6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    f6 = np.asarray(s.fields6).copy()
    npos = np.asarray(new_pos)
    for d in range(params.dim):
        ch = f6[d]
        ch[valid] = npos[ids_slot[valid].astype(int), d]
        f6[d] = ch
    s2 = inc.IncState(fields6=jnp.asarray(f6), idp=s.idp,
                      overflow=s.overflow, mig_overflow=s.mig_overflow)

    _, _, flags = inc.detect_movers(s2.fields6, s2.idp, params, geom)
    n_moved = int(jnp.sum(flags))
    assert n_moved > 20, "perturbation should move a real fraction"
    channels = [s2.fields6[i] for i in range(6)] + [s2.idp]
    movers, m = inc.compact_flagged(channels, flags,
                                    inc.mover_capacity(state.n))
    assert int(m) == n_moved
    flagp = flags.astype(jnp.float32)
    live = jnp.arange(movers.shape[1]) < m
    fields6, idp, lost = inc.consolidate(s2.fields6, s2.idp, flagp, movers,
                                         live, params, geom)
    assert int(lost) == 0

    ref = pm.build_planes(new_pos, state.vel, state.ids, params, geom,
                          with_ids=True)
    got = _cell_id_sets(fields6, idp, geom)
    want = _cell_id_sets(ref.planes[:6], ref.planes[6], geom)
    assert got == want


def test_fused_integrate_matches_separate():
    params, state = _scene(n=800, dim=2)
    params = params.replace(obstacles=(("box", (0.5, 0.2), (0.1, 0.1)),))
    geom = pm.geometry(params)
    from gpufluidsimulator_tpu.ops.pallas_sph import (accel_planes,
                                                      density_planes)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom)
    planes6 = pm.halo_x(s.fields6)
    rho = pm.halo_x(density_planes(planes6[:3], params, geom))
    acc = accel_planes(planes6, rho, params, geom)
    fused = accel_planes(planes6, rho, params, geom, fuse_integrate=True)

    valid = np.asarray((planes6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    grav = np.asarray(params.gravity + (0.0,) * (3 - params.dim))
    pos_p = np.stack([np.asarray(planes6[d]) for d in range(params.dim)], -1)
    vel_p = np.stack([np.asarray(planes6[3 + d])
                      for d in range(params.dim)], -1)
    acc_p = np.stack([np.asarray(acc[d]) for d in range(params.dim)], -1)
    p_ref, v_ref = physics.integrate(
        jnp.asarray(pos_p.reshape(-1, params.dim)),
        jnp.asarray(vel_p.reshape(-1, params.dim)),
        jnp.asarray(acc_p.reshape(-1, params.dim))
        + jnp.asarray(grav[:params.dim]), params)
    p_ref = np.asarray(p_ref).reshape(pos_p.shape)
    v_ref = np.asarray(v_ref).reshape(vel_p.shape)
    for d in range(params.dim):
        np.testing.assert_allclose(np.asarray(fused[d])[valid],
                                   p_ref[..., d][valid], atol=1e-6)
        np.testing.assert_allclose(np.asarray(fused[3 + d])[valid],
                                   v_ref[..., d][valid], atol=1e-6)
    # empty interior slots stay sentinel
    empty = np.asarray(~valid & inc.interior_mask(geom)[None].repeat(
        geom.k, axis=0))
    assert np.all(np.asarray(fused[0])[empty] >= pm.SENTINEL * 0.5)


@pytest.mark.parametrize("dim", [2, 3])
def test_emit_movers_matches_detect(dim):
    """The force sweep's fused mover flagging (emit_movers) must agree
    with the standalone detect_movers pass applied to the plain fused
    output: identical post-step planes on interior slots, identical mover
    flag set, and extract_movers pulls exactly the flagged ids/values."""
    from gpufluidsimulator_tpu.ops.pallas_sph import (accel_planes,
                                                      density_planes)
    params, state = _scene(n=800 if dim == 2 else 1000, dim=dim)
    geom = pm.geometry(params)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom)
    planes6 = pm.halo_x(s.fields6)
    rho = pm.halo_x(density_planes(planes6[:3], params, geom))
    fused = accel_planes(planes6, rho, params, geom, fuse_integrate=True)
    new6, flagp = accel_planes(planes6, rho, params, geom,
                               fuse_integrate=True, emit_movers=True)
    _, _, flags = inc.detect_movers(fused, s.idp, params, geom)
    assert int(jnp.sum(flags)) > 5, "scene should produce some movers"

    im = np.broadcast_to(np.asarray(inc.interior_mask(geom))[None],
                         np.asarray(fused[0]).shape)
    # post-step planes match the plain fused output on interior
    for ch in range(6):
        np.testing.assert_array_equal(np.asarray(new6[ch])[im],
                                      np.asarray(fused[ch])[im])
    # flag plane matches the standalone detection on interior slots
    np.testing.assert_array_equal(
        np.asarray(flagp > 0.5)[im], np.asarray(flags)[im])

    movers, m, tot = inc.extract_movers(new6, s.idp, flagp, geom,
                                        inc.mover_capacity(state.n))
    n_flag = int(jnp.sum(flags))
    assert int(m) == int(tot) == n_flag
    mv = np.asarray(movers)[:, :n_flag]
    got = set(mv[6].astype(int))
    want = set(np.asarray(s.idp)[np.asarray(flags)].astype(int))
    assert got == want
    # extracted coordinates are the post-step values of the flagged slots
    fl = np.asarray(flags)
    by_id = {}
    ids_fl = np.asarray(s.idp)[fl].astype(int)
    for ch in range(6):
        v = np.asarray(fused[ch])[fl]
        for a, b in zip(ids_fl, v):
            by_id.setdefault(int(a), []).append(float(b))
    for j in range(n_flag):
        pid = int(mv[6, j])
        for ch in range(6):
            assert by_id[pid][ch] == float(mv[ch, j])


@pytest.mark.parametrize("dim", [2, 3])
def test_consolidate_keeps_every_particle(dim):
    """Flag a random 15% of the particles as movers without moving them:
    consolidation must put every particle back (same per-cell id sets),
    with dense ranks and nothing dropped."""
    params, state = _scene(n=700 if dim == 2 else 900, dim=dim)
    geom = pm.geometry(params)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom)
    rng = np.random.default_rng(7)
    valid = np.asarray((s.fields6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    flags = jnp.asarray(valid & (rng.random(valid.shape) < 0.15))
    flagp = flags.astype(jnp.float32)
    movers, m = inc.compact_flagged([s.fields6, s.idp], flags,
                                    inc.mover_capacity(state.n))
    live = jnp.arange(movers.shape[1]) < m
    f6, idp, lost = inc.consolidate(s.fields6, s.idp, flagp, movers, live,
                                    params, geom)
    assert int(lost) == 0
    assert _cell_id_sets(f6, idp, geom) == _cell_id_sets(s.fields6, s.idp,
                                                         geom)
    v = np.asarray(f6[0] < pm.SENTINEL * 0.5)
    # dense ranks: an occupied rank never sits above an empty one
    assert not (v[1:] & ~v[:-1]).any()


@pytest.mark.parametrize("dim,n,steps", [(2, 900, 30), (3, 1200, 12)])
def test_run_inc_matches_pallas(dim, n, steps):
    params, state = _scene(n=n, dim=dim)
    ref = solver.run(state, params, steps, method="pallas")
    got = solver.run(state, params, steps, method="pallas_inc")
    assert int(got.overflow) == 0
    assert not bool(jnp.any(jnp.isnan(got.pos)))
    # align by particle identity (both paths permute rows)
    ri = np.argsort(np.asarray(ref.ids))
    gi = np.argsort(np.asarray(got.ids))
    np.testing.assert_allclose(np.asarray(got.pos)[gi],
                               np.asarray(ref.pos)[ri],
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(np.asarray(got.vel)[gi],
                               np.asarray(ref.vel)[ri],
                               rtol=0, atol=5e-3)


def test_run_inc_via_facade():
    from gpufluidsimulator_tpu import FluidSim
    params, state = _scene(n=600, dim=2)
    sim = FluidSim(params, state, method="pallas_inc")
    sim.step(5)
    p = sim.get_positions()
    assert np.isfinite(p).all()
    assert int(sim.state.overflow) == 0


def test_rollout_inc_records_frames_in_scan():
    """rollout(method='pallas_inc') records frames inside the resident scan
    (inc.rollout_inc): the final state matches run_inc and the last frame
    is the final position set (aligned by the recorded id channel)."""
    params, state = _scene(n=700, dim=2)
    params = params.replace(diagnostics=False)
    final, traj = solver.rollout(state, params, 12, method="pallas_inc",
                                 record_every=4)
    assert traj.shape == (3, state.n, 2)
    ref = inc.run_inc(state, params, 12)
    fi = np.argsort(np.asarray(final.ids))
    ri = np.argsort(np.asarray(ref.ids))
    np.testing.assert_allclose(np.asarray(final.pos)[fi],
                               np.asarray(ref.pos)[ri], rtol=0, atol=1e-6)
    # last frame = the same particle set as the final state (set-valued)
    lf = np.sort(np.asarray(traj[-1]), axis=0)
    fp = np.sort(np.asarray(final.pos), axis=0)
    np.testing.assert_allclose(lf, fp, rtol=0, atol=1e-6)
    # intermediate frame matches a shorter run of the same pipeline
    mid = inc.run_inc(state, params, 8)
    mf = np.sort(np.asarray(traj[1]), axis=0)
    mp = np.sort(np.asarray(mid.pos), axis=0)
    np.testing.assert_allclose(mf, mp, rtol=0, atol=1e-6)


def test_run_inc_chunked_matches_single_program():
    """Splitting the rollout into several device programs (run_inc's
    ``chunk``) must be bitwise-identical to one program — same math, same
    plane state."""
    from gpufluidsimulator_tpu.ops import inc
    params, state = _scene(n=700, dim=2)
    one = inc.run_inc(state, params, 9, chunk=9)
    many = inc.run_inc(state, params, 9, chunk=2)
    np.testing.assert_array_equal(np.asarray(one.pos), np.asarray(many.pos))
    np.testing.assert_array_equal(np.asarray(one.vel), np.asarray(many.vel))
    np.testing.assert_array_equal(np.asarray(one.ids), np.asarray(many.ids))


# ---------------------------------------------------------------------------
# continuity-density tier (round 4)
# ---------------------------------------------------------------------------

def test_continuity_first_step_matches_summation():
    """Step 1 of the continuity tier resums (age % RESUM_EVERY == 0), so its
    EOS density is the same summation sweep the standard tier uses — the
    post-step positions/velocities must match pallas_inc exactly."""
    params, state = _scene(n=700, dim=2)
    ref = solver.run(state, params, 1, method="pallas_inc")
    got = solver.run(state, params, 1, method="pallas_inc_cont")
    gi = np.argsort(np.asarray(got.ids))
    ri = np.argsort(np.asarray(ref.ids))
    np.testing.assert_array_equal(np.asarray(got.pos)[gi],
                                  np.asarray(ref.pos)[ri])
    np.testing.assert_array_equal(np.asarray(got.vel)[gi],
                                  np.asarray(ref.vel)[ri])


def test_continuity_drho_matches_n2_reference():
    """The force sweep's fused RATE-form continuity accumulation must
    equal the O(N^2) poly6-gradient rate sum m (vi-vj).gradW to float
    tolerance (cont_form='rate' — the round-4 formulation, kept)."""
    from gpufluidsimulator_tpu.ops import kernels, pallas_sph
    params, state = _scene(n=400, dim=2)
    params = params.replace(cont_form="rate")
    st = solver.run(state, params, 5, method="pallas_inc")  # nonzero vels
    geom = pm.geometry(params)
    s = inc.to_planes(st.pos, st.vel, st.ids, params, geom, continuity=True)
    p6 = pm.halo_x(s.fields6)
    rho_p = pallas_sph.density_planes(p6[:3], params, geom)
    rho_h = pm.halo_x(rho_p)
    new6, rho_new, flagp = pallas_sph.accel_planes(
        p6, rho_h, params, geom, fuse_integrate=True,
        emit_movers=True, continuity=True)
    valid = np.asarray((s.fields6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    ids_slot = np.asarray(s.idp)[valid].astype(int)
    drho_k = (np.asarray(rho_new) - np.asarray(rho_h))[valid] / params.dt

    pos = np.asarray(st.pos, np.float64)
    vel = np.asarray(st.vel, np.float64)
    dd = pos[:, None, :] - pos[None, :, :]
    r2 = (dd ** 2).sum(-1)
    w = np.maximum(params.h ** 2 - r2, 0.0) ** 2
    dv = vel[:, None, :] - vel[None, :, :]
    dot = (dv * dd).sum(-1)
    c = kernels.poly6_coef(params.h, params.dim) * params.particle_mass
    drho_ref = -6.0 * c * (w * dot).sum(axis=1)
    id2row = {int(pid): i for i, pid in enumerate(np.asarray(st.ids))}
    ref = np.array([drho_ref[id2row[i]] for i in ids_slot])
    scale = np.maximum(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(drho_k, ref, rtol=0, atol=2e-6 * scale)


def test_continuity_sum_rho_matches_n2_reference():
    """SUM form (the round-5 default): the force sweep's emitted density
    plane must equal the O(N^2) float64 poly6 summation density R(x) at
    the step's input positions to float tolerance — the in-sweep
    accumulation is the exact density-kernel math riding the force pair
    loop."""
    from gpufluidsimulator_tpu.ops import kernels, pallas_sph
    params, state = _scene(n=400, dim=2)
    params = params.replace(cont_form="sum")
    st = solver.run(state, params, 5, method="pallas_inc")
    geom = pm.geometry(params)
    s = inc.to_planes(st.pos, st.vel, st.ids, params, geom, continuity=True)
    p6 = pm.halo_x(s.fields6)
    rho_p = pallas_sph.density_planes(p6[:3], params, geom)
    rho_h = pm.halo_x(rho_p)
    new6, rho_new, flagp = pallas_sph.accel_planes(
        p6, rho_h, params, geom, fuse_integrate=True,
        emit_movers=True, continuity=True)
    valid = np.asarray((s.fields6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    ids_slot = np.asarray(s.idp)[valid].astype(int)
    rho_k = np.asarray(rho_new)[valid]

    pos = np.asarray(st.pos, np.float64)
    dd = pos[:, None, :] - pos[None, :, :]
    r2 = (dd ** 2).sum(-1)
    w = np.maximum(params.h ** 2 - r2, 0.0) ** 3
    c = kernels.poly6_coef(params.h, params.dim) * params.particle_mass
    rho_ref = c * w.sum(axis=1)
    id2row = {int(pid): i for i, pid in enumerate(np.asarray(st.ids))}
    ref = np.array([rho_ref[id2row[i]] for i in ids_slot])
    np.testing.assert_allclose(rho_k, ref, rtol=0,
                               atol=2e-6 * params.rest_density)
    # and it must match the standalone density sweep on the same planes
    # (same math, different accumulation order)
    rho_sweep = np.asarray(rho_p)[valid]
    np.testing.assert_allclose(rho_k, rho_sweep, rtol=0, atol=2e-3)


def test_continuity_sum_rho_independent_of_carried_drift():
    """SUM form: the emitted density is a pure function of the step's
    input positions — drift injected into the carried rho plane changes
    the step's FORCES (EOS input) but must NOT propagate into the
    emitted density."""
    params, state = _scene(n=700, dim=2)
    params = params.replace(cont_form="sum")
    geom = pm.geometry(params)
    m_cap = inc.mover_capacity(state.n)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom,
                      continuity=True)
    s = inc.step_planes(s, params, geom, m_cap)   # seeds rho (age 0)
    s = inc.step_planes(s, params, geom, m_cap)
    clean = inc.step_planes(s, params, geom, m_cap)
    drifted = inc.step_planes(s._replace(rhop=s.rhop + 37.0), params,
                              geom, m_cap)
    # positions diverge (different EOS pressure this step)...
    assert not np.array_equal(np.asarray(drifted.fields6),
                              np.asarray(clean.fields6))
    # ...but the emitted density, evaluated at the SAME input positions,
    # is identical PER PARTICLE: no drift channel exists in the sum form.
    # (Align by id — the diverged forces can put a particle in different
    # slots/mover paths in the two runs.)
    np.testing.assert_array_equal(
        _rho_by_id(clean, geom), _rho_by_id(drifted, geom))


def _rho_by_id(s, geom):
    """id-indexed carried-rho vector from an IncState (continuity tier)."""
    valid = np.asarray((s.fields6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    ids = np.asarray(s.idp)[valid].astype(np.int64)
    rho = np.asarray(s.rhop)[valid]
    out = np.zeros(int(ids.max()) + 1, np.float32)
    out[ids] = rho
    return out


def test_continuity_relax_matches_n2_reference():
    """RELAX form (the round-5 default): the emitted density must equal
    (1-l)(rho + dt drho_N2) + l R_N2 against the O(N^2) float64
    reference — the kappa_d2 fold puts both terms through one
    accumulator and this pins the algebra."""
    from gpufluidsimulator_tpu.ops import kernels, pallas_sph
    params, state = _scene(n=400, dim=2)
    params = params.replace(cont_form="relax")
    lam = params.cont_relax
    st = solver.run(state, params, 5, method="pallas_inc")
    geom = pm.geometry(params)
    s = inc.to_planes(st.pos, st.vel, st.ids, params, geom, continuity=True)
    # synthetic carried rho (nonzero so the (1-l)*rho_q term is exercised)
    rhop = jnp.where(s.idp >= 0, 900.0 + s.idp % 37, 0.0)
    p6 = pm.halo_x(s.fields6)
    rho_h = pm.halo_x(rhop)
    new6, rho_new, flagp = pallas_sph.accel_planes(
        p6, rho_h, params, geom, fuse_integrate=True,
        emit_movers=True, continuity=True)
    valid = np.asarray((s.fields6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    ids_slot = np.asarray(s.idp)[valid].astype(int)
    rho_k = np.asarray(rho_new)[valid]
    rho_q = np.asarray(rhop)[valid]

    pos = np.asarray(st.pos, np.float64)
    vel = np.asarray(st.vel, np.float64)
    dd = pos[:, None, :] - pos[None, :, :]
    r2 = (dd ** 2).sum(-1)
    d2 = np.maximum(params.h ** 2 - r2, 0.0)
    dot = ((vel[:, None, :] - vel[None, :, :]) * dd).sum(-1)
    c = kernels.poly6_coef(params.h, params.dim) * params.particle_mass
    drho = -6.0 * c * (d2 ** 2 * dot).sum(axis=1)
    rsum = c * (d2 ** 3).sum(axis=1)
    id2row = {int(pid): i for i, pid in enumerate(np.asarray(st.ids))}
    rows = np.array([id2row[i] for i in ids_slot])
    ref = ((1.0 - lam) * (rho_q + params.dt * drho[rows])
           + lam * rsum[rows])
    np.testing.assert_allclose(rho_k, ref, rtol=0,
                               atol=5e-6 * params.rest_density)


def test_continuity_relax_decays_carried_drift():
    """RELAX form: drift injected into the carried rho must decay toward
    the in-sweep summation instead of persisting (the rate form carries
    it until the next resum)."""
    params, state = _scene(n=700, dim=2)
    params = params.replace(cont_form="relax")
    lam = params.cont_relax
    geom = pm.geometry(params)
    m_cap = inc.mover_capacity(state.n)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom,
                      continuity=True)
    s = inc.step_planes(s, params, geom, m_cap)   # seeds rho (age 0)
    s = inc.step_planes(s, params, geom, m_cap)
    clean = inc.step_planes(s, params, geom, m_cap)
    drifted = inc.step_planes(s._replace(rhop=s.rhop + 40.0), params,
                              geom, m_cap)
    # align by id: the diverged forces can put a particle in different
    # slots/mover paths in the two runs
    diff = np.abs(_rho_by_id(drifted, geom) - _rho_by_id(clean, geom))
    # one step decays the injected 40 by (1-lambda); allow slack for the
    # force-feedback difference the drifted EOS causes
    assert diff.max() <= (1.0 - lam) * 40.0 * 1.05 + 1.0, diff.max()


def test_continuity_rho_travels_with_movers():
    """rho is Lagrangian state: when a particle changes cell, its carried
    density must arrive with it (8th mover channel through the mover
    gather, the arrival sort and consolidate)."""
    params, state = _scene(n=900, dim=2)
    geom = pm.geometry(params)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom,
                      continuity=True)
    # synthetic carried rho keyed by particle id
    rho_of = lambda idp: jnp.where(idp >= 0, 1000.0 + idp, 0.0)
    rhop = rho_of(s.idp)

    rng = np.random.default_rng(1)
    delta = (rng.random(np.asarray(state.pos).shape) - 0.5) * 1.4 * params.cell
    new_pos = jnp.clip(
        jnp.asarray(np.asarray(state.pos) + delta, jnp.float32),
        jnp.asarray(params.bounds_min, jnp.float32),
        jnp.asarray(params.bounds_max, jnp.float32))
    ids_slot = np.asarray(s.idp).astype(np.int64)
    valid = np.asarray((s.fields6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    f6 = np.asarray(s.fields6).copy()
    npos = np.asarray(new_pos)
    for d in range(params.dim):
        ch = f6[d]
        ch[valid] = npos[ids_slot[valid].astype(int), d]
        f6[d] = ch
    fields6 = jnp.asarray(f6)

    _, _, flags = inc.detect_movers(fields6, s.idp, params, geom)
    assert int(jnp.sum(flags)) > 20
    flagp = flags.astype(jnp.float32)
    movers, m, tot = inc.extract_movers(fields6, s.idp, flagp, geom,
                                        inc.mover_capacity(state.n),
                                        rhop=rhop)
    assert movers.shape[0] == 8
    mv = np.asarray(movers)[:, :int(m)]
    # rho channel rides with the id channel through the compaction
    np.testing.assert_allclose(mv[7], 1000.0 + mv[6], rtol=0, atol=0)

    live = jnp.arange(movers.shape[1]) < m
    out = inc.consolidate(fields6, s.idp, flagp, movers, live, params, geom,
                          rhop=rhop)
    fields6_o, idp_o, rho_o, lost = out
    assert int(lost) == 0
    valid_o = np.asarray((fields6_o[0] < pm.SENTINEL * 0.5)
                         & inc.interior_mask(geom)[None])
    ids_o = np.asarray(idp_o)[valid_o]
    rho_v = np.asarray(rho_o)[valid_o]
    np.testing.assert_allclose(rho_v, 1000.0 + ids_o, rtol=0, atol=0)


def test_continuity_resummation_resets_drift(monkeypatch):
    """RATE form: with RESUM_EVERY = 4, step 5 (age 4) must resummate —
    its carried-out rho equals a fresh summation + one continuity
    increment, independent of whatever drift accumulated in steps 2-4."""
    params, state = _scene(n=700, dim=2)
    params = params.replace(cont_form="rate")
    geom = pm.geometry(params)
    m_cap = inc.mover_capacity(state.n)
    monkeypatch.setattr(inc, "RESUM_EVERY", 4)
    s = inc.to_planes(state.pos, state.vel, state.ids, params, geom,
                      continuity=True)
    for _ in range(4):
        s = s._replace(rhop=s.rhop + 1.0)   # inject artificial drift
        s = inc.step_planes(s, params, geom, m_cap)
    assert int(s.age) == 4
    # next step resums: drift injected above must NOT propagate
    drifted = inc.step_planes(s._replace(rhop=s.rhop + 123.0), params,
                              geom, m_cap)
    clean = inc.step_planes(s, params, geom, m_cap)
    np.testing.assert_array_equal(np.asarray(drifted.rhop),
                                  np.asarray(clean.rhop))
    np.testing.assert_array_equal(np.asarray(drifted.fields6),
                                  np.asarray(clean.fields6))


def test_run_inc_cont_long_run_stays_sane():
    """30 continuity steps on the jittered dam break: no NaN, no overflow,
    carried rho stays within physical bounds, and the trajectory stays
    within a few h of the summation-density reference (the two forms are
    O(dt)-different formulations, not bitwise twins — the oracle-grade
    acceptance lives in test_naive_vs_oracle)."""
    params, state = _scene(n=700, dim=2)
    ref = solver.run(state, params, 30, method="pallas_inc")
    got = solver.run(state, params, 30, method="pallas_inc_cont")
    assert int(got.overflow) == 0
    assert not bool(jnp.any(jnp.isnan(got.pos)))
    gi = np.argsort(np.asarray(got.ids))
    ri = np.argsort(np.asarray(ref.ids))
    dp = np.abs(np.asarray(got.pos)[gi] - np.asarray(ref.pos)[ri]).max()
    assert dp < 8 * params.h, f"divergence {dp} vs h={params.h}"
