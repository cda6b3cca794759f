"""On-card test tier: the compiled GPU path against the plain references.

Run on the card with
``FLUID_TEST_DEVICE=gpu python -m pytest tests/test_gpu.py -m gpu -q``
(chip_smoke.py runs it inside its own process, as its last phase).  Every
test takes the ``gpu`` fixture, so here on the CPU they skip.  Small N.

Tolerances: the sweeps contain no matrix product, so TF32 never enters;
kernel and plain version differ only in summation order and fused
multiply-add, which bounds density differences at a few f32 ulps of the
sum (~1e-3 absolute at rho ~ 1e3) and one step's position differences at
~1e-6 domain units.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpufluidsimulator_tpu import scenes
from gpufluidsimulator_tpu.models import solver
from gpufluidsimulator_tpu.ops import inc, kernels, pallas_sph, render
from gpufluidsimulator_tpu.ops import planes as pm

pytestmark = pytest.mark.gpu


def _evolved(n=2000, dim=2, steps=300):
    params, state = scenes.dam_break(n=n, dim=dim)
    st = solver.run(state, params, steps, method="pallas_inc")
    return params, st


def _planes_state(params, st, continuity=False):
    geom = pm.geometry(params)
    s = inc.to_planes(st.pos, st.vel, st.ids, params, geom,
                      continuity=continuity)
    return geom, s


def test_pallas_step_matches_gridded_on_chip(gpu):
    """The rank-plane step (Triton sweeps) vs the gridded XLA tier — one
    step from an evolved state, aligned by id."""
    params, st = _evolved()
    a = solver.step(st, params, method="pallas")
    b = solver.step(st, params, method="gridded")
    ai = np.argsort(np.asarray(a.ids))
    bi = np.argsort(np.asarray(b.ids))
    np.testing.assert_allclose(np.asarray(a.pos)[ai],
                               np.asarray(b.pos)[bi], rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(a.vel)[ai],
                               np.asarray(b.vel)[bi], rtol=0, atol=2e-2)


@pytest.mark.parametrize("variant", ["density", "force", "fused",
                                     "cont_rate", "cont_sum"])
@pytest.mark.parametrize("dim", [2, 3])
def test_sweep_kernel_matches_plain_on_chip(gpu, variant, dim):
    """The compiled Triton sweeps vs the plain version on the card, on the
    occupied interior slots of an evolved state."""
    params, st = _evolved(n=2000 if dim == 2 else 3000, dim=dim,
                          steps=100)
    if variant.startswith("cont_"):
        params = params.replace(cont_form=variant[5:])
    geom, s = _planes_state(params, st)
    p6 = pm.halo_x(s.fields6)
    valid = np.asarray((p6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    rho = {i: pallas_sph.density_planes(p6[:3], params, geom, impl=i)
           for i in ("plain", "triton")}
    if variant == "density":
        np.testing.assert_allclose(
            np.asarray(rho["triton"])[valid], np.asarray(rho["plain"])[valid],
            rtol=0, atol=1e-3 * params.rest_density)
        return
    kw = dict(fuse_integrate=variant != "force",
              emit_movers=variant != "force",
              continuity=variant.startswith("cont_"))
    rh = pm.halo_x(rho["plain"])
    a, b = (pallas_sph.accel_planes(p6, rh, params, geom, impl=i, **kw)
            for i in ("plain", "triton"))
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if kw["emit_movers"]:
        # mover flags: a slot whose new position sits on a cell face may
        # round to either side; allow one such slot in a thousand
        fa, fb = np.asarray(a[-1])[valid], np.asarray(b[-1])[valid]
        assert (fa != fb).mean() <= 1e-3
        a, b = a[:-1], b[:-1]
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        if x.ndim == 6:
            x, y = x[:, valid], y[:, valid]
        else:
            x, y = x[valid], y[valid]
        np.testing.assert_allclose(y, x, rtol=1e-4,
                                   atol=1e-3 * max(np.abs(x).max(), 1.0))


def test_continuity_drho_matches_n2_on_chip(gpu):
    """The compiled RATE-form continuity accumulation vs an O(N^2) f64
    reference for the density rate."""
    params, st = _evolved(n=1200, steps=200)
    params = params.replace(cont_form="rate")
    geom, s = _planes_state(params, st, continuity=True)
    p6 = pm.halo_x(s.fields6)
    rho_h = pm.halo_x(pallas_sph.density_planes(p6[:3], params, geom))
    new6, rho_new, flagp = pallas_sph.accel_planes(
        p6, rho_h, params, geom, fuse_integrate=True, emit_movers=True,
        continuity=True)
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
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(drho_k, ref, rtol=0, atol=5e-6 * scale)


def test_continuity_sum_rho_matches_density_sweep_on_chip(gpu):
    """The compiled sum-form in-sweep summation density must match the
    standalone density sweep over the same planes."""
    params, st = _evolved(n=1200, steps=200)
    params = params.replace(cont_form="sum")
    geom, s = _planes_state(params, st, continuity=True)
    p6 = pm.halo_x(s.fields6)
    rho_p = pallas_sph.density_planes(p6[:3], params, geom)
    rho_h = pm.halo_x(rho_p)
    new6, rho_new, flagp = pallas_sph.accel_planes(
        p6, rho_h, params, geom, fuse_integrate=True, emit_movers=True,
        continuity=True)
    valid = np.asarray((s.fields6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    np.testing.assert_allclose(np.asarray(rho_new)[valid],
                               np.asarray(rho_p)[valid],
                               rtol=0, atol=2e-3 * params.rest_density)


def test_place_extract_roundtrip_on_chip(gpu):
    """Scatter placement + slot gather on the card: per-particle values out
    of the planes equal what was placed."""
    params, st = _evolved()
    geom = pm.geometry(params)
    table = pm.build_planes(st.pos, st.vel, st.ids, params, geom)
    vals = pm.gather_slots(table.planes[:3], table.slot, table.ok, 0.0)
    ok = np.asarray(table.ok)
    np.testing.assert_array_equal(
        np.asarray(vals)[ok][:, :params.dim],
        np.asarray(table.pos_s)[ok])


def test_run_inc_cont_stable_on_chip(gpu):
    """The continuity tier's stabilized step survives 600 compiled steps of
    the coarse dam break with zero overflow and finite state."""
    params, state = scenes.dam_break(n=2000, dim=2)
    st = solver.run(state, params, 600, method="pallas_inc_cont")
    assert int(st.overflow) == 0
    assert bool(jnp.all(jnp.isfinite(st.pos)))


@pytest.mark.parametrize("dim", [2, 3])
def test_render_frame_matches_cpu_on_chip(gpu, dim):
    """The sha256 goldens of test_render.py hold on the CPU only: on the
    card the splat's scatter-add order is not deterministic.  Here the same
    state is rendered on the card and on the CPU, and the tone-mapped
    frames may differ by at most 2 of 255 levels per channel."""
    params, state = scenes.dam_break(n=1500, dim=dim)
    kw = dict(width=256, height=256)
    card = render.tonemap(render.render_frame(state, params, **kw))
    with jax.default_device(jax.devices("cpu")[0]):
        st_cpu = jax.device_put(state, jax.devices("cpu")[0])
        host = render.tonemap(render.render_frame(st_cpu, params, **kw))
    diff = np.abs(card.astype(int) - host.astype(int))
    assert diff.max() <= 2, diff.max()
