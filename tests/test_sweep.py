"""The neighbour sweeps (ops/pallas_sph): the Triton kernel in interpret mode
vs the plain version, the plain version vs the naive O(N^2) reference, the
kernel's lowering for CUDA, and the choice of implementation.  Also the
compile-cache rule, chip_smoke.py's refusal to run without a GPU, and that
every kept script imports."""

import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from gpufluidsimulator_tpu import scenes
from gpufluidsimulator_tpu.models import solver
from gpufluidsimulator_tpu.ops import inc, naive, pallas_sph as ps
from gpufluidsimulator_tpu.ops import planes as pm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SWEEP_KW = {
    "force": dict(),
    "fused_movers": dict(fuse_integrate=True, emit_movers=True),
    "cont_rate": dict(fuse_integrate=True, emit_movers=True,
                      continuity=True),
    "cont_sum": dict(fuse_integrate=True, emit_movers=True,
                     continuity=True),
}


def _planes(dim, steps=15):
    n = 600 if dim == 2 else 1200
    params, state = scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=11)
    st = solver.run(state, params, steps, method="pallas_inc")
    geom = pm.geometry(params)
    s = inc.to_planes(st.pos, st.vel, st.ids, params, geom)
    p6 = pm.halo_x(s.fields6)
    valid = np.asarray((p6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    return params, st, geom, p6, valid


@pytest.mark.parametrize("dim", [2, 3])
def test_triton_density_matches_plain(dim):
    params, _, geom, p6, valid = _planes(dim)
    a = ps.density_planes(p6[:3], params, geom, impl="plain")
    b = ps.density_planes(p6[:3], params, geom, impl="triton",
                          interpret=True)
    # written slots only: interpret mode leaves unwritten outputs undefined
    np.testing.assert_allclose(np.asarray(b)[valid], np.asarray(a)[valid],
                               rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("variant", list(_SWEEP_KW))
@pytest.mark.parametrize("dim", [2, 3])
def test_triton_force_matches_plain(dim, variant):
    params, _, geom, p6, valid = _planes(dim)
    if variant.startswith("cont_"):
        params = params.replace(cont_form=variant[5:])
    rho = pm.halo_x(ps.density_planes(p6[:3], params, geom, impl="plain"))
    kw = _SWEEP_KW[variant]
    a = ps.accel_planes(p6, rho, params, geom, impl="plain", **kw)
    b = ps.accel_planes(p6, rho, params, geom, impl="triton",
                        interpret=True, rows=2, **kw)
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b) == 1 + int(kw.get("emit_movers", False)) \
        + int(kw.get("continuity", False))
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        x, y = (x[:, valid], y[:, valid]) if x.ndim == 6 else (x[valid],
                                                               y[valid])
        np.testing.assert_allclose(y, x, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(x).max(), 1.0))


@pytest.mark.parametrize("dim", [2, 3])
def test_plain_density_matches_naive(dim):
    """The plain sweep's summation density per particle equals the naive
    all-pairs density (independent of any kernel)."""
    params, st, geom, p6, valid = _planes(dim, steps=5)
    rho = np.asarray(ps.density_planes(p6[:3], params, geom, impl="plain"))
    ids = np.asarray(inc.to_planes(st.pos, st.vel, st.ids, params,
                                   geom).idp)[valid].astype(int)
    rho_n = np.asarray(naive.density_naive(st.pos, params))
    by_id = np.empty_like(rho_n)
    by_id[np.asarray(st.ids)] = rho_n
    np.testing.assert_allclose(rho[valid], by_id[ids], rtol=2e-6, atol=0)


def _lower(fn, *args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))


@pytest.mark.parametrize("variant", ["density", "fused_movers", "cont_rate"])
def test_triton_kernel_lowers_for_cuda(variant):
    """The kernels lower to Triton IR for the GPU (what the card compiles);
    a lowering failure shows up here without a card."""
    params, st, geom, p6, _ = _planes(3, steps=1)
    if variant == "density":
        low = _lower(lambda p: ps.density_planes(p[:3], params, geom,
                                                 impl="triton"), p6)
    else:
        kw = _SWEEP_KW[variant]
        low = _lower(lambda p, r: ps.accel_planes(
            p, r, params, geom, impl="triton", **kw), p6, p6[0])
    assert "triton" in low.as_text()


def test_sweep_impl_from_platform():
    assert ps.sweep_impl("cpu") == "plain"
    assert ps.sweep_impl("gpu") == "triton"
    assert ps.sweep_impl() == "plain"           # the tests run on the CPU


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_sweep_impl_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no SPH sweep"):
        ps.sweep_impl(platform)


def test_occupancy_bounds_cover_every_rank():
    """The Triton grid's per-block bounds (any block height) are at least
    the true per-cell occupancy of the block and of its y-widened slab."""
    params, _, geom, p6, _ = _planes(3, steps=1)
    occ = np.asarray((p6[0] < pm.SENTINEL * 0.5).sum(axis=0))
    for rows in (1, 2, 4, 8):
        occ_q, occ_s = (np.asarray(a) for a in
                        pm.occupancy_bounds(p6, params, geom, rows))
        nyq = occ_q.shape[-1]
        for iy in range(nyq):
            y0 = pm.ROWS_PER_BLOCK + iy * rows
            blk = occ[1:geom.nz + 1, :, y0:y0 + rows].max(axis=(-1, -2))
            assert (occ_q[..., iy] >= blk).all()
            slab = occ[:, :, y0 - 1:y0 + rows + 1].max(axis=(-1, -2))
            for dz in range(3):
                assert (occ_s[..., iy, dz] >= slab[dz:dz + geom.nz]).all()


@pytest.mark.parametrize("set_var", [True, False])
def test_cache_dir_rule(set_var, monkeypatch, tmp_path):
    from gpufluidsimulator_tpu.utils import cache
    if set_var:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_chip_smoke_refuses_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO,
                                                        "chip_smoke.py")],
                          env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("name", [
    "accept_cont", "bench_configs", "bench_sweep", "chaos_bound",
    "mover_stats", "profile_timeline", "soak", "sweep_cont_accept"])
def test_kept_script_imports(name):
    sys.path.insert(0, REPO)
    try:
        mod = importlib.import_module(f"scripts.{name}")
    finally:
        sys.path.remove(REPO)
    assert callable(getattr(mod, "main"))
