"""Smoke test of the system on the GPU: the quickest proof that it starts there.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # only the sharded path, on four cards

One card, in order, one line per phase:

  1. device: JAX's devices, device kind and version; the card's name and
     power limit from nvidia-smi; then the cold and warm compile time of
     the 300-step pallas_inc program at config 4;
  2. kernel parity at real width: config 4 of BASELINE.json (3D double dam
     break, 1,197,770 particles) after 300 warm steps; the Triton sweeps vs
     the plain version on the card (density; force with fused integration
     and mover flags; continuity in the rate and sum forms);
  3. the pallas and pallas_inc steps vs the naive O(N^2) reference, at the
     sizes and tolerances of tests/test_pallas_vs_naive.py;
  4. the main path at config 4: solver.run(method="auto") and
     pallas_inc_cont for 300 steps each, FluidSim, the CLI's run and bench;
     zero overflow, finite in-box state, ids a permutation; warm ms/step;
  5. the on-card test tier (tests/test_gpu.py), in this process.

``--four``: ShardedSim (pallas_inc and pallas_inc_cont) over a 4-device
mesh at 4M particles vs a one-card run of the same state, compared by id.

The last line is {"ok": true, "device": {...}}; any failed check raises,
so the script exits non-zero and prints no such line.  It exits non-zero
without a GPU, and when run without the rest of the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_CONFIG4 = 1_000_000            # -> 1,197,770 particles (BASELINE config 4)

# parity tolerances, kernel vs plain version on the same planes: the sweeps
# hold no matrix product (no TF32); the two differ in summation order and
# fused multiply-add only
TOL_POS = 2e-5        # domain units; one step moves ~4e-4 at config 4
TOL_VEL = 2e-2        # m/s: accelerations ~1e4 x ulp-level sum differences
TOL_RHO = 1e-3        # x rest density
TOL_FACE = 1e-5       # mover flags may differ only this close to a face


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def flat_checks(st, params, n, label):
    """overflow 0, finite in-box positions, ids a permutation."""
    import numpy as np
    pos = np.asarray(st.pos)
    lo, hi = np.asarray(params.bounds_min), np.asarray(params.bounds_max)
    check(int(st.overflow) == 0, f"{label}: overflow {int(st.overflow)}")
    check(np.isfinite(pos).all(), f"{label}: non-finite positions")
    check(((pos >= lo - 1e-6) & (pos <= hi + 1e-6)).all(),
          f"{label}: positions outside the box")
    check(np.array_equal(np.sort(np.asarray(st.ids)), np.arange(n)),
          f"{label}: ids are not a permutation")


def phase_parity(params, st):
    import numpy as np
    from gpufluidsimulator_tpu.ops import inc, pallas_sph as ps
    from gpufluidsimulator_tpu.ops import planes as pm

    geom = pm.geometry(params)
    s = inc.to_planes(st.pos, st.vel, st.ids, params, geom)
    p6 = pm.halo_x(s.fields6)
    valid = np.asarray((p6[0] < pm.SENTINEL * 0.5)
                       & inc.interior_mask(geom)[None])
    rest = params.rest_density
    res = {}
    rho = {i: ps.density_planes(p6[:3], params, geom, impl=i)
           for i in ("plain", "triton")}
    res["density"] = float(np.abs(np.asarray(rho["triton"])
                                  - np.asarray(rho["plain"]))[valid].max())
    check(res["density"] <= TOL_RHO * rest, f"density parity {res}")
    rh = pm.halo_x(rho["plain"])
    cases = [("fused", params, dict(fuse_integrate=True, emit_movers=True))]
    for form in ("rate", "sum"):
        cases.append((f"cont_{form}", params.replace(cont_form=form),
                      dict(fuse_integrate=True, emit_movers=True,
                           continuity=True)))
    for name, pp, kw in cases:
        a, b = (ps.accel_planes(p6, rh, pp, geom, impl=i, **kw)
                for i in ("plain", "triton"))
        new_a, new_b = np.asarray(a[0]), np.asarray(b[0])
        flag_a, flag_b = np.asarray(a[-1]), np.asarray(b[-1])
        dpos = np.abs(new_a[:3] - new_b[:3])[:, valid].max()
        dvel = np.abs(new_a[3:] - new_b[3:])[:, valid].max()
        check(dpos <= TOL_POS, f"{name}: positions differ by {dpos}")
        check(dvel <= TOL_VEL, f"{name}: velocities differ by {dvel}")
        # a flag may differ only where the new position sits on a face
        bad = valid & (flag_a != flag_b)
        if bad.any():
            cax = np.asarray(pp.cells_axis)
            lo = np.asarray(pp.bounds_min)
            off = [(new_a[d][bad] - lo[d]) / cax[d] for d in range(3)]
            dist = np.min([np.abs(o - np.round(o)) * cax[d]
                           for d, o in enumerate(off)], axis=0)
            check((dist <= TOL_FACE).all(),
                  f"{name}: {int(bad.sum())} mover flags differ off a face")
        res[name] = {"pos": float(dpos), "vel": float(dvel),
                     "flag_diff": int(bad.sum())}
        if kw.get("continuity"):
            drho = float(np.abs(np.asarray(a[1])
                                - np.asarray(b[1]))[valid].max())
            check(drho <= TOL_RHO * rest, f"{name}: rho differs by {drho}")
            res[name]["rho"] = drho
    return res


def phase_reference():
    """pallas / pallas_inc vs naive at tests/test_pallas_vs_naive.py's
    sizes and tolerances; the reference at highest matmul precision."""
    import jax
    import numpy as np
    from gpufluidsimulator_tpu import run, scenes
    from gpufluidsimulator_tpu.models import solver

    def aligned(s):
        o = np.argsort(np.asarray(s.ids))
        return (np.asarray(s.pos)[o], np.asarray(s.vel)[o],
                np.asarray(s.rho)[o])

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))

    def naive(fn, *a, **k):
        with jax.default_matmul_precision("highest"):
            return fn(*a, **k)

    out = {}
    for dim, n in ((2, 600), (3, 1200)):
        params, state = scenes.dam_break(n=n, dim=dim, jitter=0.3, seed=11)
        pn, vn, rn = aligned(naive(solver.step, state, params,
                                   method="naive"))
        pp, vp, rp = aligned(solver.step(state, params, method="pallas"))
        e = (rel(rp, rn), rel(pp, pn), rel(vp, vn))
        check(e[0] < 1e-5 and e[1] < 1e-6 and e[2] < 1e-4,
              f"pallas step {dim}D vs naive: rel rho/pos/vel {e}")
        out[f"step_{dim}d"] = e
    params, state = scenes.dam_break(n=600, dim=2)
    pn = aligned(naive(run, state, params, 50, method="naive"))[0]
    for m in ("pallas", "pallas_inc"):
        e = rel(aligned(run(state, params, 50, method=m))[0], pn)
        check(e < 1e-5, f"{m} 50 steps vs naive: rel pos {e}")
        out[f"traj50_{m}"] = e
    params, state = scenes.double_dam_break(n=1200, dim=3)
    pn = aligned(naive(run, state, params, 20, method="naive"))[0]
    for m in ("pallas", "pallas_inc"):
        e = rel(aligned(run(state, params, 20, method=m))[0], pn)
        check(e < 1e-5, f"{m} obstacle scene vs naive: rel pos {e}")
        out[f"obstacles_{m}"] = e
    return out


def phase_compile(params, state, steps=300):
    """The 300-step pallas_inc program's first compile in this process
    (cold unless the persistent cache already holds it), then again after
    jax.clear_caches(), when only the persistent cache can serve it."""
    import jax
    from gpufluidsimulator_tpu.ops import inc
    from gpufluidsimulator_tpu.utils import cache

    s_in = inc._inc_convert_in(state.pos, state.vel, state.ids,
                               state.overflow, params, state.n)
    times = []
    for _ in range(2):
        jax.clear_caches()
        t0 = time.perf_counter()
        inc._inc_scan_chunk.lower(s_in, params, steps, state.n).compile()
        times.append(time.perf_counter() - t0)
    return dict(program=f"pallas_inc {steps}-step scan", cold_s=times[0],
                warm_s=times[1], cache_dir=cache.cache_dir())


def phase_main_path(params, state, card):
    import jax
    from gpufluidsimulator_tpu import FluidSim, run
    from gpufluidsimulator_tpu.utils import cli

    steps = 300
    n = state.n
    for method in ("auto", "pallas_inc_cont"):
        st = run(state, params, steps, method=method)       # compiles
        jax.block_until_ready(st.pos)
        t0 = time.perf_counter()
        st = run(state, params, steps, method=method)
        jax.block_until_ready(st.pos)
        ms = (time.perf_counter() - t0) / steps * 1e3
        flat_checks(st, params, n, method)
        say("main_path", method=method, n=n, steps=steps,
            warm_ms_per_step=ms, particle_steps_per_s=n / ms * 1e3,
            overflow=int(st.overflow), card=card)
    sim = FluidSim(params, state)
    sim.step(steps)
    flat_checks(sim.state, params, n, "FluidSim")
    say("main_path", method="FluidSim(auto)", steps=steps, ok=True)
    for argv in (["run", "--scene", "double_dam_break", "-n",
                  str(N_CONFIG4), "--dim", "3", "--steps", str(steps),
                  "--report-every", str(steps)],
                 ["bench", "--scene", "double_dam_break", "-n",
                  str(N_CONFIG4), "--dim", "3", "--method", "pallas_inc"]):
        check(cli.main(argv) == 0, f"cli {argv[0]} failed")
        say("main_path", method=f"cli {argv[0]}", ok=True)


def phase_tests():
    import pytest
    os.environ["FLUID_TEST_DEVICE"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", REPO,
                      os.path.join(REPO, "tests", "test_gpu.py")])
    check(rc == 0, f"on-card test tier failed (pytest rc={int(rc)})")
    return int(rc)


def run_four(card):
    """ShardedSim at 4M particles over 4 devices vs one card, by id."""
    import jax
    import numpy as np
    from gpufluidsimulator_tpu import scenes
    from gpufluidsimulator_tpu.ops import inc
    from gpufluidsimulator_tpu.parallel import mesh as meshmod
    from gpufluidsimulator_tpu.parallel import sharded

    check(jax.device_count() >= 4, f"--four needs 4 devices, JAX sees "
          f"{jax.device_count()}")
    params, state = scenes.double_dam_break(n=4_000_000, dim=3)
    params = params.replace(diagnostics=False)
    mesh = meshmod.make_mesh(4)
    steps = 5
    for method in ("pallas_inc", "pallas_inc_cont"):
        sim = sharded.ShardedSim(params, state, mesh=mesh, method=method)
        devs = [sh.device for sh in sim.sstate.pos.addressable_shards]
        check(len(set(devs)) == 4, f"shards on {devs}")
        for leaf in sim.sstate:
            check(len(leaf.sharding.device_set) == 4,
                  f"a state array sits on {leaf.sharding.device_set}")
        t0 = time.perf_counter()
        sim.step(steps)
        jax.block_until_ready(sim.sstate.pos)
        wall = time.perf_counter() - t0
        mig = int(np.asarray(sim.sstate.mig_overflow).sum())
        check(mig == 0, f"{method}: mig_overflow {mig}")
        g = sim.gather()                  # raises if any id was lost
        check(int(g.overflow) == 0, f"{method}: overflow {int(g.overflow)}")
        check(np.isfinite(np.asarray(g.pos)).all(), f"{method}: non-finite")
        with jax.default_device(jax.devices()[0]):
            one = inc.run_inc(state, params, steps,
                              continuity=method == "pallas_inc_cont")
        o = np.argsort(np.asarray(one.ids))
        dpos = float(np.abs(np.asarray(g.pos)
                            - np.asarray(one.pos)[o]).max())
        dvel = float(np.abs(np.asarray(g.vel)
                            - np.asarray(one.vel)[o]).max())
        check(dpos <= TOL_POS and dvel <= TOL_VEL,
              f"{method}: sharded vs one card pos {dpos} vel {dvel}")
        say("four", method=method, n=state.n, steps=steps,
            wall_s_incl_compile=wall, pos_diff=dpos, vel_diff=dvel,
            tol_pos=TOL_POS, tol_vel=TOL_VEL, card=card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-device sharded path")
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found only "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from gpufluidsimulator_tpu.utils import cache
    except ImportError as e:
        print(f"chip_smoke: the gpufluidsimulator_tpu package is missing "
              f"beside this script ({e})", file=sys.stderr)
        return 3
    cache.enable()
    from gpufluidsimulator_tpu import run, scenes

    dev = jax.devices()[0]
    card = card_line()
    say("device", devices=[str(d) for d in jax.devices()],
        kind=dev.device_kind, jax=jax.__version__)
    print(card, flush=True)
    if args.four:
        run_four(card)
    else:
        params, state = scenes.double_dam_break(n=N_CONFIG4, dim=3)
        params = params.replace(diagnostics=False)
        say("compile", card=card, **phase_compile(params, state))
        st = run(state, params, 300, method="pallas_inc")
        flat_checks(st, params, state.n, "warm-up")
        say("parity", n=state.n, warm_steps=300,
            tol=dict(pos=TOL_POS, vel=TOL_VEL, rho=TOL_RHO * params.
                     rest_density, flag_face=TOL_FACE),
            max_abs_diff=phase_parity(params, st))
        say("reference", rel_err=phase_reference())
        phase_main_path(params, state, card)
        say("tests", pytest_rc=phase_tests())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()) if not args.four else 4}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
