"""Sweep implementations on the card: the Triton kernel vs the plain version.

Config 4 of BASELINE.json (3D double dam break, 1,197,770 particles).  At
each operating point (``--warm`` steps of the production pipeline from the
rest lattice) it prints, one JSON line each:

  * parity of the two sweep implementations on the same planes (max abs
    difference over occupied interior slots, per output channel);
  * ms per ``inc.step_planes`` step, end to end with ``block_until_ready``,
    for both density tiers and both implementations, timed in the order
    plain, triton, triton, plain (``--impls``);
  * with ``--tune``, ms per force and density sweep for each Triton launch
    shape in the grid.

Needs a GPU; exits non-zero otherwise.  Run: ``python scripts/bench_sweep.py
[--warm 100 2000] [--steps 50] [--tune]``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--warm", type=int, nargs="+", default=[100, 2000])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--warps", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--impls", nargs="+",
                    default=["plain", "triton", "triton", "plain"],
                    help="timing order of the implementations")
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        print(f"bench_sweep: needs a GPU, JAX found {jax.default_backend()}",
              file=sys.stderr)
        return 2
    from gpufluidsimulator_tpu.utils.cache import enable
    enable()
    import jax.numpy as jnp
    import numpy as np
    from gpufluidsimulator_tpu import scenes
    from gpufluidsimulator_tpu.ops import inc, pallas_sph as ps
    from gpufluidsimulator_tpu.ops import planes as pm

    card = _card()
    dev = jax.devices()[0]
    print(json.dumps({"card": card, "device_kind": dev.device_kind,
                      "jax": jax.__version__}), flush=True)
    params, state = scenes.double_dam_break(n=args.n, dim=3)
    params = params.replace(diagnostics=False)
    geom = pm.geometry(params)
    m_cap = inc.mover_capacity(state.n)
    default_impl = ps.sweep_impl

    def use(impl):
        ps.sweep_impl = lambda platform=None: impl

    def states(st):
        s = inc.to_planes(st.pos, st.vel, st.ids, params, geom)
        p6 = pm.halo_x(s.fields6)
        rho = ps.density_planes(p6[:3], params, geom)
        sc = inc.to_planes(st.pos, st.vel, st.ids, params, geom,
                           continuity=True)._replace(rhop=rho,
                                                     age=jnp.int32(1))
        return s, sc

    def time_steps(s0, impl):
        use(impl)
        f = jax.jit(lambda s: jax.lax.scan(
            lambda c, _: (inc.step_planes(c, params, geom, m_cap), None),
            s, None, length=args.steps)[0])
        t0 = time.perf_counter()
        jax.block_until_ready(f(s0))
        compile_s = time.perf_counter() - t0
        best = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(f(s0))
            best.append((time.perf_counter() - t0) / args.steps * 1e3)
        return min(best), compile_s, int(out.overflow)

    def parity(s):
        p6 = pm.halo_x(s.fields6)
        valid = np.asarray((p6[0] < pm.SENTINEL * 0.5)
                           & inc.interior_mask(geom)[None])
        out = {}
        r = {i: ps.density_planes(p6[:3], params, geom, impl=i)
             for i in ("plain", "triton")}
        out["density"] = float(np.abs(np.asarray(r["plain"])
                                      - np.asarray(r["triton"]))[valid].max())
        rh = pm.halo_x(r["plain"])
        for form in ("rate", "sum"):
            pp = params.replace(cont_form=form)
            a, b = (ps.accel_planes(p6, rh, pp, geom, fuse_integrate=True,
                                    emit_movers=True, continuity=True,
                                    impl=i) for i in ("plain", "triton"))
            for name, x, y in zip(("new6", "rho", "flag"), a, b):
                x, y = np.asarray(x), np.asarray(y)
                d = np.abs(x - y)
                d = d[:, valid] if d.ndim == 6 else d[valid]
                out[f"{form}_{name}"] = float(d.max())
        return out

    def sweep_ms(s, rows, warps, stages):
        p6 = pm.halo_x(s.fields6)
        kw = dict(impl="triton", rows=rows, num_warps=warps,
                  num_stages=stages)
        fd = jax.jit(lambda p: ps.density_planes(p[:3], params, geom, **kw))
        rho = jax.block_until_ready(fd(p6))
        ff = jax.jit(lambda p, r: ps.accel_planes(
            p, r, params, geom, fuse_integrate=True, emit_movers=True,
            **kw))
        jax.block_until_ready(ff(p6, rho))
        res = []
        for fn, a in ((fd, (p6,)), (ff, (p6, rho))):
            t0 = time.perf_counter()
            for _ in range(10):
                jax.block_until_ready(fn(*a))
            res.append((time.perf_counter() - t0) / 10 * 1e3)
        return res

    st = state
    done = 0
    for warm in sorted(args.warm):
        use(default_impl())
        st = inc.run_inc(st, params, warm - done)
        jax.block_until_ready(st.pos)
        done = warm
        s, sc = states(st)
        print(json.dumps({"warm": warm, "overflow": int(st.overflow),
                          "parity": parity(s)}), flush=True)
        if args.tune:
            for rows in args.rows:
                for warps in args.warps:
                    for stages in args.stages:
                        d, f = sweep_ms(s, rows, warps, stages)
                        print(json.dumps({
                            "warm": warm, "rows": rows, "warps": warps,
                            "stages": stages, "density_ms": d,
                            "force_ms": f}), flush=True)
        for tier, s0 in (("pallas_inc", s), ("pallas_inc_cont", sc)):
            for impl in args.impls:
                ms, comp, ovf = time_steps(s0, impl)
                print(json.dumps({
                    "warm": warm, "tier": tier, "impl": impl,
                    "ms_per_step": ms, "particle_steps_per_s":
                        state.n / ms * 1e3,
                    "compile_s": comp, "overflow": ovf, "card": card}),
                      flush=True)
    use(default_impl())
    return 0


if __name__ == "__main__":
    sys.exit(main())
