"""Benchmark: config 4 of BASELINE.json on one GPU; prints ONE JSON line.

3D double dam break with obstacle boundaries, 1,197,770 particles, on the
production (planes-resident) pipeline, at two operating points — 100 warm
steps (early: few particles change cell) and 2000 (evolved: the dam has
broken and ~1-2% change cell per step) — for both density tiers:
``pallas_inc`` (summation density) and ``pallas_inc_cont`` (continuity
density).  Each rate is ms per ``inc.step_planes`` step over a 50-step scan,
fenced with ``block_until_ready``, best of 3, beside the card's name and
power limit.  Needs a GPU: exits non-zero on any other backend.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WARM = (100, 2000)
STEPS = 50


def main() -> int:
    import jax
    if jax.default_backend() != "gpu":
        print(f"bench.py: needs a GPU; JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    from gpufluidsimulator_tpu.utils.cache import enable
    enable()
    import jax.numpy as jnp
    from gpufluidsimulator_tpu import scenes
    from gpufluidsimulator_tpu.ops import inc, pallas_sph
    from gpufluidsimulator_tpu.ops import planes as pm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    params, state = scenes.double_dam_break(n=1_000_000, dim=3)
    params = params.replace(diagnostics=False)
    geom = pm.geometry(params)
    m_cap = inc.mover_capacity(state.n)
    roll = jax.jit(lambda s: jax.lax.scan(
        lambda c, _: (inc.step_planes(c, params, geom, m_cap), None),
        s, None, length=STEPS)[0])

    def ms_per_step(st, continuity):
        s0 = inc.to_planes(st.pos, st.vel, st.ids, params, geom,
                           continuity=continuity)
        if continuity:
            # steady state: rho filled, off the age-0 seeding step
            p6 = pm.halo_x(s0.fields6)
            s0 = s0._replace(
                rhop=pallas_sph.density_planes(p6[:3], params, geom),
                age=jnp.int32(1))
        out = jax.block_until_ready(roll(s0))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = jax.block_until_ready(roll(s0))
            best = min(best, (time.perf_counter() - t0) / STEPS)
        if int(out.overflow) != 0:
            raise RuntimeError(f"overflow {int(out.overflow)}")
        return best * 1e3

    points = {}
    done = 0
    for warm in WARM:
        state = inc.run_inc(state, params, warm - done)
        jax.block_until_ready(state.pos)
        done = warm
        for tier, cont in (("pallas_inc", False), ("pallas_inc_cont", True)):
            ms = ms_per_step(state, cont)
            points[f"{tier}@{warm}"] = {
                "warm_steps": warm, "ms_per_step": ms,
                "particle_steps_per_s": state.n / ms * 1e3}
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "particle-steps/s, config 4 (1.2M 3D double dam break)",
        "value": points["pallas_inc@2000"]["particle_steps_per_s"],
        "unit": "particle-steps/s",
        "n": state.n, "operating_points": points, "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
