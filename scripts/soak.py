"""Long-soak robustness run: 5000 steps @1M 3D double dam break on the
production (planes-resident) pipeline, in chunks of ``chunk`` steps,
recording per-chunk wall rate, live count, overflow and NaN checks into a
JSON file (``soak.json`` / ``soak_cont.json`` in the working directory).

Usage: python scripts/soak.py [N] [steps] [chunk] [cont]
"""

from __future__ import annotations

import json
import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpufluidsimulator_tpu.utils.cache import enable as _enable_cache
_enable_cache()

import jax
import jax.numpy as jnp
import numpy as np

from gpufluidsimulator_tpu import scenes
from gpufluidsimulator_tpu.ops import inc
from gpufluidsimulator_tpu.ops import planes as pm


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 5000
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else 250
    continuity = len(sys.argv) > 4 and sys.argv[4] == "cont"

    params, state = scenes.double_dam_break(n=n, dim=3)
    params = params.replace(diagnostics=False)
    geom = pm.geometry(params)
    m_cap = inc.mover_capacity(state.n)

    s = inc._inc_convert_in(state.pos, state.vel, state.ids,
                            state.overflow, params, state.n,
                            continuity=continuity)

    @jax.jit
    def roll(s):
        def body(s, _):
            return inc.step_planes(s, params, geom, m_cap), None
        return jax.lax.scan(body, s, None, length=chunk)[0]

    @jax.jit
    def check(s):
        valid = (s.fields6[0] < pm.SENTINEL * 0.5) \
            & inc.interior_mask(geom)[None]
        live = jnp.sum(valid)
        finite = jnp.all(jnp.isfinite(
            jnp.where(valid[None], s.fields6, 0.0)))
        vmax = jnp.max(jnp.where(
            valid, jnp.max(jnp.abs(s.fields6[3:6]), axis=0), 0.0))
        return live, finite, vmax

    # warm + compile outside the timed region
    s = roll(s)
    jax.block_until_ready(s.fields6)
    rows = []
    done = chunk
    while done < steps:
        t0 = time.time()
        s = roll(s)
        live, finite, vmax = check(s)
        live = int(live)          # host pull fences the chunk
        dt_wall = time.time() - t0
        rows.append(dict(
            step=done + chunk,
            ms_per_step=1e3 * dt_wall / chunk,
            live=live,
            overflow=int(s.overflow),
            mig_overflow=int(s.mig_overflow),
            finite=bool(finite),
            vmax=float(vmax),
        ))
        print(rows[-1], flush=True)
        done += chunk

    out = dict(
        config=dict(n=state.n, dim=3, scene="double_dam_break",
                    steps=steps, chunk=chunk,
                    method="pallas_inc_cont" if continuity
                    else "pallas_inc",
                    grid=list(params.grid_res)),
        rows=rows,
        summary=dict(
            overflow_final=rows[-1]["overflow"],
            live_final=rows[-1]["live"],
            all_finite=all(r["finite"] for r in rows),
            ms_per_step_median=float(np.median(
                [r["ms_per_step"] for r in rows])),
        ),
    )
    name = "soak_cont.json" if continuity else "soak.json"
    path = os.path.abspath(name)
    dev = jax.devices()[0]
    out["device"] = dict(platform=dev.platform, kind=dev.device_kind,
                         count=jax.device_count())
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}: {out['summary']}")


if __name__ == "__main__":
    main()
