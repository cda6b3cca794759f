"""One-command benchmark sweep over the five BASELINE.json configs.

Emits one JSON object per config (and a summary array), each naming the
device it ran on:

    python scripts/bench_configs.py [--out bench_configs.json] [--quick]

Config 5 (4M particles) runs here on the first device only; the row records
the single-device rate and the device count (the sharded run is
``python chip_smoke.py --four``).  Timing: ms per step on the flow after
100 warm-up steps, fenced with block_until_ready (utils/profiling).
"""

from __future__ import annotations

import argparse
import json
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpufluidsimulator_tpu.utils.cache import enable as _enable_cache
_enable_cache()


CONFIGS = [
    # (name, scene, n, dim, method)
    ("1: 2D dam-break 4k naive O(N^2)", "dam_break", 4096, 2, "naive"),
    ("2: 2D dam-break 65k uniform grid", "dam_break", 65536, 2, "pallas_inc"),
    ("3: 3D dam-break 262k rank planes", "dam_break", 262144, 3,
     "pallas_inc"),
    ("4: 3D double dam-break 1M fused scan", "double_dam_break",
     1_000_000, 3, "pallas_inc"),
    ("5: 3D 4M sharded + halo exchange", "double_dam_break",
     4_000_000, 3, "pallas_inc"),
]


def bench_one(name, scene, n, dim, method, warm, k1, k2):
    import jax
    from gpufluidsimulator_tpu import scenes
    from gpufluidsimulator_tpu.models import solver
    from gpufluidsimulator_tpu.utils.profiling import step_time

    params, state = scenes.SCENES[scene](n=n, dim=dim)
    params = params.replace(diagnostics=False)
    if method != "naive":
        state = solver.run(state, params, warm, method="pallas")
        jax.block_until_ready(state.pos)
    if method == "pallas_inc":
        from gpufluidsimulator_tpu.ops import inc
        from gpufluidsimulator_tpu.ops import planes as pm
        geom = pm.geometry(params)
        m_cap = inc.mover_capacity(state.n)
        s0 = inc.to_planes(state.pos, state.vel, state.ids, params, geom)
        t = step_time(lambda s: inc.step_planes(s, params, geom, m_cap),
                      s0, k=k2 - k1)
    else:
        fn = solver._METHODS[method]
        t = step_time(lambda s: fn(s, params), state, k=k2 - k1)
    dev = jax.devices()[0]
    return {
        "config": name, "scene": scene, "n": state.n, "dim": dim,
        "method": method, "platform": dev.platform,
        "device_kind": dev.device_kind, "devices": jax.device_count(),
        "ms_per_frame": t * 1e3,
        "particle_steps_per_sec": state.n / t,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="bench_configs.json")
    ap.add_argument("--quick", action="store_true",
                    help="shorter warmup and timing window (noisier)")
    ap.add_argument("--configs", default="1,2,3,4,5",
                    help="comma-separated config numbers to run")
    args = ap.parse_args()
    warm = 30 if args.quick else 100
    k1, k2 = (2, 6) if args.quick else (2, 12)
    want = {int(s) for s in args.configs.split(",")}

    rows = []
    for i, cfg in enumerate(CONFIGS, start=1):
        if i not in want:
            continue
        row = bench_one(*cfg, warm=warm, k1=k1, k2=k2)
        rows.append(row)
        print(json.dumps(row))
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
