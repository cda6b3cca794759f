"""Per-kernel and per-phase device time of the production step on the card.

Warms the flow to an operating point, traces K steps of the planes-resident
pipeline with jax.profiler, then reads the Perfetto trace.json.gz directly:
sums the device-track event durations by kernel name, and by step phase
(the jax.named_scope of ops/inc.step_planes: sph_density, sph_force,
movers, consolidate; kernels outside them are "other"), and prints ms/step
beside the step time measured with the profiler off.  The phase table is
the share of the step each part of the pipeline takes.

Usage: python scripts/profile_timeline.py [N] [warm] [K] [inc|cont] [out]
Writes the summary as JSON to ``out`` (default profile_timeline.json).
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ("sph_density", "sph_force", "movers", "consolidate")


def device_events(trace):
    """(name, dur_us, args) of complete events on accelerator tracks."""
    pid_name = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_name[e["pid"]] = e["args"].get("name", "")
    dev = {p for p, nm in pid_name.items()
           if "/device:" in nm and "CPU" not in nm.upper()}
    print("trace processes:", sorted(pid_name.values()), file=sys.stderr)
    return [(e["name"], float(e.get("dur", 0.0)), e.get("args", {}))
            for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("pid") in dev]


def phase_of(name, args):
    text = name + " " + " ".join(str(v) for v in args.values())
    for ph in PHASES:
        if ph in text:
            return ph
    return "other"


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    warm = int(sys.argv[2]) if len(sys.argv) > 2 else 2000
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    cont = len(sys.argv) > 4 and sys.argv[4] == "cont"
    out_path = sys.argv[5] if len(sys.argv) > 5 else "profile_timeline.json"

    from gpufluidsimulator_tpu.utils.cache import enable
    enable()
    import jax
    import jax.numpy as jnp
    from gpufluidsimulator_tpu import scenes
    from gpufluidsimulator_tpu.ops import inc, pallas_sph
    from gpufluidsimulator_tpu.ops import planes as pm
    from gpufluidsimulator_tpu.utils.profiling import step_time

    params, state = scenes.double_dam_break(n=n, dim=3)
    params = params.replace(diagnostics=False)
    geom = pm.geometry(params)
    m_cap = inc.mover_capacity(state.n)
    state = inc.run_inc(state, params, warm)
    jax.block_until_ready(state.pos)

    s0 = inc.to_planes(state.pos, state.vel, state.ids, params, geom,
                       continuity=cont)
    if cont:
        p6 = pm.halo_x(s0.fields6)
        s0 = s0._replace(
            rhop=pallas_sph.density_planes(p6[:3], params, geom),
            age=jnp.int32(1))

    @jax.jit
    def roll(s):
        def body(s, _):
            return inc.step_planes(s, params, geom, m_cap), None
        return jax.lax.scan(body, s, None, length=k)[0]

    jax.block_until_ready(roll(s0))
    t = step_time(lambda s: inc.step_planes(s, params, geom, m_cap), s0,
                  k=k)
    tdir = tempfile.mkdtemp(prefix="fluid_trace_")
    try:
        jax.profiler.start_trace(tdir, create_perfetto_trace=True)
        jax.block_until_ready(roll(s0))
        jax.profiler.stop_trace()
        paths = glob.glob(f"{tdir}/**/*.trace.json.gz", recursive=True)
        assert paths, f"no trace.json.gz under {tdir}"
        with gzip.open(sorted(paths)[-1], "rt") as f:
            events = device_events(json.load(f))
    finally:
        shutil.rmtree(tdir, ignore_errors=True)

    by_kernel = collections.defaultdict(float)
    by_phase = collections.defaultdict(float)
    for name, dur, args in events:
        by_kernel[name] += dur
        by_phase[phase_of(name, args)] += dur
    busy = sum(by_kernel.values()) / 1e3 / k
    summary = {
        "n": state.n, "warm": warm, "tier": "cont" if cont else "inc",
        "device_kind": jax.devices()[0].device_kind,
        "ms_per_step": t * 1e3,
        "kernel_ms_per_step": busy,
        "phase_ms_per_step": {p: v / 1e3 / k for p, v in
                              sorted(by_phase.items(),
                                     key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [
            (nm[:100], us / 1e3 / k) for nm, us in
            sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]],
    }
    print(json.dumps(summary, indent=1))
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
