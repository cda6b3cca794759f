"""Quantify the full-CFL chaos bound for the config-1 1000-step acceptance.

The 1000-step oracle test runs at dt/2 with a one-point Lyapunov
justification.  This experiment makes the bound quantitative and
implementation-independent:

  * run the float64 C++ oracle TWICE from initial positions that differ by
    one f32 ulp (6e-8 at O(1) domain units) — the smallest difference any
    f32 implementation could possibly avoid;
  * record the relative-error growth curve between the two float64 runs at
    every 25 steps, at full CFL dt and at dt/2;
  * report the first step where the 1-ulp perturbation alone exceeds the
    1e-3 acceptance band.

If the f64-vs-f64 1-ulp divergence crosses 1e-3 before step 1000 at full
CFL, then NO f32 implementation (ours or the reference's CUDA path) can
meet 1e-3@1000 in that regime — the bound is floating-point-theoretic, not
an implementation defect.  Output: JSON lines + a summary block (the
recorded curves are docs/chaos_bound.json).

Usage: python scripts/chaos_bound.py [n] [steps] [every]
"""

from __future__ import annotations

import json
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from gpufluidsimulator_tpu import scenes
from gpufluidsimulator_tpu.oracle import native


def rel_err(a, b):
    scale = np.maximum(np.abs(b).max(), 1e-9)
    return float(np.abs(a - b).max() / scale)


def divergence_curve(p0, v0, params, n_steps, every, eps):
    rng = np.random.default_rng(0)
    pa, va = p0.copy(), v0.copy()
    pb = p0 + rng.uniform(-eps, eps, p0.shape)
    vb = v0.copy()
    curve = []
    for s in range(0, n_steps, every):
        # cell-list mode: same physics as the O(N^2) path (only the pair
        # summation order differs — immaterial for a SELF-divergence
        # experiment, where both trajectories use the identical engine)
        pa, va, _, _ = native.run(pa, va, params, every, use_grid=True)
        pb, vb, _, _ = native.run(pb, vb, params, every, use_grid=True)
        curve.append((s + every, rel_err(pb, pa)))
    return curve


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    every = int(sys.argv[3]) if len(sys.argv) > 3 else 25
    assert native.available(), "native oracle required (make -C csrc)"
    params, state = scenes.dam_break(n=n, dim=2)
    p0 = np.asarray(state.pos, np.float64)
    v0 = np.asarray(state.vel, np.float64)
    eps = float(np.spacing(np.float32(1.0)))      # 1 f32 ulp at O(1)

    out = {"n": int(p0.shape[0]), "steps": n_steps, "eps": eps, "curves": {}}
    for label, dt_scale in (("full_cfl", 1.0), ("half_cfl", 0.5)):
        p = params.replace(dt=params.dt * dt_scale)
        curve = divergence_curve(p0, v0, p, n_steps, every, eps)
        out["curves"][label] = curve
        cross = next((s for s, e in curve if e > 1e-3), None)
        out[f"{label}_first_step_over_1e-3"] = cross
        out[f"{label}_final_rel_err"] = curve[-1][1]
        # Lyapunov fit over the exponential-growth segment (err in
        # [10*eps, 1e-2]: above startup noise, below saturation)
        seg = [(s, e) for s, e in curve if 10 * eps < e < 1e-2]
        if len(seg) >= 3:
            xs = np.array([s for s, _ in seg], np.float64)
            ys = np.log(np.array([e for _, e in seg], np.float64))
            lam = float(np.polyfit(xs, ys, 1)[0])
            out[f"{label}_lyapunov_per_step"] = lam
            out[f"{label}_efold_steps"] = float(1.0 / lam) if lam > 0 else None
        print(f"[{label}] final={curve[-1][1]:.3e} "
              f"first>1e-3 at step {cross}", flush=True)
        for s, e in curve:
            print(f"  step {s:5d}  rel_err {e:.3e}", flush=True)
    print(json.dumps(out))
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "docs", "chaos_bound.json"),
            "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
