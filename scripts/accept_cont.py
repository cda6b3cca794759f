"""On-chip mirror of test_full_cfl_1000_steps_statistical_acceptance for
the continuity tier: runs the SAME observables/envelope protocol on the
default device for both pallas_inc and pallas_inc_cont and prints the
margins (got / tolerance per checkpoint), so alpha/RESUM_EVERY choices can
be judged in minutes.

Usage: python scripts/accept_cont.py [alpha] [resum_every]
"""

from __future__ import annotations

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpufluidsimulator_tpu.utils.cache import enable as _enable_cache
_enable_cache()

import numpy as np

from gpufluidsimulator_tpu import scenes, run
from gpufluidsimulator_tpu.oracle import native
from gpufluidsimulator_tpu.ops import inc


def main():
    alpha = float(sys.argv[1]) if len(sys.argv) > 1 else None
    resum = int(sys.argv[2]) if len(sys.argv) > 2 else None
    if resum is not None:
        inc.RESUM_EVERY = resum
    assert native.available()

    params, state0 = scenes.dam_break(n=4096, dim=2)
    if alpha is not None:
        params = params.replace(cont_alpha=alpha)
    n = state0.n
    lo = np.asarray(params.bounds_min)
    hi = np.asarray(params.bounds_max)

    def observables(pos, vel):
        hist, _, _ = np.histogram2d(
            pos[:, 0], pos[:, 1], bins=20,
            range=[[lo[0], hi[0]], [lo[1], hi[1]]])
        return (hist / n, pos.mean(axis=0),
                0.5 * params.particle_mass * float((vel ** 2).sum()))

    def diffs(oa, ob):
        tv = 0.5 * np.abs(oa[0] - ob[0]).sum()
        com = np.abs(oa[1] - ob[1]).max()
        ke = abs(oa[2] - ob[2]) / max(abs(ob[2]), 1e-12)
        return np.asarray([tv, com, ke])

    p0 = np.asarray(state0.pos, np.float64)
    v0 = np.zeros_like(p0)
    pf = np.float32(p0)
    p0u = np.asarray(np.nextafter(pf, np.float32(2.0) * hi.max()), np.float64)

    pa, va = p0.copy(), v0.copy()
    pb, vb = p0u.copy(), v0.copy()
    states = {m: state0 for m in ("pallas_inc", "pallas_inc_cont")}
    step_no = 0
    floors = np.asarray([0.02, 2e-3, 0.05])
    for k in [250, 250, 250, 250]:
        pa, va, _, _ = native.run(pa, va, params, k)
        pb, vb, _, _ = native.run(pb, vb, params, k)
        step_no += k
        oa = observables(pa, va)
        envelope = diffs(observables(pb, vb), oa)
        tol = np.maximum(8.0 * envelope, floors)
        for m in states:
            states[m] = run(states[m], params, k, method=m)
            st = states[m]
            got = diffs(observables(np.asarray(st.pos, np.float64),
                                    np.asarray(st.vel, np.float64)), oa)
            ok = (got <= tol).all()
            print(f"step {step_no:4d} {m:16s} [tv com ke] = "
                  f"[{got[0]:.4f} {got[1]:.4f} {got[2]:.4f}]  tol "
                  f"[{tol[0]:.4f} {tol[1]:.4f} {tol[2]:.4f}]  "
                  f"{'PASS' if ok else 'FAIL'}  ovf={int(st.overflow)}",
                  flush=True)


if __name__ == "__main__":
    main()
