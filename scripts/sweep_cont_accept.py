"""Variant sweep for the continuity tier's acceptance margins.

Runs the f64 oracle (+1-ulp twin) ONCE and caches its checkpoint
observables, then evaluates any number of (cont_form, cont_beta) variants
on the default device in seconds each, printing SIGNED KE deviation (the
accept_cont gate only shows |.|, which hides whether a variant pumps or
damps energy — the round-5 sum-form tuning needed the sign).

Usage: python scripts/sweep_cont_accept.py [variant ...]
  variant = form:beta[:relax], e.g. sum:1.0 rate:1.0 relax:1.0:0.0625
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

CACHE = "/tmp/oracle_cont_obs.npz"
CHECKPOINTS = [250, 250, 250, 250]


def main():
    variants = []
    for a in sys.argv[1:]:
        parts = a.split(":")
        form, beta = parts[0], float(parts[1])
        relax = float(parts[2]) if len(parts) > 2 else None
        variants.append((form, beta, relax))
    if not variants:
        variants = [("rate", 1.0, None), ("relax", 1.0, None)]
    assert native.available()

    params, state0 = scenes.dam_break(n=4096, dim=2)
    n = state0.n
    lo = np.asarray(params.bounds_min)
    hi = np.asarray(params.bounds_max)

    def observables(pos, vel):
        hist, _, _ = np.histogram2d(
            pos[:, 0], pos[:, 1], bins=20,
            range=[[lo[0], hi[0]], [lo[1], hi[1]]])
        return (hist / n, pos.mean(axis=0),
                0.5 * params.particle_mass * float((vel ** 2).sum()))

    if os.path.exists(CACHE):
        z = np.load(CACHE)
        oa_list = [(z[f"h{i}"], z[f"c{i}"], float(z[f"k{i}"]))
                   for i in range(4)]
        env_list = [z["env"][i] for i in range(4)]
    else:
        p0 = np.asarray(state0.pos, np.float64)
        v0 = np.zeros_like(p0)
        pf = np.float32(p0)
        p0u = np.asarray(np.nextafter(pf, np.float32(2.0) * hi.max()),
                         np.float64)
        pa, va = p0.copy(), v0.copy()
        pb, vb = p0u.copy(), v0.copy()
        oa_list, env_list = [], []
        for k in CHECKPOINTS:
            pa, va, _, _ = native.run(pa, va, params, k)
            pb, vb, _, _ = native.run(pb, vb, params, k)
            oa = observables(pa, va)
            ob = observables(pb, vb)
            tv = 0.5 * np.abs(ob[0] - oa[0]).sum()
            com = np.abs(ob[1] - oa[1]).max()
            ke = abs(ob[2] - oa[2]) / max(abs(oa[2]), 1e-12)
            oa_list.append(oa)
            env_list.append(np.asarray([tv, com, ke]))
        np.savez(CACHE, env=np.stack(env_list),
                 **{f"h{i}": oa_list[i][0] for i in range(4)},
                 **{f"c{i}": oa_list[i][1] for i in range(4)},
                 **{f"k{i}": oa_list[i][2] for i in range(4)})
        print(f"oracle cached -> {CACHE}", flush=True)

    floors = np.asarray([0.02, 2e-3, 0.05])
    for form, beta, relax in variants:
        p = params.replace(cont_form=form, cont_beta=beta)
        if relax is not None:
            p = p.replace(cont_relax=relax)
        st = state0
        step_no = 0
        line = f"{form}:b={beta:g}" + (f":l={relax:g} " if relax is not None
                                       else " ")
        worst = 0.0
        for i, k in enumerate(CHECKPOINTS):
            st = run(st, p, k, method="pallas_inc_cont")
            step_no += k
            oa = oa_list[i]
            og = observables(np.asarray(st.pos, np.float64),
                             np.asarray(st.vel, np.float64))
            tv = 0.5 * np.abs(og[0] - oa[0]).sum()
            com = np.abs(og[1] - oa[1]).max()
            ke_s = (og[2] - oa[2]) / max(abs(oa[2]), 1e-12)   # SIGNED
            tol = np.maximum(8.0 * env_list[i], floors)
            ok = (np.asarray([tv, com, abs(ke_s)]) <= tol).all()
            line += (f"| s{step_no}: tv {tv:.4f} ke {ke_s:+.4f}"
                     f"{' ok' if ok else ' FAIL'} ")
            worst = max(worst, abs(ke_s) / tol[2], tv / tol[0], com / tol[1])
        print(line + f"| worst-margin {worst:.2f}"
              + f" ovf={int(st.overflow)}", flush=True)


if __name__ == "__main__":
    main()
