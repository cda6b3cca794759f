"""Shared physics pieces: equation of state, boundary + obstacle response,
symplectic Euler integration.

Reference counterparts: the EOS inside ``computeDensityPressureKernel``, the
``integrateKernel`` and ``collideKernel`` (SURVEY.md §2, §3.1; BASELINE.json
north_star: "symplectic Euler/leapfrog integration, boundary collision
response", "obstacle boundaries").

Design: pure jnp element-wise ops — XLA fuses all of this into the
surrounding kernels (and the force sweep fuses it into its epilogue); there
is no standalone "integrate launch" as in CUDA.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.params import SimParams


def eos_pressure(rho, params: SimParams):
    """Pressure from density.

    linear:  p = k (rho - rho_0)                       (Muller 2003 / demo EOS)
    tait:    p = k rho_0/gamma ((rho/rho_0)^gamma - 1) (WCSPH)
    """
    if params.eos == "tait":
        b = params.stiffness * params.rest_density / params.tait_gamma
        p = b * ((rho / params.rest_density) ** params.tait_gamma - 1.0)
    else:
        p = params.stiffness * (rho - params.rest_density)
    if params.clamp_negative_pressure:
        p = jnp.maximum(p, 0.0)
    return p


def _obstacle_sdf_normal(pos, obstacle, dim: int):
    """Signed distance (negative inside) and outward normal for one obstacle.

    pos: (..., dim). Returns (sdf (...,), normal (..., dim)).
    """
    kind = obstacle[0]
    if kind == "sphere":
        _, center, radius = obstacle
        c = jnp.asarray(center, pos.dtype)
        d = pos - c
        r = jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-20)
        return r - radius, d / r[..., None]
    if kind == "box":
        _, center, half = obstacle
        c = jnp.asarray(center, pos.dtype)
        hx = jnp.asarray(half, pos.dtype)
        q = jnp.abs(pos - c) - hx                       # per-axis distance
        outside = jnp.maximum(q, 0.0)
        sdf_out = jnp.sqrt(jnp.sum(outside * outside, axis=-1) + 1e-20)
        sdf_in = jnp.minimum(jnp.max(q, axis=-1), 0.0)
        sdf = jnp.where(jnp.max(q, axis=-1) > 0.0, sdf_out, sdf_in)
        # Normal: outside -> gradient of the outside distance; inside -> axis
        # of least penetration (standard box SDF gradient).
        n_out = outside * jnp.sign(pos - c)
        n_out = n_out / (sdf_out[..., None] + 1e-20)
        axis = jnp.argmax(q, axis=-1)
        n_in = (jax_one_hot(axis, dim, pos.dtype)) * jnp.sign(pos - c)
        n = jnp.where((jnp.max(q, axis=-1) > 0.0)[..., None], n_out, n_in)
        return sdf, n
    raise ValueError(f"unknown obstacle kind {kind!r}")


def jax_one_hot(idx, depth: int, dtype):
    iota = jnp.arange(depth, dtype=idx.dtype)
    return (idx[..., None] == iota).astype(dtype)


def collide(pos, vel, params: SimParams):
    """Boundary + obstacle collision response.

    Domain walls: clamp position to [min, max] and reflect the normal velocity
    component damped by ``restitution`` (the reference's ``collideKernel``
    clamp/reflect behavior, SURVEY.md §2 "Boundary collision").
    Obstacles: project out along the SDF normal, reflect normal velocity.
    """
    lo = jnp.asarray(params.bounds_min, pos.dtype)
    hi = jnp.asarray(params.bounds_max, pos.dtype)
    damp = -params.restitution

    below = pos < lo
    above = pos > hi
    hit = below | above
    vel = jnp.where(hit, vel * damp, vel)
    pos = jnp.clip(pos, lo, hi)

    for ob in params.obstacles:
        sdf, n = _obstacle_sdf_normal(pos, ob, params.dim)
        inside = sdf < 0.0
        # push to the surface
        pos = jnp.where(inside[..., None], pos - sdf[..., None] * n, pos)
        vn = jnp.sum(vel * n, axis=-1)
        reflect = inside & (vn < 0.0)
        dv = (1.0 + params.restitution) * vn
        vel = jnp.where(reflect[..., None], vel - dv[..., None] * n, vel)

    return pos, vel


def integrate(pos, vel, acc, params: SimParams):
    """Symplectic Euler: v += a dt;  x += v dt;  then collide."""
    vel = vel + acc * params.dt
    pos = pos + vel * params.dt
    return collide(pos, vel, params)


def collide_axes(ps, vs, params: SimParams):
    """``collide`` on axis-separated component lists (same math, same op
    order).  Used inside Pallas kernels, where positions live as per-axis
    (8, 128) tiles and a trailing component axis would wreck the layout.
    """
    dim = len(ps)
    lo, hi = params.bounds_min, params.bounds_max
    damp = -params.restitution
    ps = list(ps)
    vs = list(vs)
    for d in range(dim):
        hit = (ps[d] < lo[d]) | (ps[d] > hi[d])
        vs[d] = jnp.where(hit, vs[d] * damp, vs[d])
        ps[d] = jnp.clip(ps[d], lo[d], hi[d])

    for ob in params.obstacles:
        kind = ob[0]
        if kind == "sphere":
            _, center, radius = ob
            dvec = [ps[d] - center[d] for d in range(dim)]
            r = jnp.sqrt(sum(x * x for x in dvec) + 1e-20)
            sdf = r - radius
            n = [x / r for x in dvec]
        elif kind == "box":
            _, center, half = ob
            q = [jnp.abs(ps[d] - center[d]) - half[d] for d in range(dim)]
            qmax = q[0]
            for d in range(1, dim):
                qmax = jnp.maximum(qmax, q[d])
            outside = [jnp.maximum(x, 0.0) for x in q]
            sdf_out = jnp.sqrt(sum(x * x for x in outside) + 1e-20)
            sgn = [jnp.sign(ps[d] - center[d]) for d in range(dim)]
            n_out = [outside[d] * sgn[d] / (sdf_out + 1e-20)
                     for d in range(dim)]
            # inside normal: FIRST axis attaining the max (argmax semantics)
            taken = None
            is_max = []
            for d in range(dim):
                m = q[d] == qmax
                if taken is not None:
                    m = m & ~taken
                taken = m if taken is None else (taken | m)
                is_max.append(m)
            is_out = qmax > 0.0
            sdf = jnp.where(is_out, sdf_out, jnp.minimum(qmax, 0.0))
            n = [jnp.where(is_out, n_out[d],
                           jnp.where(is_max[d], sgn[d], 0.0))
                 for d in range(dim)]
        else:
            raise ValueError(f"unknown obstacle kind {kind!r}")
        inside = sdf < 0.0
        ps = [jnp.where(inside, ps[d] - sdf * n[d], ps[d])
              for d in range(dim)]
        vn = sum(vs[d] * n[d] for d in range(dim))
        reflect = inside & (vn < 0.0)
        dv = (1.0 + params.restitution) * vn
        vs = [jnp.where(reflect, vs[d] - dv * n[d], vs[d])
              for d in range(dim)]
    return ps, vs
