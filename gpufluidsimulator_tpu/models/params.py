"""Simulation parameter surface.

Reference counterpart: the CUDA ``SimParams`` struct held in ``__constant__``
memory (SURVEY.md §2 "SimParams/constants"; BASELINE.json north_star names the
parameter surface: domain bounds, kernel radius ``h``, rest density, stiffness,
viscosity, scene selection, particle count).

Design: a frozen, hashable dataclass used as a *static* jit
argument.  Every field is a Python scalar/tuple, so the whole params object is
baked into the compiled XLA program exactly like ``__constant__`` memory is
baked into a CUDA kernel — zero per-step transfer cost, and XLA constant-folds
all derived quantities (kernel normalisations, grid strides, EOS constants).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# Obstacle descriptors are static (baked into the compiled step), mirroring the
# reference's compiled-in obstacle boundaries for the double-dam-break config.
#   ("box",    (cx, cy[, cz]), (hx, hy[, hz]))   axis-aligned box, half-extents
#   ("sphere", (cx, cy[, cz]), radius)
Obstacle = Tuple


@dataclasses.dataclass(frozen=True)
class SimParams:
    """All physical + numerical constants for one simulation.

    Hashable and immutable: pass as a static argnum (or close over it) so XLA
    treats every field as a compile-time constant.
    """

    dim: int = 3                       # 2 or 3
    h: float = 0.04                    # smoothing / interaction radius
    rest_density: float = 1000.0       # rho_0
    stiffness: float = 2000.0          # EOS gas constant k:  p = k (rho - rho_0)
    viscosity: float = 0.25            # dynamic viscosity mu
    particle_mass: float = 1.0
    dt: float = 4e-4
    gravity: Tuple[float, ...] = (0.0, -9.81, 0.0)
    bounds_min: Tuple[float, ...] = (0.0, 0.0, 0.0)
    bounds_max: Tuple[float, ...] = (1.0, 1.0, 1.0)
    restitution: float = 0.5           # boundary bounce damping in [0, 1]
    clamp_negative_pressure: bool = True
    # --- EOS selection: "linear" (k*(rho-rho0)) or "tait" (WCSPH, gamma=7) ---
    eos: str = "linear"
    tait_gamma: float = 7.0
    # --- uniform-grid neighbor structure (configs 2+) -----------------------
    cell_size: float = 0.0             # 0.0 -> defaults to h
    # Per-axis binning cell sizes (overrides cell_size when non-empty),
    # supported by the gridded tier: an ANISOTROPIC cell (dx, 2dx[, 2dx])
    # with the fine axis on x keeps occupancy near its mean on
    # lattice-coherent flow (exact-integer-multiple y/z windows are
    # alias-free).  Axis 0 may be < h (the x stencil widens to
    # ceil(h/cell_x) cells); other axes must stay >= h (their stencil
    # halfwidth is fixed at 1).
    cell_aniso: Tuple[float, ...] = ()
    # K: fixed particle slots per cell.  Mean occupancy at cell=h is ~2.2
    # (3D lattice, h = 1.3 dx); 8 covers the compressed tail with margin.
    cell_capacity: int = 8
    # --- static obstacle SDFs (double-dam-break config) ---------------------
    obstacles: Tuple[Obstacle, ...] = ()
    # --- observability: gather per-particle rho/pres each step (costs two
    # extra N-gathers; disable for pure-throughput runs) ---------------------
    diagnostics: bool = True
    # --- continuity-density tier stabilizer (ops/inc.py continuity mode) ----
    # Monaghan alpha artificial viscosity on APPROACHING pairs, applied only
    # on the continuity tier.  Why it exists: the fused continuity update
    # necessarily advances rho with the PRE-kick velocities (the post-kick
    # ones of query+candidates don't exist until the same sweep finishes),
    # which turns the symplectic acoustic update into FORWARD Euler —
    # |G| = sqrt(1 + (w dt)^2) > 1, an unconditional pump of the
    # shortest-wavelength modes (measured: KE x40 per 50 steps on the 2D
    # dam break at full CFL).  The summation tiers don't need either
    # stabilizer (their rho is a position functional) and stay
    # reference-faithful.  alpha damps VELOCITY (measured: passes the
    # statistical acceptance TV/COM easily but eats 4-8% of KE at
    # alpha 0.5-1.0 — right at the 5% acceptance floor); delta diffuses
    # the DENSITY field itself (delta-SPH, Antuono/Molteni), which
    # stabilizes the same acoustic loop while leaving the resolved
    # velocity field alone — preferred.  cont_delta needs viscosity > 0
    # (1/rho_j is recovered from the viscosity window channel); it is
    # statically disabled otherwise.
    cont_alpha: float = 0.0
    cont_delta: float = 0.0
    # Deferred-correction pressure term (the principled continuity-tier
    # stabilizer; strength 1.0 = the derived coefficient): the fused
    # update's pressure necessarily lags the current compression by one
    # step; adding the missing differential back as
    #   delta-p_i = c^2 dt (drho_i/dt)
    # in its pairwise-diagonal form restores det(G) = 1, |lambda| = 1 for
    # omega*dt < 2 — symplectic-equivalent stability with ZERO numerical
    # dissipation (unlike cont_alpha, which eats 4-8% of KE at the
    # stabilizing strength, and cont_delta, whose uncorrected density
    # diffusion flattens the hydrostatic gradient and blows up).  The
    # pairwise form reuses the continuity accumulation's d2^2*dot product,
    # so it costs ~2 VPU ops per pair.
    cont_beta: float = 1.0
    # How the pallas_inc_cont tier advances the carried density.
    #   "rate" (default, round 4) — integrate drho/dt = sum m
    #            (vi-vj).gradW explicitly, re-synced by a full summation
    #            sweep every ops/inc.RESUM_EVERY steps; supports the
    #            cont_delta delta-SPH stabilizer.  The only form with a
    #            measured ZERO-LOSS 5000-step @1.2M soak
    #            (docs/soak_cont.json).
    #   "relax" — the rate update relaxed toward the concurrent in-sweep
    #            summation: rho' = (1-l)(rho + dt drho/dt) + l R(x),
    #            l = cont_relax, folded into the SAME single accumulator
    #            (sum d4*(dot + kappa d2)) for ~1 extra op/pair; density
    #            error decays by (1-l) per step, so no periodic resum
    #            (seeded once at age 0) and no long-lived carried-rho
    #            error.  Round-5 verdict: acceptance PASSES at l=1/8 and
    #            1/4 (worst margin 0.97-0.98, = the rate form's; 1/16 and
    #            1/32 graze the KE floor at step 750), BUT the 5000-step
    #            @1.2M soak lost 5 particles in the violent phase (rate:
    #            0) with splash vmax UNCHANGED at 18-29
    #            (docs/soak_cont_relax.json) — kept as an opt-in research
    #            form, not the default.
    #   "sum"  — full re-anchoring: emit the exact poly6 summation R(x)
    #            each step (lag 1, zero drift).  Acceptance FAILS the KE
    #            gate at step 1000 (-0.0531 vs 0.05 floor); "completing"
    #            the emission to R(x) + dt*dR/dt is WORSE (-0.0658) —
    #            the deferred correction already compensates the lag, so
    #            completion double-corrects.  Opt-in research form.
    # ROUND-5 DIAGNOSIS from this family (scripts/sweep_cont_accept.py +
    # the soak pair): the round-4 hypothesis that splash vmax outliers
    # (2-3x the summation tier's) come from FROZEN carried rho on
    # isolated particles is DISPROVEN — even full per-step re-anchoring
    # ("sum"/"relax") leaves vmax at 18-29.  The outliers are caused by
    # the one-step pressure LAG in violent encounters (where the
    # deferred correction is clamped by design), which is inherent to
    # every member of the lagged-density family; the summation tier
    # (pallas_inc) remains the behavior-faithful mode.
    cont_form: str = "rate"
    # relaxation weight lambda for cont_form="relax" (see above).
    cont_relax: float = 0.125

    # ------------------------------------------------------------------ utils
    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        for name in ("gravity", "bounds_min", "bounds_max"):
            v = getattr(self, name)
            if len(v) != self.dim:
                raise ValueError(
                    f"{name} has length {len(v)} but dim={self.dim}"
                )
        if self.eos not in ("linear", "tait"):
            raise ValueError(f"unknown eos {self.eos!r}")
        if self.cell_aniso:
            if len(self.cell_aniso) != self.dim:
                raise ValueError(
                    f"cell_aniso has length {len(self.cell_aniso)} but "
                    f"dim={self.dim}")
            if any(c <= 0.0 for c in self.cell_aniso):
                raise ValueError(f"cell_aniso must be > 0: {self.cell_aniso}")
            for c in self.cell_aniso[1:]:
                if c < self.h * (1.0 - 1e-6):
                    raise ValueError(
                        "cell_aniso y/z cells must be >= h (their stencil "
                        f"halfwidth is 1): {self.cell_aniso} vs h={self.h}")
            if self.x_halfwidth > 3:
                raise ValueError(
                    f"cell_aniso[0]={self.cell_aniso[0]} needs an x-stencil "
                    f"halfwidth {self.x_halfwidth} > 3 (the gridded tier's "
                    "budget caps it at 3)")
        if self.cont_form not in ("relax", "sum", "rate"):
            raise ValueError(f"unknown cont_form {self.cont_form!r}")
        if self.cont_form == "relax" and not (
                0.0 < self.cont_relax < 1.0):
            raise ValueError(
                f"cont_relax must be in (0, 1) for cont_form='relax' "
                f"(use cont_form='sum' for full re-anchoring), got "
                f"{self.cont_relax}")
        if self.cont_delta > 0.0 and self.cont_form != "rate":
            # delta-SPH diffuses the INTEGRATED density field; the sum/
            # relax forms re-anchor at an exact summation (fully /
            # partially) every step, so there is no accumulated field to
            # diffuse — refuse a no-op request.
            raise ValueError(
                "cont_delta requires cont_form='rate' (the sum/relax "
                "forms have no freely integrated density field to "
                "diffuse)")
        if self.cont_delta > 0.0 and self.viscosity == 0.0:
            # delta-SPH recovers 1/rho_j from the viscosity window channel,
            # so it is statically disabled on inviscid configs — refuse
            # rather than silently ignore the requested stabilizer.
            raise ValueError(
                "cont_delta > 0 requires viscosity > 0 (the delta-SPH term "
                "rides the viscosity window channel and is statically "
                "disabled on inviscid configs)")

    @property
    def sound_speed(self) -> float:
        """EOS sound speed at rest density: dp/drho(rho0) = stiffness for
        BOTH the linear and the Tait form (Tait: B*gamma/rho0 = k)."""
        return math.sqrt(self.stiffness)

    @property
    def cell(self) -> float:
        """Edge length of an AXIS-0 grid cell (defaults to the support
        radius h).  Axis 0 is what slab sharding, x-halo lanes and the
        x-stencil use; under ``cell_aniso`` the axes differ — use
        ``cells_axis`` for per-axis sizes."""
        if self.cell_aniso:
            return self.cell_aniso[0]
        return self.cell_size if self.cell_size > 0.0 else self.h

    @property
    def cells_axis(self) -> Tuple[float, ...]:
        """Per-axis binning cell sizes."""
        if self.cell_aniso:
            return self.cell_aniso
        return (self.cell,) * self.dim

    @property
    def x_halfwidth(self) -> int:
        """x-stencil halfwidth: lane-roll offsets are -hw..hw (1 for
        cubic cells; ceil(h/cell_x) when the x cell is finer than h)."""
        cx = self.cell_aniso[0] if self.cell_aniso else self.cell
        return max(1, int(math.ceil(self.h / cx - 1e-6)))

    @property
    def grid_res(self) -> Tuple[int, ...]:
        """Cells per axis covering [bounds_min, bounds_max]."""
        return tuple(
            max(1, int(math.ceil((hi - lo) / c - 1e-9)))
            for (lo, hi), c in zip(
                zip(self.bounds_min, self.bounds_max), self.cells_axis)
        )

    @property
    def num_cells(self) -> int:
        n = 1
        for r in self.grid_res:
            n *= r
        return n

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)
