"""Device-side point-splat rasterizer + NumPy/PNG export.

Reference counterpart: the OpenGL renderer — VBO interop, point-sprite sphere
shaders, camera (SURVEY.md §2 "Renderer"; BASELINE.json north_star: "the
OpenGL render path is replaced by a device-side rasterize-to-framebuffer
kernel plus NumPy export").

Design: there is no GL; the framebuffer is a jnp array produced
on device by scatter-add splatting, fully inside jit (it can run inside the
scanned step loop for zero-copy movie export).  3D uses an orthographic
camera (azimuth/elevation rotation) and splats with depth-based brightness;
intensity is accumulated per pixel with a 3x3 tent footprint, then tone-mapped
to a color ramp on the host-free path.  PNG export is pure stdlib
(zlib+struct), no matplotlib/PIL dependency.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.params import SimParams


def _camera_matrix(dim: int, azimuth: float, elevation: float):
    """Rotation mapping world coords -> (right, up, depth) camera coords."""
    if dim == 2:
        return np.eye(2, dtype=np.float32)
    az, el = math.radians(azimuth), math.radians(elevation)
    rz = np.array([[math.cos(az), 0, math.sin(az)],
                   [0, 1, 0],
                   [-math.sin(az), 0, math.cos(az)]], np.float32)
    rx = np.array([[1, 0, 0],
                   [0, math.cos(el), math.sin(el)],
                   [0, -math.sin(el), math.cos(el)]], np.float32)
    return rx @ rz          # host NumPy product: exact f32, no TF32


def splat(pos, params: SimParams, width: int = 512, height: int = 512,
          weights=None, azimuth: float = 30.0, elevation: float = 20.0):
    """Rasterize particle positions to an intensity framebuffer (H, W) f32.

    Runs entirely on device under jit.  `weights` (N,) modulates per-particle
    intensity (e.g. density or speed); default 1.
    """
    lo = jnp.asarray(params.bounds_min, jnp.float32)
    hi = jnp.asarray(params.bounds_max, jnp.float32)
    cam = jnp.asarray(_camera_matrix(params.dim, azimuth, elevation))
    centered = (pos - lo) / (hi - lo) - 0.5            # [-0.5, 0.5]^d
    # camera frame; HIGHEST keeps the GPU from rounding the f32 product
    # through TF32 (frames would shift by a pixel)
    proj = jnp.matmul(centered, cam.T, precision=jax.lax.Precision.HIGHEST)
    u = (proj[:, 0] + 0.5) * (width - 1)
    v = (0.5 - proj[:, 1]) * (height - 1)               # y up -> row down
    if params.dim == 3:
        depth = proj[:, 2] + 0.5
        shade = 0.55 + 0.45 * jnp.clip(depth, 0.0, 1.0)
    else:
        shade = jnp.ones_like(u)
    w = shade if weights is None else shade * weights

    iu = jnp.floor(u).astype(jnp.int32)
    iv = jnp.floor(v).astype(jnp.int32)
    fu = u - iu
    fv = v - iv

    fb = jnp.zeros((height * width,), jnp.float32)
    # bilinear (2x2 tent) splat: one scatter-add per corner
    for du, dv, cw in ((0, 0, (1 - fu) * (1 - fv)), (1, 0, fu * (1 - fv)),
                       (0, 1, (1 - fu) * fv), (1, 1, fu * fv)):
        px = iu + du
        py = iv + dv
        inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        idx = jnp.where(inside, py * width + px, height * width)
        fb = fb.at[idx].add(jnp.where(inside, w * cw, 0.0), mode="drop")
    return fb.reshape(height, width)


def tonemap(fb, gamma: float = 0.45) -> np.ndarray:
    """Intensity framebuffer -> (H, W, 3) uint8 with a water-like ramp."""
    fb = np.asarray(fb, np.float64)
    scale = np.percentile(fb[fb > 0], 95.0) if (fb > 0).any() else 1.0
    t = np.clip(fb / max(scale, 1e-9), 0.0, 1.0) ** gamma
    # deep blue -> cyan -> white ramp
    r = np.clip(1.8 * t - 0.8, 0.0, 1.0)
    g = np.clip(1.4 * t - 0.15, 0.0, 1.0)
    b = np.clip(0.25 + 1.1 * t, 0.0, 1.0) * (t > 0) + 0.04 * (t == 0)
    img = np.stack([r, g, b], axis=-1)
    return (img * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG writer (stdlib only). img: (H, W, 3) uint8 or (H, W)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def render_frame(state, params: SimParams, width: int = 512,
                 height: int = 512, color_by: str = "speed",
                 azimuth: float = 30.0, elevation: float = 20.0):
    """State -> intensity framebuffer; color_by: 'speed'|'density'|'none'."""
    if color_by == "speed":
        weights = 0.3 + jnp.sqrt(jnp.sum(state.vel ** 2, axis=-1))
    elif color_by == "density":
        weights = state.rho / params.rest_density
    else:
        weights = None
    return splat(state.pos, params, width, height, weights,
                 azimuth, elevation)


def save_frame(path: str, state, params: SimParams, **kw) -> None:
    fb = render_frame(state, params, **kw)
    write_png(path, tonemap(fb))
