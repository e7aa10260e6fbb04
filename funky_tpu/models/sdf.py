"""Raymarched SDF demo scene (BASELINE config 5b).

A sphere-traced signed-distance scene in the spirit of the hybrid
root-finder the reference vendors (raymarch.hlsl — Tomasz Stachowiak's
kajiya/Tiny Glade marcher, used for its contact shadows): fixed-step
linear march + bisection refinement against an analytic SDF instead of a
depth buffer, plus SDF soft shadows (cone-aperture trick) and the same
Blinn-Phong + fill-light shading family as cube.frag.

This path is the array program's best case: every pixel runs identical dense
arithmetic (no gathers, no rasterization irregularity) — it demonstrates
the framework's per-pixel compute ceiling.

Scene: rounded-box pedestal + animated sphere/torus over a ground plane.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from .. import math3d as m3

MAX_STEPS = 96
MAX_DIST = 40.0
HIT_EPS = 1e-3
SHADOW_STEPS = 48

SKY_TOP = (0.35, 0.55, 0.85)
SKY_HORIZON = (0.53, 0.81, 0.92)   # the gltf clear color at the horizon
LIGHT_DIR = (0.5, 1.0, 0.3)        # match the glTF scene's key light


def _length(v):
    return jnp.sqrt(jnp.sum(v * v, axis=-1) + 1e-20)


def sd_sphere(p, center, radius):
    return _length(p - jnp.asarray(center, jnp.float32)) - radius


def sd_round_box(p, center, half, round_r):
    q = jnp.abs(p - jnp.asarray(center, jnp.float32)) - jnp.asarray(
        half, jnp.float32)
    outside = _length(jnp.maximum(q, 0.0))
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside - round_r


def sd_torus(p, center, major, minor):
    q = p - jnp.asarray(center, jnp.float32)
    xz = jnp.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2 + 1e-20) - major
    return jnp.sqrt(xz * xz + q[..., 1] ** 2 + 1e-20) - minor


def sd_plane_y(p, height=0.0):
    return p[..., 1] - height


def smooth_min(a, b, k=0.25):
    h = jnp.clip(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return b + (a - b) * h - k * h * (1.0 - h)


def scene_sdf(p, t):
    """Animated demo scene; returns (distance, material id (0=ground,
    1=sphere-blob, 2=torus, 3=pedestal))."""
    ground = sd_plane_y(p, 0.0)

    bob = 1.1 + 0.25 * jnp.sin(t * 1.3)
    sphere = sd_sphere(p, jnp.stack([0.9 * jnp.cos(t * 0.7), bob,
                                     0.9 * jnp.sin(t * 0.7)]), 0.45)
    pedestal = sd_round_box(p, (0.0, 0.3, 0.0), (0.5, 0.3, 0.5), 0.05)
    blob = smooth_min(sphere, pedestal, 0.3)

    # torus spinning about Y
    c, s = jnp.cos(t * 0.5), jnp.sin(t * 0.5)
    q = p - jnp.asarray([0.0, 1.1, 0.0], jnp.float32)
    qr = jnp.stack([c * q[..., 0] - s * q[..., 2],
                    q[..., 1],
                    s * q[..., 0] + c * q[..., 2]], axis=-1)
    # tilt 30 degrees
    ct, st = jnp.cos(0.5), jnp.sin(0.5)
    qt = jnp.stack([qr[..., 0],
                    ct * qr[..., 1] - st * qr[..., 2],
                    st * qr[..., 1] + ct * qr[..., 2]], axis=-1)
    torus = sd_torus(qt, (0.0, 0.0, 0.0), 1.0, 0.12)

    d = jnp.minimum(jnp.minimum(ground, blob), torus)
    mat = jnp.where(d == ground, 0,
                    jnp.where(d == blob, 1, 2)).astype(jnp.int32)
    return d, mat


_MAT_COLORS = jnp.asarray([
    [0.35, 0.35, 0.35],   # ground (matches the glTF ground plane)
    [0.9, 0.6, 0.2],      # blob
    [0.3, 0.6, 0.9],      # torus
], jnp.float32)


@dataclasses.dataclass(frozen=True)
class SdfConfig:
    width: int = 960
    height: int = 540

    @property
    def aspect(self) -> float:
        return self.width / self.height


def _normal(p, t):
    """Tetrahedron-offset SDF gradient."""
    e = 5e-4
    k = jnp.asarray([[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]],
                    jnp.float32)
    n = jnp.zeros_like(p)
    for i in range(4):
        d, _ = scene_sdf(p + e * k[i], t)
        n = n + k[i] * d[..., None]
    return n / jnp.maximum(_length(n)[..., None], 1e-12)


def _soft_shadow(p, light_dir, t, k=12.0):
    """Classic SDF soft shadow: min over the march of k*d/t."""
    def body(i, carry):
        dist, res = carry
        q = p + light_dir * dist[..., None]
        d, _ = scene_sdf(q, t)
        res = jnp.minimum(res, k * d / jnp.maximum(dist, 1e-3))
        dist = dist + jnp.clip(d, 0.02, 0.5)
        return dist, res

    dist0 = jnp.full(p.shape[:-1], 0.05, jnp.float32)
    res0 = jnp.ones(p.shape[:-1], jnp.float32)
    _, res = jax.lax.fori_loop(0, SHADOW_STEPS, body, (dist0, res0))
    return jnp.clip(res, 0.0, 1.0)


def render_sdf_frame(time_s: jnp.ndarray, camera_pos: jnp.ndarray,
                     yaw: jnp.ndarray, pitch: jnp.ndarray,
                     fov: jnp.ndarray, cfg: SdfConfig) -> jnp.ndarray:
    """Sphere-trace the scene; returns linear RGBA (H, W, 4)."""
    h, w = cfg.height, cfg.width
    t = jnp.asarray(time_s, jnp.float32)

    front = m3.camera_front(yaw, pitch)
    view = m3.look_at_rh(camera_pos, camera_pos + front,
                         jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    # Camera basis from the view matrix rows (world-space).
    right = view[0, :3]
    up = view[1, :3]
    fwd = -view[2, :3]

    tan_half = jnp.tan(fov * 0.5)
    px = (jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5) / w * 2.0 - 1.0
    py = (jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5) / h * 2.0 - 1.0
    # +py is down on screen (Vulkan-style row order)
    dirs = (fwd[None, None]
            + right[None, None] * (px * tan_half * cfg.aspect)[..., None]
            - up[None, None] * (py * tan_half)[..., None])
    dirs = dirs / _length(dirs)[..., None]

    origin = jnp.broadcast_to(camera_pos, dirs.shape)

    def march(i, carry):
        dist, hit = carry
        p = origin + dirs * dist[..., None]
        d, _ = scene_sdf(p, t)
        hit = hit | (d < HIT_EPS)
        step = jnp.where(hit, 0.0, d)
        dist = jnp.minimum(dist + step, MAX_DIST)
        return dist, hit

    dist0 = jnp.zeros((h, w), jnp.float32)
    hit0 = jnp.zeros((h, w), bool)
    dist, hit = jax.lax.fori_loop(0, MAX_STEPS, march, (dist0, hit0))
    hit = hit & (dist < MAX_DIST)

    p = origin + dirs * dist[..., None]
    n = _normal(p, t)
    _, mat = scene_sdf(p, t)
    base = _MAT_COLORS[jnp.clip(mat, 0, 2)]

    light = jnp.asarray(LIGHT_DIR, jnp.float32)
    light = light / _length(light)
    diff = jnp.maximum(jnp.sum(n * light, axis=-1), 0.0)
    shadow = _soft_shadow(p + n * 2e-3, light, t)

    view_dir = -dirs
    half = (light + view_dir)
    half = half / _length(half)[..., None]
    spec = jnp.power(jnp.maximum(jnp.sum(n * half, axis=-1), 0.0), 32.0)

    ao = jnp.clip(0.5 + 0.5 * n[..., 1], 0.0, 1.0)  # cheap sky occlusion
    color = (0.22 * base * ao[..., None]
             + 0.75 * diff[..., None] * shadow[..., None] * base
             + 0.25 * spec[..., None] * shadow[..., None])

    # distance fog into the horizon color
    fog = 1.0 - jnp.exp(-0.02 * dist)
    horizon = jnp.asarray(SKY_HORIZON, jnp.float32)
    color = color * (1 - fog[..., None]) + horizon * fog[..., None]

    # zenith-dark gradient: SKY_TOP at up-facing rays, horizon color at
    # and below the horizon
    sky_t = jnp.clip(dirs[..., 1] * 2.0 + 0.5, 0.0, 1.0)
    sky = (jnp.asarray(SKY_TOP, jnp.float32) * sky_t[..., None]
           + horizon * (1 - sky_t[..., None]))

    rgb = jnp.where(hit[..., None], color, sky)
    return jnp.concatenate([rgb, jnp.ones((h, w, 1), jnp.float32)], axis=-1)


@functools.lru_cache(maxsize=8)
def compiled_sdf_frame(cfg: SdfConfig):
    return jax.jit(functools.partial(render_sdf_frame, cfg=cfg))


def default_sdf_camera():
    import math

    pos = jnp.asarray([3.2, 2.2, 3.2], jnp.float32)
    target = jnp.asarray([0.0, 0.9, 0.0], jnp.float32)
    d = target - pos
    dn = d / jnp.linalg.norm(d)
    yaw = math.atan2(float(dn[2]), float(dn[0]))
    pitch = math.asin(float(dn[1]))
    return (pos, jnp.asarray(yaw, jnp.float32),
            jnp.asarray(pitch, jnp.float32),
            jnp.asarray(math.radians(50.0), jnp.float32))
