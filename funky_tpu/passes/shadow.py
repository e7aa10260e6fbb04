"""Shadow cascade depth passes.

The reference renders 4 depth-only passes into a 4-layer 2048^2 D32 array
(gltf_renderer.rs:728-804, render loop 2075-2152; shadow.vert picks
lightViewProj[cascadeIndex]). Here each cascade is one depth-only run of
the shared tile rasterizer; world-space vertices are transformed by each
cascade's light matrix (the vertex work is a 4x batched matmul over the
whole scene, replacing 4 re-draws of every mesh).

Clear depth is 1.0; depth compare semantics per ops/raster.py. All four
cascades are independent subgraphs inside the frame jit, so XLA can
overlap them freely — the reference's image barriers (2003-2032, 2154-2177)
become plain data dependencies.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.raster import RasterConfig, raster_corners, raster_scene
from .uniforms import SHADOW_MAP_SIZE

# capacity=None auto-sizes bins to the triangle count — the SAFE default
# (an undersized bin silently drops triangles from dense shadow tiles).
SHADOW_RASTER_CFG = RasterConfig(tile_h=128, tile_w=256, capacity=None)


def render_shadow_maps(world: jnp.ndarray, tri_indices: jnp.ndarray,
                       num_triangles: int, light_view_proj: jnp.ndarray,
                       cfg: RasterConfig = SHADOW_RASTER_CFG,
                       size: int = SHADOW_MAP_SIZE) -> jnp.ndarray:
    """Rasterize depth for each cascade.

    Args:
      world: (V, 3) world-space vertices (shared with the main pass).
      light_view_proj: (4, 4, 4).

    Returns (4, size, size) f32 NDC depth, 1.0 = empty.
    """
    ones = jnp.ones((world.shape[0], 1), jnp.float32)
    hom = jnp.concatenate([world, ones], axis=-1)        # (V, 4)

    depths = []
    for c in range(light_view_proj.shape[0]):
        clip = hom @ light_view_proj[c].T
        _, depth, _ = raster_scene(clip, tri_indices, size, size,
                                   num_triangles, cfg)
        depths.append(depth)
    return jnp.stack(depths)


# ---------------------------------------------------------------------------
# Synthesized cascade maps (perf deviation mode,
# GltfFrameFlags.synth_shadow_maps): the full raster spends ~12 ms
# rasterizing 4x2048^2 texels, yet almost all of them are the flat ground
# quad — whose depth is EXACTLY an affine plane in light uv (ortho light,
# gltf_renderer.rs:1938-1944). So: evaluate the ground analytically over
# the full map (pure elementwise math, zero raster), and rasterize only the
# OCCLUDERS into a small footprint window (see
# shadow_lightspace.plan_windows — the occluder uv bbox IS the shadow
# footprint under an ortho light).
#
# Deviations vs the full raster (~1-ulp class, documented):
#   - ground depth comes from the plane fit instead of edge-function
#     interpolation (f32 rounding differs by ~1e-7);
#   - quad-border coverage uses the texel-center box test instead of the
#     rasterizer's exact edge rules (+-1 texel at the quad rim, far from
#     any caster);
#   - the window raster runs through a cropped viewport matrix (same
#     texel centers, ~1-ulp edge-function rounding).
# An occluder bbox that outgrows its window falls back to the full raster
# via ONE whole-set lax.cond (exact, slow frame) — synthesized maps never
# drop casters.
# ---------------------------------------------------------------------------


def _crop_matrix(lvp: jnp.ndarray, origin, wc: int, size: int):
    """Light matrix re-aimed at the (wc, wc) texel window at `origin`:
    window pixel centers land exactly on full-map texel centers
    (x2 = x * (S/Wc) + ((S - 2*ox)/Wc - 1) * w, same for y)."""
    oy, ox = origin
    sx = jnp.float32(size) / wc
    kx = (jnp.float32(size) - 2.0 * ox.astype(jnp.float32)) / wc - 1.0
    ky = (jnp.float32(size) - 2.0 * oy.astype(jnp.float32)) / wc - 1.0
    return jnp.stack([
        lvp[0] * sx + lvp[3] * kx,
        lvp[1] * sx + lvp[3] * ky,
        lvp[2],
        lvp[3],
    ])


def synth_windows_fit(world_v: jnp.ndarray, vert_object: jnp.ndarray,
                      light_view_proj: jnp.ndarray, size: int, sizes,
                      origins) -> jnp.ndarray:
    """The window-fit certificate of synthesize_shadow_maps as a
    standalone cheap program (no raster): every cascade's occluder uv
    bbox (+1 texel raster margin) lies inside its window, or entirely
    off-map. Shared by the frame's synth path and the occupancy poll so
    committed mode can legitimately elide the synth_ok cond — the
    driver's capacity_overflows check catches a view change that
    outgrows a window (ADVICE r4 alternative)."""
    from .shadow_lightspace import occluder_uv_bbox

    lo_uv, hi_uv = occluder_uv_bbox(world_v, vert_object,
                                    light_view_proj)
    ok = jnp.ones((), bool)
    for c in range(light_view_proj.shape[0]):
        wc = min(sizes[c], size) if sizes[c] else 0
        if wc:
            oy, ox = origins[c]
            lo_t = jnp.maximum(
                jnp.floor(lo_uv[c] * size).astype(jnp.int32) - 1, 0)
            hi_t = jnp.minimum(
                jnp.ceil(hi_uv[c] * size).astype(jnp.int32) + 1, size)
            ok_c = ((jnp.minimum(lo_t[0], size) >= ox)
                    & (hi_t[0] <= ox + wc)
                    & (jnp.minimum(lo_t[1], size) >= oy)
                    & (hi_t[1] <= oy + wc))
            off = (hi_t[0] <= lo_t[0]) | (hi_t[1] <= lo_t[1])
            ok = ok & (ok_c | off)
        else:
            lo_t = jnp.floor(lo_uv[c] * size) - 1.0
            hi_t = jnp.ceil(hi_uv[c] * size) + 1.0
            off = ((hi_t[0] <= 0) | (lo_t[0] >= size)
                   | (hi_t[1] <= 0) | (lo_t[1] >= size))
            ok = ok & off
    return ok


def synthesize_shadow_maps(scene, world_v: jnp.ndarray, uni, size: int,
                           sizes, origins,
                           win_cfg: RasterConfig | None = None):
    """Analytic-ground + windowed-occluder cascade maps.

    Returns ((L, size, size) maps, ok) — `ok` certifies every occluder
    fragment landed inside its window (callers lax.cond to the full
    raster otherwise). Occluders = every object except slot 0 (the
    ground quad, models[0] == identity by construction)."""
    from .shadow_classify import light_ground_planes
    from .shadow_lightspace import GROUND_Y, occluder_uv_bbox

    if win_cfg is None:
        win_cfg = RasterConfig(tile_h=128, tile_w=128)
    lvp = uni.light_view_proj
    n_casc = lvp.shape[0]
    planes = light_ground_planes(lvp, GROUND_Y)

    # Ground-quad extent in world xz (object slot 0 vertices; the quad is
    # axis-aligned at y=GROUND_Y — gltf_renderer.rs:610-678).
    gmask = (scene.vert_object == 0)[:, None]
    big = jnp.float32(1e30)
    lo_w = jnp.min(jnp.where(gmask, scene.positions, big), axis=0)
    hi_w = jnp.max(jnp.where(gmask, scene.positions, -big), axis=0)

    # world (x, z) -> uv is affine per cascade (ortho light): fit from 3
    # projected on-plane points, invert the 2x2.
    pts = jnp.asarray([[0.0, GROUND_Y, 0.0], [1.0, GROUND_Y, 0.0],
                       [0.0, GROUND_Y, 1.0]], jnp.float32)
    hom3 = jnp.concatenate([pts, jnp.ones((3, 1), jnp.float32)], axis=-1)
    clip3 = jnp.einsum("cij,nj->cni", lvp, hom3)
    uv3 = clip3[..., :2] / clip3[..., 3:4] * 0.5 + 0.5    # (L, 3, 2)
    uv_b = uv3[:, 0]                                      # (L, 2)
    fwd = jnp.stack([uv3[:, 1] - uv_b, uv3[:, 2] - uv_b], axis=-1)
    inv = jnp.linalg.inv(fwd)                             # (L, 2, 2)

    # occluder triangles + their per-cascade raster-fit certificate
    t = scene.tri_indices.shape[0]
    occl_valid = ((jnp.arange(t) < scene.num_triangles)
                  & (scene.tri_object != 0))
    ones = jnp.ones((world_v.shape[0], 1), jnp.float32)
    homv = jnp.concatenate([world_v, ones], axis=-1)
    lo_uv, hi_uv = occluder_uv_bbox(world_v, scene.vert_object, lvp)

    u_ax = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size
    maps = []
    ok = jnp.ones((), bool)
    for c in range(n_casc):
        uv_u = u_ax[None, :]
        uv_v = u_ax[:, None]
        du = uv_u - uv_b[c, 0]
        dv = uv_v - uv_b[c, 1]
        x_w = inv[c, 0, 0] * du + inv[c, 0, 1] * dv
        z_w = inv[c, 1, 0] * du + inv[c, 1, 1] * dv
        inside = ((x_w >= lo_w[0]) & (x_w <= hi_w[0])
                  & (z_w >= lo_w[2]) & (z_w <= hi_w[2]))
        z = planes[c, 0] * uv_u + planes[c, 1] * uv_v + planes[c, 2]
        # Depth-test semantics: LESS vs the 1.0 clear (ops/raster.py) —
        # a fragment at z >= 1 never lands.
        base = jnp.where(inside & (z < 1.0), z, jnp.float32(1.0))

        wc = min(sizes[c], size) if sizes[c] else 0
        if wc:
            oy, ox = origins[c]
            mat = _crop_matrix(lvp[c], (oy, ox), wc, size)
            tri_clip = (homv @ mat.T)[scene.tri_indices]
            _, win_depth, _ = raster_corners(tri_clip, occl_valid, wc, wc,
                                             win_cfg)
            sl = jax.lax.dynamic_slice(base, (oy, ox), (wc, wc))
            base = jax.lax.dynamic_update_slice(
                base, jnp.minimum(sl, win_depth), (oy, ox))
            # fit: the on-map part of the occluder bbox (+1 texel raster
            # margin) lies inside the window
            lo_t = jnp.floor(lo_uv[c] * size).astype(jnp.int32) - 1
            hi_t = jnp.ceil(hi_uv[c] * size).astype(jnp.int32) + 1
            lo_t = jnp.maximum(lo_t, 0)
            hi_t = jnp.minimum(hi_t, size)
            ok_c = ((jnp.minimum(lo_t[0], size) >= ox)
                    & (hi_t[0] <= ox + wc)
                    & (jnp.minimum(lo_t[1], size) >= oy)
                    & (hi_t[1] <= oy + wc))
            # an occluder entirely off-map has nothing to raster
            off = (hi_t[0] <= lo_t[0]) | (hi_t[1] <= lo_t[1])
            ok = ok & (ok_c | off)
        else:
            # no window for this cascade: only sound if no occluder can
            # land on this map at all
            lo_t = jnp.floor(lo_uv[c] * size) - 1.0
            hi_t = jnp.ceil(hi_uv[c] * size) + 1.0
            off = ((hi_t[0] <= 0) | (lo_t[0] >= size)
                   | (hi_t[1] <= 0) | (lo_t[1] >= size))
            ok = ok & off
        maps.append(base)
    return jnp.stack(maps), ok
