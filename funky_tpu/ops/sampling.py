"""Texture / shadow-map samplers as vectorized gathers.

Software equivalents of the reference's Vulkan samplers, with the exact
filter/address/compare configuration each binding uses:

- binding 1 texSampler: LINEAR mag/min, REPEAT
  (gltf_renderer.rs:1555-1565).
- binding 2 shadowMap (sampler2DArrayShadow): LINEAR + compare
  LESS_OR_EQUAL + CLAMP_TO_BORDER white (gltf_renderer.rs:806-819)
  — i.e. a hardware 2x2 PCF tap: four texel compares, bilinearly blended.
- binding 3 shadowMapDepth (raw depth, PCSS blocker search): NEAREST,
  CLAMP_TO_BORDER white (gltf_renderer.rs:822-833).
- bindings 6/7 sceneDepth linear/nearest: CLAMP_TO_EDGE
  (gltf_renderer.rs:835-858).

All samplers take uv with (0,0) = top-left texel corner (Vulkan), and use
the GL/Vulkan bilinear rule: texel coords = uv*size - 0.5.

Shapes: uv may be any batch shape (..., 2); textures are (H, W, C) or
(H, W). Gathers use flattened int32 indices — one `take` per tap, which XLA
lowers to a dynamic-gather.
"""

from __future__ import annotations

import math

import jax.numpy as jnp


def take_rows(flat: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Row gather with the index array reshaped into XLA's FAST layout.

    Designed around a serial gather whose rate depends on the index
    layout (an earlier accelerator's gather ran ~5.3 ns/row when the index array's trailing dim is <= 32
    and the gathered row stays around <= 128 lanes, and ~11.4 ns/row for
    every other layout — flat (B,), tap-major (16, B), wide-minor
    (B/128, 128) and dense (H, W) all hit the slow mode. Index VALUE
    order is irrelevant. Reshaping indices to (B/m, m) pre-gather and
    the result back post-gather is a pure relayout, bit-exact, and ~2.1x
    on every gather-bound pass.

    flat: (N, ...) table, gathered along dim 0. idx: any-shape int32.
    """
    shape = idx.shape
    b = idx.size
    row_elems = int(math.prod(flat.shape[1:])) if flat.ndim > 1 else 1
    m = 32
    while m > 2 and m * row_elems > 128:
        m //= 2
    # already in the fast layout?
    if (idx.ndim >= 2 and 1 < shape[-1] <= 32
            and shape[-1] * row_elems <= 128):
        return flat[idx]
    while m > 1 and b % m:
        m //= 2
    if m <= 1 or b <= m:
        return flat[idx]
    out = flat[idx.reshape(b // m, m)]
    return out.reshape(shape + flat.shape[1:])


def _gather2d(img: jnp.ndarray, iy: jnp.ndarray, ix: jnp.ndarray):
    """img (H, W) or (H, W, C); iy/ix int32 of identical batch shape."""
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape((h * w,) + img.shape[2:])
    return take_rows(flat, iy * w + ix)


def sample_bilinear_repeat(tex: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """LINEAR filter + REPEAT addressing (texSampler)."""
    h, w = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    ix0 = jnp.mod(x0.astype(jnp.int32), w)
    iy0 = jnp.mod(y0.astype(jnp.int32), h)
    ix1 = jnp.mod(ix0 + 1, w)
    iy1 = jnp.mod(iy0 + 1, h)
    t00 = _gather2d(tex, iy0, ix0)
    t10 = _gather2d(tex, iy0, ix1)
    t01 = _gather2d(tex, iy1, ix0)
    t11 = _gather2d(tex, iy1, ix1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def _bilinear_clamped_taps(shape_hw, uv):
    """Common bilinear tap setup with CLAMP handling split out: returns
    (iy0, ix0, iy1, ix1, fy, fx, inside) where `inside` flags each of the
    four taps as within [0,H)x[0,W) BEFORE clamping (for border color)."""
    h, w = shape_hw
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    x1 = x0 + 1
    y1 = y0 + 1

    def inb(iy, ix):
        return (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)

    inside = (inb(y0, x0), inb(y0, x1), inb(y1, x0), inb(y1, x1))
    cx0 = jnp.clip(x0, 0, w - 1)
    cy0 = jnp.clip(y0, 0, h - 1)
    cx1 = jnp.clip(x1, 0, w - 1)
    cy1 = jnp.clip(y1, 0, h - 1)
    return cy0, cx0, cy1, cx1, fy, fx, inside


def sample_shadow_compare(shadow_map: jnp.ndarray, uv: jnp.ndarray,
                          ref_depth: jnp.ndarray) -> jnp.ndarray:
    """sampler2DArrayShadow tap for ONE cascade layer: hardware 2x2 PCF.

    Args:
      shadow_map: (S, S) depth of the selected cascade.
      uv: (..., 2).
      ref_depth: (...,) comparison reference.

    Returns (...,) visibility in [0,1]: compare LESS_OR_EQUAL (lit when
    ref <= stored), border taps compare against 1.0 (opaque white border
    => lit, since ref <= 1).
    """
    cy0, cx0, cy1, cx1, fy, fx, inside = _bilinear_clamped_taps(
        shadow_map.shape, uv)

    def tap(iy, ix, inb):
        d = _gather2d(shadow_map, iy, ix)
        d = jnp.where(inb, d, 1.0)  # border = opaque white
        return (ref_depth <= d).astype(jnp.float32)

    t00 = tap(cy0, cx0, inside[0])
    t10 = tap(cy0, cx1, inside[1])
    t01 = tap(cy1, cx0, inside[2])
    t11 = tap(cy1, cx1, inside[3])
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_bilinear_border(img: jnp.ndarray, uv: jnp.ndarray,
                           border: float = 1.0) -> jnp.ndarray:
    """LINEAR + CLAMP_TO_BORDER (shadowMapDepth raw sampler). (H, W) only."""
    cy0, cx0, cy1, cx1, fy, fx, inside = _bilinear_clamped_taps(
        img.shape[:2], uv)

    def tap(iy, ix, inb):
        return jnp.where(inb, _gather2d(img, iy, ix), border)

    t00 = tap(cy0, cx0, inside[0])
    t10 = tap(cy0, cx1, inside[1])
    t01 = tap(cy1, cx0, inside[2])
    t11 = tap(cy1, cx1, inside[3])
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_bilinear_edge(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """LINEAR + CLAMP_TO_EDGE (sceneDepthLinear). (H, W) or (H, W, C)."""
    cy0, cx0, cy1, cx1, fy, fx, _ = _bilinear_clamped_taps(img.shape[:2], uv)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    t00 = _gather2d(img, cy0, cx0)
    t10 = _gather2d(img, cy0, cx1)
    t01 = _gather2d(img, cy1, cx0)
    t11 = _gather2d(img, cy1, cx1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


# ---------------------------------------------------------------------------
# Quad-packed sampling: designed for a gather that costs per gathered
# ROW regardless of row width (a serial dynamic-slice loop), so every
# multi-texel fetch should be ONE wide row. We pre-pack each texel's 2x2
# neighborhood [d(y,x), d(y,x+1), d(y+1,x), d(y+1,x+1)] into a 4-wide row
# (edge-clamped), turning a bilinear/compare tap from 4 gathers into 1.
# This is the software analogue of the GPU's texture-cache quad fetch.
# ---------------------------------------------------------------------------

def quad_pack(img: jnp.ndarray) -> jnp.ndarray:
    """(H, W) -> (H, W, 4) with each row's 2x2 neighborhood, edge-clamped
    (so out-of-range +1 neighbors repeat the edge, matching CLAMP_TO_EDGE;
    border-mode samplers mask separately)."""
    right = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    down = jnp.concatenate([img[1:, :], img[-1:, :]], axis=0)
    down_right = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
    return jnp.stack([img, right, down, down_right], axis=-1)


def quad_pack_nhwc(img: jnp.ndarray) -> jnp.ndarray:
    """(H, W, C) -> (H, W, 4*C): 2x2 neighborhood of full texel rows
    (channel-major per corner), wrap-addressed (REPEAT) for textures."""
    right = jnp.roll(img, -1, axis=1)
    down = jnp.roll(img, -1, axis=0)
    down_right = jnp.roll(down, -1, axis=1)
    return jnp.concatenate([img, right, down, down_right], axis=-1)


def _row_gather(packed: jnp.ndarray, iy: jnp.ndarray, ix: jnp.ndarray):
    """Gather rows from (H, W, K): one gather per (iy, ix)."""
    h, w, k = packed.shape
    flat = packed.reshape(h * w, k)
    return take_rows(flat, iy * w + ix)


def sample_bilinear_repeat_packed_layers(tex_packed: jnp.ndarray,
                                         sizes: jnp.ndarray,
                                         layer: jnp.ndarray,
                                         uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear REPEAT sampling from quad-packed texture LAYERS
    (per-mesh textures): tex_packed (N, H, W, 4*C), sizes (N, 2) true
    (h, w) per layer (smaller layers wrap-padded to the common H, W —
    models/scene.py), layer (...,) int32. ONE gathered row per sample;
    layer sizes resolve by one-hot select (N is small)."""
    n, hp, wp, k4 = tex_packed.shape
    c = k4 // 4
    oh = (layer[..., None] == jnp.arange(n, dtype=jnp.int32))
    h = jnp.sum(jnp.where(oh, sizes[:, 0], 0.0), axis=-1)
    w = jnp.sum(jnp.where(oh, sizes[:, 1], 0.0), axis=-1)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    # REPEAT against the true layer size; the +1 packed neighbors at the
    # true edge are correct because padding is wrap-filled.
    ix = jnp.mod(x0, w).astype(jnp.int32)
    iy = jnp.mod(y0, h).astype(jnp.int32)
    flat = tex_packed.reshape(n * hp * wp, k4)
    quad = take_rows(flat, (layer * hp + iy) * wp + ix)  # (..., 4C)
    t00 = quad[..., 0 * c:1 * c]
    t10 = quad[..., 1 * c:2 * c]
    t01 = quad[..., 2 * c:3 * c]
    t11 = quad[..., 3 * c:4 * c]
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def _quad_corners(quad, x_ok, y_ok):
    """Correct quad corners when the base texel was clamped from a negative
    index: with base clamped up, the +1 corners must repeat the clamped
    edge (the packed row is shifted by one otherwise)."""
    c00, c10, c01, c11 = (quad[..., 0], quad[..., 1],
                          quad[..., 2], quad[..., 3])
    c10 = jnp.where(x_ok, c10, c00)
    c11 = jnp.where(x_ok, c11, c01)
    c01 = jnp.where(y_ok, c01, c00)
    c11 = jnp.where(y_ok, c11, c10)
    return c00, c10, c01, c11


def _quad_tap_setup(shape_hw, uv):
    """Common packed-tap setup: returns (iy, ix clamped base texel, fy, fx,
    inside flags per corner, base in-range)."""
    h, w = shape_hw
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)

    def inb(iy, ix):
        return (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)

    inside = (inb(y0, x0), inb(y0, x0 + 1), inb(y0 + 1, x0),
              inb(y0 + 1, x0 + 1))
    cy = jnp.clip(y0, 0, h - 1)
    cx = jnp.clip(x0, 0, w - 1)
    return cy, cx, fy, fx, inside, (x0 >= 0), (y0 >= 0)


def sample_shadow_compare_packed(packed_maps: jnp.ndarray,
                                 layer: jnp.ndarray, uv: jnp.ndarray,
                                 ref_depth: jnp.ndarray) -> jnp.ndarray:
    """Hardware-PCF compare tap from quad-packed cascades
    (L, S, S, 4): one gathered row per tap. Border = white (lit)."""
    l, s, _, _ = packed_maps.shape
    cy, cx, fy, fx, inside, x_ok, y_ok = _quad_tap_setup((s, s), uv)
    flat = packed_maps.reshape(l * s * s, 4)
    quad = take_rows(flat, (layer * s + cy) * s + cx)    # (..., 4)
    c00, c10, c01, c11 = _quad_corners(quad, x_ok, y_ok)

    def cmp(d, inb):
        return jnp.where(inb, (ref_depth <= d).astype(jnp.float32), 1.0)

    t00 = cmp(c00, inside[0])
    t10 = cmp(c10, inside[1])
    t01 = cmp(c01, inside[2])
    t11 = cmp(c11, inside[3])
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_bilinear_border_packed(packed_maps: jnp.ndarray,
                                  layer: jnp.ndarray, uv: jnp.ndarray,
                                  border: float = 1.0) -> jnp.ndarray:
    """Raw-depth bilinear tap (PCSS blocker search) from quad-packed
    cascades: one gathered row per tap, border color outside."""
    l, s, _, _ = packed_maps.shape
    cy, cx, fy, fx, inside, x_ok, y_ok = _quad_tap_setup((s, s), uv)
    flat = packed_maps.reshape(l * s * s, 4)
    quad = take_rows(flat, (layer * s + cy) * s + cx)
    c00, c10, c01, c11 = _quad_corners(quad, x_ok, y_ok)

    t00 = jnp.where(inside[0], c00, border)
    t10 = jnp.where(inside[1], c10, border)
    t01 = jnp.where(inside[2], c01, border)
    t11 = jnp.where(inside[3], c11, border)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_nearest_border_packed(packed_maps: jnp.ndarray,
                                 layer: jnp.ndarray, uv: jnp.ndarray,
                                 border: float = 1.0) -> jnp.ndarray:
    """Raw-depth NEAREST + CLAMP_TO_BORDER tap (the PCSS blocker-search
    sampler, binding 3: gltf_renderer.rs:822-833) from quad-packed cascades
    (L, S, S, 4): one gathered row per tap.

    NEAREST texel = floor(uv * size); the quad base floor(uv*size - 0.5) is
    at most one texel below it, so the nearest texel is always one of the
    gathered quad's corners."""
    l, s, _, _ = packed_maps.shape
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    cx = jnp.clip(x0, 0, s - 1)
    cy = jnp.clip(y0, 0, s - 1)
    flat = packed_maps.reshape(l * s * s, 4)
    quad = take_rows(flat, (layer * s + cy) * s + cx)    # (..., 4)
    c00, c10, c01, c11 = _quad_corners(quad, x0 >= 0, y0 >= 0)

    nxi = jnp.floor(uv[..., 0] * s).astype(jnp.int32)
    nyi = jnp.floor(uv[..., 1] * s).astype(jnp.int32)
    inb = (nxi >= 0) & (nxi < s) & (nyi >= 0) & (nyi < s)
    nx = jnp.clip(jnp.clip(nxi, 0, s - 1) - cx, 0, 1)
    ny = jnp.clip(jnp.clip(nyi, 0, s - 1) - cy, 0, 1)
    nearest = jnp.where(
        ny == 0,
        jnp.where(nx == 0, c00, c10),
        jnp.where(nx == 0, c01, c11))
    return jnp.where(inb, nearest, border)


# ---------------------------------------------------------------------------
# Windowed variants: identical math to the full-table packed samplers, but
# the row fetch is rebased into a (Wh, Ww, 4) window dynamic-sliced from
# one cascade's (S, S, 4) quad-packed table at an integer `origin`.
# Rationale: designed around a serial gather that ran ~3x faster once
# the table fit a small cache (not yet measured on the H100); penumbra taps cluster in a small uv
# region each frame, so a per-frame window slice turns every shadow tap
# into a cheap small-table gather. All texel/fraction arithmetic runs in
# GLOBAL coordinates through the exact same ops as the full-table
# samplers — only the integer row index is offset — so results are
# BIT-IDENTICAL for taps whose clamped quad base lies inside the window
# (callers certify that; out-of-window fetches clamp to the window edge
# and are only ever produced by discarded padding slots).
# ---------------------------------------------------------------------------

def _window_fetch(window: jnp.ndarray, origin, cy: jnp.ndarray,
                  cx: jnp.ndarray) -> jnp.ndarray:
    wh, ww, _ = window.shape
    ly = jnp.clip(cy - origin[0], 0, wh - 1)
    lx = jnp.clip(cx - origin[1], 0, ww - 1)
    return take_rows(window.reshape(wh * ww, 4), ly * ww + lx)


def sample_shadow_compare_window(window: jnp.ndarray, origin,
                                 full_size: int, uv: jnp.ndarray,
                                 ref_depth: jnp.ndarray) -> jnp.ndarray:
    """sample_shadow_compare_packed for a single-cascade window (border =
    white/lit outside the FULL map, exactly as the full sampler)."""
    s = full_size
    cy, cx, fy, fx, inside, x_ok, y_ok = _quad_tap_setup((s, s), uv)
    quad = _window_fetch(window, origin, cy, cx)
    c00, c10, c01, c11 = _quad_corners(quad, x_ok, y_ok)

    def cmp(d, inb):
        return jnp.where(inb, (ref_depth <= d).astype(jnp.float32), 1.0)

    t00 = cmp(c00, inside[0])
    t10 = cmp(c10, inside[1])
    t01 = cmp(c01, inside[2])
    t11 = cmp(c11, inside[3])
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_nearest_border_window(window: jnp.ndarray, origin,
                                 full_size: int, uv: jnp.ndarray,
                                 border: float = 1.0) -> jnp.ndarray:
    """sample_nearest_border_packed for a single-cascade window."""
    s = full_size
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    cx = jnp.clip(x0, 0, s - 1)
    cy = jnp.clip(y0, 0, s - 1)
    quad = _window_fetch(window, origin, cy, cx)
    c00, c10, c01, c11 = _quad_corners(quad, x0 >= 0, y0 >= 0)

    nxi = jnp.floor(uv[..., 0] * s).astype(jnp.int32)
    nyi = jnp.floor(uv[..., 1] * s).astype(jnp.int32)
    inb = (nxi >= 0) & (nxi < s) & (nyi >= 0) & (nyi < s)
    nx = jnp.clip(jnp.clip(nxi, 0, s - 1) - cx, 0, 1)
    ny = jnp.clip(jnp.clip(nyi, 0, s - 1) - cy, 0, 1)
    nearest = jnp.where(
        ny == 0,
        jnp.where(nx == 0, c00, c10),
        jnp.where(nx == 0, c01, c11))
    return jnp.where(inb, nearest, border)


def sample_depth_dual_packed(packed: jnp.ndarray, uv: jnp.ndarray):
    """Contact-shadow dual read (bilinear + nearest of the same depth
    buffer, gltf.frag:150-169) from ONE quad-packed row gather.

    packed: (H, W, 4) quad-packed depth (edge-clamped). Returns
    (bilinear, nearest)."""
    h, w, _ = packed.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    ix = jnp.clip(x0, 0, w - 1)
    iy = jnp.clip(y0, 0, h - 1)
    quad = _row_gather(packed, iy, ix)
    c00, c10, c01, c11 = _quad_corners(quad, x0 >= 0, y0 >= 0)
    # CLAMP_TO_EDGE bilinear: out-of-range weights still blend clamped
    # texels (fx/fy can exceed [0,1] by design of the GL rule).
    fx = jnp.clip(fx, 0.0, 1.0)
    fy = jnp.clip(fy, 0.0, 1.0)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    bilinear = top * (1 - fy) + bot * fy
    # NEAREST = texel floor(u*size), expressed as a corner of the gathered
    # quad (exact, including edge clamping: the quad base is clamped too).
    nx = jnp.clip(jnp.floor(uv[..., 0] * w).astype(jnp.int32), 0, w - 1) - ix
    ny = jnp.clip(jnp.floor(uv[..., 1] * h).astype(jnp.int32), 0, h - 1) - iy
    nx = jnp.clip(nx, 0, 1)
    ny = jnp.clip(ny, 0, 1)
    nearest = jnp.where(
        ny == 0,
        jnp.where(nx == 0, c00, c10),
        jnp.where(nx == 0, c01, c11))
    return bilinear, nearest


def sample_depth_dual_window(window: jnp.ndarray, origin,
                             full_hw, uv: jnp.ndarray):
    """sample_depth_dual_packed through a dynamic-sliced (wh, ww, 4)
    sub-table of the full (H, W, 4) quad-packed depth at integer
    `origin` (oy, ox) — sub-cliff gather rate for probe sets that
    cluster (the contact march). Bit-identical to the full-table read
    while the quad base lies inside the window; outside, the read clamps
    to the window edge (committed-mode usage: callers bound the probe
    extent and the driver polls it)."""
    h, w = full_hw
    wh, ww, _ = window.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    ix = jnp.clip(x0, 0, w - 1)
    iy = jnp.clip(y0, 0, h - 1)
    lx = jnp.clip(ix - origin[1], 0, ww - 1)
    ly = jnp.clip(iy - origin[0], 0, wh - 1)
    quad = _row_gather(window, ly, lx)
    c00, c10, c01, c11 = _quad_corners(quad, x0 >= 0, y0 >= 0)
    fx = jnp.clip(fx, 0.0, 1.0)
    fy = jnp.clip(fy, 0.0, 1.0)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    bilinear = top * (1 - fy) + bot * fy
    nx = jnp.clip(jnp.floor(uv[..., 0] * w).astype(jnp.int32), 0, w - 1) \
        - ix
    ny = jnp.clip(jnp.floor(uv[..., 1] * h).astype(jnp.int32), 0, h - 1) \
        - iy
    nx = jnp.clip(nx, 0, 1)
    ny = jnp.clip(ny, 0, 1)
    nearest = jnp.where(
        ny == 0,
        jnp.where(nx == 0, c00, c10),
        jnp.where(nx == 0, c01, c11))
    return bilinear, nearest


def _gather_layered(maps: jnp.ndarray, layer: jnp.ndarray,
                    iy: jnp.ndarray, ix: jnp.ndarray):
    """maps (L, H, W); per-element layer index."""
    _, h, w = maps.shape
    flat = maps.reshape(-1)
    return take_rows(flat, (layer * h + iy) * w + ix)


def sample_shadow_compare_array(maps: jnp.ndarray, layer: jnp.ndarray,
                                uv: jnp.ndarray,
                                ref_depth: jnp.ndarray) -> jnp.ndarray:
    """sampler2DArrayShadow (binding 2): per-element cascade layer select +
    hardware 2x2 PCF compare LESS_OR_EQUAL, border white.

    maps: (L, S, S); layer: (...,) int32; uv: (..., 2); ref: (...,).
    """
    cy0, cx0, cy1, cx1, fy, fx, inside = _bilinear_clamped_taps(
        maps.shape[1:], uv)

    def tap(iy, ix, inb):
        d = _gather_layered(maps, layer, iy, ix)
        d = jnp.where(inb, d, 1.0)
        return (ref_depth <= d).astype(jnp.float32)

    t00 = tap(cy0, cx0, inside[0])
    t10 = tap(cy0, cx1, inside[1])
    t01 = tap(cy1, cx0, inside[2])
    t11 = tap(cy1, cx1, inside[3])
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_bilinear_border_array(maps: jnp.ndarray, layer: jnp.ndarray,
                                 uv: jnp.ndarray,
                                 border: float = 1.0) -> jnp.ndarray:
    """sampler2DArray raw depth (binding 3): LINEAR + border white."""
    cy0, cx0, cy1, cx1, fy, fx, inside = _bilinear_clamped_taps(
        maps.shape[1:], uv)

    def tap(iy, ix, inb):
        return jnp.where(inb, _gather_layered(maps, layer, iy, ix), border)

    t00 = tap(cy0, cx0, inside[0])
    t10 = tap(cy0, cx1, inside[1])
    t01 = tap(cy1, cx0, inside[2])
    t11 = tap(cy1, cx1, inside[3])
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_nearest_edge(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """NEAREST + CLAMP_TO_EDGE (sceneDepthNearest, shadowHistory-nearest)."""
    h, w = img.shape[0], img.shape[1]
    ix = jnp.clip(jnp.floor(uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip(jnp.floor(uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    return _gather2d(img, iy, ix)
