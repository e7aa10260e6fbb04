"""Deferred attribute interpolation from the visibility buffer.

The reference interpolates vertex outputs in fixed-function hardware
(gltf.vert outputs -> gltf.frag inputs). We defer: the raster pass only
records the winning triangle id per pixel; this pass gathers that
triangle's pre-packed shade block (passes/geometry.py) and setup row, and
reconstructs attributes with perspective-correct barycentric weights:

    b_i(p)     = screen-space barycentric (from the setup's bary planes)
    pw_i       = b_i * (1/w_i)
    attr(p)    = sum_i pw_i * attr_i / sum_i pw_i

This matches hardware `smooth` interpolation exactly (within fp error).
One gather of 36+12 contiguous floats per pixel instead of ~10 scattered
vertex gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..ops.sampling import take_rows


class GBuffer(NamedTuple):
    """Interpolated per-pixel attributes (all (H, W, ...) arrays)."""
    valid: jnp.ndarray      # (H, W) bool — a triangle covers this pixel
    world: jnp.ndarray      # (H, W, 3) world position
    normal: jnp.ndarray     # (H, W, 3) world normal (normalized in shading)
    uv: jnp.ndarray         # (H, W, 2)
    color: jnp.ndarray      # (H, W, 3) vertex color (material baked)
    flags: jnp.ndarray      # (H, W) int32 per-triangle flags (useTexture)
    depth: jnp.ndarray      # (H, W) NDC depth from the raster


def interpolate_at(tri_id: jnp.ndarray, depth: jnp.ndarray,
                   setup_data: jnp.ndarray, shade_blocks: jnp.ndarray,
                   tri_flags: jnp.ndarray, px: jnp.ndarray,
                   py: jnp.ndarray) -> GBuffer:
    """Interpolation core on ANY batch shape with explicit pixel-center
    coordinates (the blocked back half feeds flat compacted batches).

    Args:
      tri_id: (...,) int32 visibility buffer (-1 = empty).
      depth: (...,) f32 NDC depth.
      setup_data: (T, 16) triangle setup rows (bary planes in [0:9]).
      shade_blocks: (T, 3, 12) packed corner attributes
        [world(3), normal(3), uv(2), color(3), inv_w(1)].
      tri_flags: (T,) int32.
      px, py: (...,) f32 pixel centers in GLOBAL framebuffer coords.
    """
    valid = tri_id >= 0
    safe_id = jnp.maximum(tri_id, 0)

    # ONE fused row gather per pixel (designed for a gather that paid per
    # ROW, width ~free; not yet measured on the H100): setup planes (9), shade
    # blocks (36) and flags (1) concat into a 46-wide row table first.
    t = setup_data.shape[0]
    fused = jnp.concatenate([
        setup_data[:, :9],
        shade_blocks.reshape(t, 36),
        tri_flags[:, None].astype(jnp.float32),
    ], axis=-1)                                          # (T, 46)
    rows = take_rows(fused, safe_id)                     # (..., 46)
    planes = rows[..., :9]
    blocks = rows[..., 9:45].reshape(rows.shape[:-1] + (3, 12))
    flags = rows[..., 45].astype(jnp.int32)

    b0 = planes[..., 0] * px + planes[..., 1] * py + planes[..., 2]
    b1 = planes[..., 3] * px + planes[..., 4] * py + planes[..., 5]
    b2 = planes[..., 6] * px + planes[..., 7] * py + planes[..., 8]
    b = jnp.stack([b0, b1, b2], axis=-1)                 # (..., 3)

    inv_w = blocks[..., 11]                              # (..., 3)
    pw = b * inv_w
    denom = jnp.sum(pw, axis=-1, keepdims=True)
    weights = pw / jnp.where(jnp.abs(denom) > 1e-20, denom, 1.0)

    attrs = jnp.einsum("...k,...kc->...c", weights, blocks[..., :11])

    return GBuffer(
        valid=valid,
        world=attrs[..., 0:3],
        normal=attrs[..., 3:6],
        uv=attrs[..., 6:8],
        color=attrs[..., 8:11],
        flags=jnp.where(valid, flags, 0),
        depth=depth,
    )


def interpolate(tri_id: jnp.ndarray, depth: jnp.ndarray,
                setup_data: jnp.ndarray, shade_blocks: jnp.ndarray,
                tri_flags: jnp.ndarray, y0=0) -> GBuffer:
    """Full-slab interpolation: (H, W) visibility buffer, pixel centers
    generated from the slab's global row offset y0 (row sharding)."""
    h, w = tri_id.shape
    px = jnp.broadcast_to(
        jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5, (h, w))
    py = jnp.broadcast_to(
        jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
        + jnp.asarray(y0, jnp.float32), (h, w))
    return interpolate_at(tri_id, depth, setup_data, shade_blocks,
                          tri_flags, px, py)
