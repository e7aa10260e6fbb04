"""Triangle setup + tile binning — the front half of the rasterizer.

Rasterization on a SIMD machine wants *regular* work; triangles are
irregular. The classic fix (and ours): bin triangles into framebuffer tiles
up front with dense vectorized ops, so the per-tile raster loop only touches
triangles that can actually cover its pixels. This plays the role of the
reference's hardware rasterizer + its (unused) Rayon secondary-command fan
out (multithreading.rs:75-134) — the "command lists" here are per-tile
triangle index lists.

Conventions (Vulkan parity):
- clip -> NDC by perspective divide; NDC x,y in [-1,1], z in [0,1].
- viewport: fx = (ndc_x+1)/2 * W, fy = (ndc_y+1)/2 * H; because the
  projection matrix already flips Y (gltf_renderer.rs:1819-1820), fy
  increases downward = framebuffer row.
- pixel centers at (x+0.5, y+0.5).
- cull mode NONE (gltf_renderer.rs:1392): both windings rasterize; we
  normalize the edge functions by the *signed* area so barycentric
  coverage (all >= 0) works for both.
- triangles with any w <= eps are culled HERE; near-plane-crossing
  triangles are clipped into sub-triangles upstream (ops/clipping.py), so
  by the time setup runs every valid triangle projects cleanly.
  Fragments with z outside [0,1) are depth-clipped per pixel in the raster.

Triangle setup output is a flat (T, 16) f32 matrix so binning/rastering can
gather one row per triangle:
  [0:9]   barycentric plane coefficients: bary_i(p) = a_i*px + b_i*py + c_i
  [9:12]  NDC-depth plane: z(p) = za*px + zb*py + zc
  [12:16] screen AABB (x0, y0, x1, y1)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

SETUP_WIDTH = 16
_W_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class TriangleSetup:
    data: jnp.ndarray    # (T, 16) f32 — see module docstring
    valid: jnp.ndarray   # (T,) bool — survives w-cull and zero-area cull


jax.tree_util.register_pytree_node(
    TriangleSetup,
    lambda s: ((s.data, s.valid), None),
    lambda _, c: TriangleSetup(*c))


def triangle_setup(clip: jnp.ndarray, tri_indices: jnp.ndarray,
                   width: int, height: int,
                   num_triangles: int | None = None) -> TriangleSetup:
    """Compute per-triangle raster data from clip-space vertices.

    Args:
      clip: (V, 4) clip positions.
      tri_indices: (T, 3) int32 (padded entries may be all-zero; they die to
        the zero-area cull).
      width/height: framebuffer size in pixels.
      num_triangles: real triangle count; padded tail is marked invalid.
    """
    tri_clip = clip[tri_indices]                      # (T, 3, 4)
    valid_mask = None
    if num_triangles is not None:
        t = tri_indices.shape[0]
        valid_mask = jnp.arange(t) < num_triangles
    return triangle_setup_corners(tri_clip, width, height, valid_mask)


def triangle_setup_corners(tri_clip: jnp.ndarray, width: int, height: int,
                           valid_mask: jnp.ndarray | None = None
                           ) -> TriangleSetup:
    """triangle_setup from per-corner clip positions (T, 3, 4) directly —
    the entry point for near-clip-expanded geometry (ops/clipping.py),
    whose sub-triangles have no vertex-buffer indices. `valid_mask`
    overrides per-row validity (AND-ed with the w/area culls)."""
    w = tri_clip[..., 3]                              # (T, 3)
    w_ok = jnp.all(w > _W_EPS, axis=-1)

    inv_w = 1.0 / jnp.where(w > _W_EPS, w, 1.0)
    ndc = tri_clip[..., :3] * inv_w[..., None]        # (T, 3, 3)

    sx = (ndc[..., 0] + 1.0) * (0.5 * width)          # (T, 3)
    sy = (ndc[..., 1] + 1.0) * (0.5 * height)
    sz = ndc[..., 2]

    x0, y0 = sx[:, 0], sy[:, 0]
    x1, y1 = sx[:, 1], sy[:, 1]
    x2, y2 = sx[:, 2], sy[:, 2]

    # Signed area * 2 (positive = CW in y-down screen space).
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    area_ok = jnp.abs(area) > 1e-12
    inv_area = jnp.where(area_ok, 1.0 / jnp.where(area_ok, area, 1.0), 0.0)

    # Edge functions opposite each vertex, normalized by signed area so that
    # bary_i >= 0 inside for BOTH windings (cull NONE):
    #   E0 = cross2(v2-v1, p-v1), E1 = cross2(v0-v2, p-v2),
    #   E2 = cross2(v1-v0, p-v0);  bary_i = E_i / area.
    def edge(ax, ay, bx, by):
        # cross2(b-a, p-a) = (bx-ax)(py-ay) - (by-ay)(px-ax)
        #                  = -(by-ay)*px + (bx-ax)*py + (by-ay)*ax-(bx-ax)*ay
        ca = -(by - ay)
        cb = bx - ax
        cc = (by - ay) * ax - (bx - ax) * ay
        return ca, cb, cc

    e0 = edge(x1, y1, x2, y2)
    e1 = edge(x2, y2, x0, y0)
    e2 = edge(x0, y0, x1, y1)

    coeffs = jnp.stack([
        e0[0] * inv_area, e0[1] * inv_area, e0[2] * inv_area,
        e1[0] * inv_area, e1[1] * inv_area, e1[2] * inv_area,
        e2[0] * inv_area, e2[1] * inv_area, e2[2] * inv_area,
    ], axis=-1)                                        # (T, 9)

    # NDC depth is affine in screen space: z(p) = sum_i bary_i(p) * z_i.
    za = (coeffs[:, 0] * sz[:, 0] + coeffs[:, 3] * sz[:, 1]
          + coeffs[:, 6] * sz[:, 2])
    zb = (coeffs[:, 1] * sz[:, 0] + coeffs[:, 4] * sz[:, 1]
          + coeffs[:, 7] * sz[:, 2])
    zc = (coeffs[:, 2] * sz[:, 0] + coeffs[:, 5] * sz[:, 1]
          + coeffs[:, 8] * sz[:, 2])

    bx0 = jnp.clip(jnp.minimum(jnp.minimum(x0, x1), x2), 0.0, float(width))
    by0 = jnp.clip(jnp.minimum(jnp.minimum(y0, y1), y2), 0.0, float(height))
    bx1 = jnp.clip(jnp.maximum(jnp.maximum(x0, x1), x2), 0.0, float(width))
    by1 = jnp.clip(jnp.maximum(jnp.maximum(y0, y1), y2), 0.0, float(height))

    valid = w_ok & area_ok & (bx1 > bx0) & (by1 > by0)
    if valid_mask is not None:
        valid = valid & valid_mask

    data = jnp.concatenate(
        [coeffs, jnp.stack([za, zb, zc], axis=-1),
         jnp.stack([bx0, by0, bx1, by1], axis=-1)], axis=-1)
    # Zero out invalid rows so their bary planes can never cover anything
    # accidentally mid-pipeline; coverage is still masked by bin ids >= 0.
    data = jnp.where(valid[:, None], data, 0.0)
    return TriangleSetup(data=data, valid=valid)


def bin_triangles(setup: TriangleSetup, width: int, height: int,
                  tile_h: int, tile_w: int, capacity: int,
                  y_offset: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Build per-tile triangle lists.

    Args:
      y_offset: first framebuffer row of this viewport slice (multi-chip
        row sharding: each device bins only its rows; must be a multiple
        of tile_h).

    Returns:
      bins: (n_tiles, capacity) int32 triangle ids, -1 padded, ascending
        (preserves draw order inside a tile).
      counts: (n_tiles,) int32 number of real entries (clamped to capacity).

    n_tiles = ceil(H/tile_h) * ceil(W/tile_w), row-major over tiles.
    """
    t = setup.data.shape[0]
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)

    aabb = setup.data[:, 12:16]                        # (T, 4)
    tx0 = jnp.floor(aabb[:, 0] / tile_w).astype(jnp.int32)
    ty0 = jnp.floor(aabb[:, 1] / tile_h).astype(jnp.int32)
    # AABB max is exclusive-ish; a triangle touching x=tile boundary only
    # covers pixel centers strictly inside, but keep it conservative.
    tx1 = jnp.floor((aabb[:, 2] - 1e-6) / tile_w).astype(jnp.int32)
    ty1 = jnp.floor((aabb[:, 3] - 1e-6) / tile_h).astype(jnp.int32)

    tile_ix = jnp.arange(tiles_x, dtype=jnp.int32)
    tile_iy = jnp.arange(tiles_y, dtype=jnp.int32) + y_offset // tile_h

    in_x = ((tile_ix[None, :] >= tx0[:, None])
            & (tile_ix[None, :] <= tx1[:, None]))       # (T, tiles_x)
    in_y = ((tile_iy[None, :] >= ty0[:, None])
            & (tile_iy[None, :] <= ty1[:, None]))       # (T, tiles_y)

    mask = (in_y[:, :, None] & in_x[:, None, :]
            & setup.valid[:, None, None])               # (T, ty, tx)
    mask = mask.reshape(t, tiles_y * tiles_x)

    counts = jnp.minimum(jnp.sum(mask, axis=0), capacity).astype(jnp.int32)

    big = jnp.int32(2 ** 30)
    keys = jnp.where(mask, jnp.arange(t, dtype=jnp.int32)[:, None], big)
    if t < capacity:
        keys = jnp.concatenate(
            [keys, jnp.full((capacity - t, keys.shape[1]), big, jnp.int32)])
    keys = jnp.sort(keys, axis=0)[:capacity]            # (C, n_tiles)
    bins = jnp.where(keys >= big, -1, keys).T           # (n_tiles, C)
    return bins, counts


def bin_stats(clip: jnp.ndarray, tri_indices: jnp.ndarray, width: int,
              height: int, tile_h: int, tile_w: int,
              num_triangles: int | None = None):
    """Diagnostic: per-tile occupancy for a given view — use to verify a
    hand-tuned RasterConfig.capacity has headroom (an overflowing bin
    silently DROPS triangles; see RasterConfig.capacity).

    Returns dict(max, mean, total, n_tiles) of bin occupancies.
    """
    setup = triangle_setup(clip, tri_indices, width, height, num_triangles)
    t = setup.data.shape[0]
    _, counts = bin_triangles(setup, width, height, tile_h, tile_w,
                              capacity=t)
    # jnp values (jit-friendly); callers int()/float() outside of traces.
    return {
        "max": counts.max(),
        "mean": counts.mean(),
        "total": counts.sum(),
        "n_tiles": counts.shape[0],
    }


def gather_bin_data(setup: TriangleSetup, bins: jnp.ndarray) -> jnp.ndarray:
    """Pre-gather each bin entry's setup row: (n_tiles, C, 16), one dense
    XLA gather feeding the jnp raster's scan (columns as in the module
    docstring; -1 padding entries read row 0 and are masked by their id).
    The GPU kernel reads the setup table directly instead.
    """
    return setup.data[jnp.maximum(bins, 0)]
