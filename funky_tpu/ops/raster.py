"""Tile raster: depth-tested visibility-buffer rasterization.

Replaces the hardware rasterizer + depth test of the reference's graphics
pipelines (gltf_renderer.rs:1324-1444 main, 1095-1230 shadow). Output is a
*visibility buffer*: per pixel the winning triangle id and its NDC depth.
All attribute interpolation and shading is deferred (passes/deferred.py),
which keeps this inner loop tiny and makes shading a perfectly regular
vectorized pass.

Two interchangeable implementations (RasterConfig.backend):
- "jnp": vmap-over-tiles + lax.scan over the full bin capacity. Runs
  anywhere; the CPU default and the reference for the kernel.
- "pallas_triton" (ops/raster_pallas.py): the same algorithm as a Pallas
  kernel through Triton for the GPU, with per-tile trip counts over the
  real bin entries and register-resident z/id. The GPU default.

Depth semantics: compare LESS with clear depth 1.0 (main pass,
gltf_renderer.rs:1411, 2252-2267); fragments outside z in [0, 1] are
clipped. Ties keep the lower triangle id (draw order), matching LESS.
Shadow pass uses LESS_OR_EQUAL in the reference (gltf_renderer.rs:1204) —
identical final depth values except exact ties, which resolve to the same
depth either way.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    tile_h: int = 32
    tile_w: int = 128
    # Per-tile bin capacity. None (default) = the full padded triangle
    # count: always correct, at the cost of capacity-sized per-tile DMA.
    # Tuned configs may set a tight value, but an overflowing bin DROPS
    # triangles (they vanish from that tile) — verify against
    # binning counts before tightening.
    capacity: int | None = None
    # "auto" (the GPU kernel on a GPU, jnp elsewhere) | "jnp" |
    # "pallas_triton" (the GPU kernel; off the GPU only with interpret).
    backend: str = "auto"
    # Run the GPU kernel in the Pallas interpreter (CPU tests).
    interpret: bool = False

    def tiles(self, width: int, height: int) -> Tuple[int, int]:
        return -(-height // self.tile_h), -(-width // self.tile_w)

    def resolve_capacity(self, padded_tris: int) -> int:
        if self.capacity is None:
            return padded_tris
        return self.capacity


BACKENDS = ("auto", "jnp", "pallas_triton")


def _backend(cfg: RasterConfig) -> str:
    """The raster implementation cfg asks for on this platform. Never
    falls back: an unknown name, or the GPU kernel off the GPU without
    interpret mode, raises."""
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown raster backend {cfg.backend!r}; "
                         f"expected one of {BACKENDS}")
    on_gpu = jax.default_backend() == "gpu"
    if cfg.backend == "auto":
        return "pallas_triton" if on_gpu else "jnp"
    if cfg.backend == "pallas_triton" and not (on_gpu or cfg.interpret):
        raise ValueError(
            "raster backend 'pallas_triton' compiles for the GPU only; "
            f"this platform is {jax.default_backend()!r} (set "
            "RasterConfig.interpret=True to run it in the Pallas "
            "interpreter)")
    return cfg.backend


def rasterize(bin_data: jnp.ndarray, bins: jnp.ndarray, counts: jnp.ndarray,
              width: int, height: int, cfg: RasterConfig,
              y_offset: jnp.ndarray | int = 0
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rasterize binned triangles with the jnp path (the GPU kernel reads
    the setup table instead of pre-gathered rows; see raster_corners).

    Args:
      bin_data: (n_tiles, C, 12) per-entry raster rows (bary planes + z
        plane) from binning.gather_bin_data.
      bins: (n_tiles, C) triangle ids, -1 padding.
      counts: (n_tiles,) real entry counts.
      width/height: framebuffer size (of this viewport slice).
      y_offset: first global framebuffer row of this slice (traced ok) —
        used by multi-chip row sharding; 0 for the full frame.

    Returns:
      tri_id: (H, W) int32, -1 where empty.
      depth:  (H, W) float32 NDC depth, 1.0 where empty.
    """
    y_offset = jnp.asarray(y_offset, jnp.int32)
    return _rasterize_jnp(bin_data, bins, counts, y_offset, width, height,
                          cfg)


def raster_scene(clip: jnp.ndarray, tri_indices: jnp.ndarray,
                 width: int, height: int, num_triangles: int,
                 cfg: RasterConfig, y_offset: jnp.ndarray | int = 0,
                 slice_height: int | None = None):
    """Full raster pipeline: setup -> bin -> gather -> rasterize.

    width/height describe the FULL framebuffer (triangle setup is global);
    y_offset + slice_height select the row slab this call rasters (row
    sharding across chips). Returns (tri_id, depth, TriangleSetup) where
    the buffers are (slice_height or height, width).
    """
    tri_clip = clip[tri_indices]
    valid_mask = None
    if num_triangles is not None:
        valid_mask = jnp.arange(tri_indices.shape[0]) < num_triangles
    return raster_corners(tri_clip, valid_mask, width, height, cfg,
                          y_offset, slice_height)


def raster_corners(tri_clip: jnp.ndarray, valid_mask: jnp.ndarray | None,
                   width: int, height: int, cfg: RasterConfig,
                   y_offset: jnp.ndarray | int = 0,
                   slice_height: int | None = None):
    """raster_scene from per-corner clip positions (T, 3, 4) — the entry
    point for near-clip-expanded geometry (ops/clipping.py)."""
    from .binning import (bin_triangles, gather_bin_data,
                          triangle_setup_corners)

    sh = height if slice_height is None else slice_height
    capacity = cfg.resolve_capacity(tri_clip.shape[0])
    setup = triangle_setup_corners(tri_clip, width, height, valid_mask)
    bins, counts = bin_triangles(setup, width, sh,
                                 cfg.tile_h, cfg.tile_w, capacity,
                                 y_offset)

    if _backend(cfg) == "pallas_triton":
        from .raster_pallas import rasterize_pallas

        tri_id, depth = rasterize_pallas(setup.data, bins, counts, width, sh,
                                         cfg, y_offset)
        return tri_id, depth, setup

    bin_data = gather_bin_data(setup, bins)
    tri_id, depth = rasterize(bin_data, bins, counts, width, sh, cfg,
                              y_offset)
    return tri_id, depth, setup


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _rasterize_jnp(bin_data, bins, counts, y_offset, width, height, cfg):
    th, tw = cfg.tile_h, cfg.tile_w
    tiles_y, tiles_x = cfg.tiles(width, height)
    n_tiles = tiles_y * tiles_x

    # Pixel-center offsets within a tile.
    oy = jnp.arange(th, dtype=jnp.float32)[:, None] + 0.5   # (th, 1)
    ox = jnp.arange(tw, dtype=jnp.float32)[None, :] + 0.5   # (1, tw)

    def raster_tile(tile_idx, data, ids):
        ty = (tile_idx // tiles_x).astype(jnp.float32) * th \
            + y_offset.astype(jnp.float32)
        tx = (tile_idx % tiles_x).astype(jnp.float32) * tw
        py = oy + ty                                         # (th, 1)
        px = ox + tx                                         # (1, tw)

        def body(carry, xs):
            zbuf, idbuf = carry
            d, tid = xs
            b0 = d[0] * px + d[1] * py + d[2]
            b1 = d[3] * px + d[4] * py + d[5]
            b2 = d[6] * px + d[7] * py + d[8]
            z = d[9] * px + d[10] * py + d[11]
            cover = ((b0 >= 0) & (b1 >= 0) & (b2 >= 0)
                     & (z >= 0.0) & (z < zbuf) & (tid >= 0))
            zbuf = jnp.where(cover, z, zbuf)
            idbuf = jnp.where(cover, tid, idbuf)
            return (zbuf, idbuf), None

        init = (jnp.full((th, tw), 1.0, jnp.float32),
                jnp.full((th, tw), -1, jnp.int32))
        (zbuf, idbuf), _ = jax.lax.scan(body, init, (data, ids))
        return idbuf, zbuf

    idt, zt = jax.vmap(raster_tile)(
        jnp.arange(n_tiles, dtype=jnp.int32), bin_data, bins)

    tri_id = (idt.reshape(tiles_y, tiles_x, th, tw)
              .transpose(0, 2, 1, 3).reshape(tiles_y * th, tiles_x * tw))
    depth = (zt.reshape(tiles_y, tiles_x, th, tw)
             .transpose(0, 2, 1, 3).reshape(tiles_y * th, tiles_x * tw))
    return tri_id[:height, :width], depth[:height, :width]
