"""Pallas GPU kernel (Triton route) for the per-tile depth-tested raster.

Same algorithm and outputs as ops/raster.py's jnp path. What the kernel
does that XLA cannot express:

- the loop over a tile's bin runs only over its REAL entries (a trip
  count read from `counts` inside the kernel), where the jnp path scans
  the full padded capacity in every tile;
- z/id live in registers for the whole loop and are stored once, where
  the jnp path carries them through a `lax.scan` that reads and writes
  the frame's z/id buffers on every capacity slot.

Layout: one program per (tile, sub-block). A bin tile (e.g. 128x256 in
the shadow pass) holds too many pixels for one block's registers, so the
kernel block may be smaller than the tile; every sub-block of a tile
walks the same bin list. Each program loads its count, its triangle ids
and the 12 raster floats of each triangle itself, straight from the
(T, 16) setup table in device memory (small, so it stays in L2). Ties
keep the first-drawn triangle (compare-op LESS), as in the jnp path.

Launch parameters come from sweeps on an H100 (PERF.md, Findings PR 1;
experiments/raster_tune.py) over blocks of 1024-4096 pixels, 4 or 8
warps, 1 or 2 pipeline stages and an unrolled triangle loop: no setting
won everywhere, and the spread between two runs of one setting was as
large as that between settings. 2048-pixel blocks, 4 warps, one stage
and no unroll are the simplest of the best group.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Kernel block = at most BLOCK_PIXELS pixels of one tile, BLOCK_W wide.
BLOCK_PIXELS = 2048
BLOCK_W = 128
NUM_WARPS = 4
NUM_STAGES = 1


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def block_shape(tile_h: int, tile_w: int,
                block_pixels: int = BLOCK_PIXELS) -> Tuple[int, int]:
    """Kernel block (sub_h, sub_w) for a (tile_h, tile_w) bin tile.

    Triton blocks are powers of two, so the tile must be one too; the
    block splits the tile into whole sub-blocks."""
    if not (_is_pow2(tile_h) and _is_pow2(tile_w)):
        raise ValueError(
            f"the GPU raster kernel needs power-of-two tiles, got "
            f"{tile_h}x{tile_w}")
    sub_w = min(tile_w, BLOCK_W)
    sub_h = max(1, min(tile_h, block_pixels // sub_w))
    return sub_h, sub_w


def _raster_kernel(off_ref, counts_ref, bins_ref, table_ref, id_out, z_out,
                   *, tile_h: int, tile_w: int, sub_h: int, sub_w: int,
                   tiles_x: int):
    t = pl.program_id(0)
    s = pl.program_id(1)
    n_sx = tile_w // sub_w
    count = counts_ref[t]

    base_y = (t // tiles_x) * tile_h + (s // n_sx) * sub_h + off_ref[0]
    base_x = (t % tiles_x) * tile_w + (s % n_sx) * sub_w
    py = (base_y.astype(jnp.float32) + 0.5 + jax.lax.broadcasted_iota(
        jnp.int32, (sub_h, 1), 0).astype(jnp.float32))
    px = (base_x.astype(jnp.float32) + 0.5 + jax.lax.broadcasted_iota(
        jnp.int32, (1, sub_w), 1).astype(jnp.float32))

    def body(i, carry):
        zbuf, idbuf = carry
        tid = bins_ref[t, i]                 # i < count: a real entry
        d = [table_ref[tid, c] for c in range(12)]
        b0 = d[0] * px + d[1] * py + d[2]
        b1 = d[3] * px + d[4] * py + d[5]
        b2 = d[6] * px + d[7] * py + d[8]
        z = d[9] * px + d[10] * py + d[11]
        cover = ((b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
                 & (z >= 0.0) & (z < zbuf))
        return jnp.where(cover, z, zbuf), jnp.where(cover, tid, idbuf)

    z_init = jnp.full((sub_h, sub_w), 1.0, jnp.float32)
    id_init = jnp.full((sub_h, sub_w), -1, jnp.int32)
    zbuf, idbuf = jax.lax.fori_loop(0, count, body, (z_init, id_init))
    id_out[...] = idbuf
    z_out[...] = zbuf


@functools.partial(jax.jit, static_argnames=(
    "tile_h", "tile_w", "tiles_y", "tiles_x", "block_pixels", "num_warps",
    "num_stages", "interpret"))
def _rasterize_blocks(table, bins, counts, y_offset, *, tile_h, tile_w,
                      tiles_y, tiles_x, block_pixels, num_warps, num_stages,
                      interpret):
    n_tiles = bins.shape[0]
    sub_h, sub_w = block_shape(tile_h, tile_w, block_pixels)
    n_sy, n_sx = tile_h // sub_h, tile_w // sub_w
    kernel = functools.partial(
        _raster_kernel, tile_h=tile_h, tile_w=tile_w, sub_h=sub_h,
        sub_w=sub_w, tiles_x=tiles_x)

    def whole(shape):
        return pl.BlockSpec(shape, lambda t, s: (0,) * len(shape))

    def out_block(t, s):
        return ((t // tiles_x) * n_sy + s // n_sx,
                (t % tiles_x) * n_sx + s % n_sx)

    frame = (tiles_y * tile_h, tiles_x * tile_w)
    return pl.pallas_call(
        kernel,
        grid=(n_tiles, n_sy * n_sx),
        in_specs=[whole((1,)), whole(counts.shape), whole(bins.shape),
                  whole(table.shape)],
        out_specs=[pl.BlockSpec((sub_h, sub_w), out_block),
                   pl.BlockSpec((sub_h, sub_w), out_block)],
        out_shape=[jax.ShapeDtypeStruct(frame, jnp.int32),
                   jax.ShapeDtypeStruct(frame, jnp.float32)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=num_stages),
        interpret=interpret,
        name="raster_tiles",
    )(y_offset.reshape(1), counts, bins, table)


def rasterize_pallas(setup_data: jnp.ndarray, bins: jnp.ndarray,
                     counts: jnp.ndarray, width: int, height: int, cfg,
                     y_offset=0, *, block_pixels: int = BLOCK_PIXELS,
                     num_warps: int = NUM_WARPS,
                     num_stages: int = NUM_STAGES
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Raster binned triangles straight from the (T, 16) setup table.

    Same contract as ops.raster.rasterize, with the setup table in place
    of the pre-gathered bin rows. Returns (tri_id, depth) of the
    (height, width) slab that starts at global row `y_offset`."""
    tiles_y, tiles_x = cfg.tiles(width, height)
    tri_id, depth = _rasterize_blocks(
        setup_data, bins, counts, jnp.asarray(y_offset, jnp.int32),
        tile_h=cfg.tile_h, tile_w=cfg.tile_w, tiles_y=tiles_y,
        tiles_x=tiles_x, block_pixels=block_pixels, num_warps=num_warps,
        num_stages=num_stages, interpret=cfg.interpret)
    return tri_id[:height, :width], depth[:height, :width]
