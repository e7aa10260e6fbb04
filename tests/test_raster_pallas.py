"""GPU raster kernel (ops/raster_pallas.py) in Pallas interpret mode.

The kernel compiles for the GPU only; here it runs in the Pallas
interpreter on the CPU and is pinned against the jnp path and the
brute-force reference: main and shadow tile shapes, the sub-block split
of a tile, tight-capacity overflow, row-slab offsets, plus the wrapper's
backend selection and block-shape rules.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import funky_tpu.ops.raster_pallas as rp
from funky_tpu.ops.binning import bin_triangles, triangle_setup
from funky_tpu.ops.raster import RasterConfig, _backend, raster_scene

from .test_raster import brute_force, clip_from_screen


def random_scene(seed=0, n_tris=40, width=128, height=64):
    rng = np.random.default_rng(seed)
    v = n_tris * 3
    pts = rng.uniform([-20, -20], [width + 20, height + 20], (v, 2))
    z = rng.uniform(0.05, 0.95, v)
    clip = np.array(clip_from_screen(pts, width, height, z=z))
    # a couple of degenerate / culled triangles
    clip[5] = clip[3]                      # zero-area
    clip[9, 3] = 1e-9                      # w <= eps cull
    tris = np.arange(v, dtype=np.int32).reshape(n_tris, 3)
    return jnp.asarray(clip), tris


def run(clip, tris, width, height, cfg, **kw):
    tri_id, depth, _ = raster_scene(
        clip, jnp.asarray(tris), width, height, len(tris), cfg, **kw)
    return np.asarray(tri_id), np.asarray(depth)


def kernel_cfg(**kw):
    return RasterConfig(backend="pallas_triton", interpret=True, **kw)


WIDTH, HEIGHT = 128, 64


@pytest.fixture(scope="module")
def scene():
    return random_scene()


@pytest.mark.parametrize("tile", [(8, 128), (32, 128), (64, 128)],
                         ids=["8x128", "main-32x128", "64x128"])
def test_kernel_matches_jnp_and_brute_force(scene, tile):
    clip, tris = scene
    th, tw = tile
    id_j, z_j = run(clip, tris, WIDTH, HEIGHT,
                    RasterConfig(tile_h=th, tile_w=tw, backend="jnp"))
    id_p, z_p = run(clip, tris, WIDTH, HEIGHT, kernel_cfg(tile_h=th,
                                                          tile_w=tw))
    np.testing.assert_array_equal(id_p, id_j)
    np.testing.assert_allclose(z_p, z_j, atol=1e-6)
    id_b, z_b = brute_force(clip, tris, WIDTH, HEIGHT)
    np.testing.assert_array_equal(id_p, id_b)
    np.testing.assert_allclose(z_p, z_b, atol=1e-4)


@pytest.mark.parametrize("block_pixels", [128, 512, 1024],
                         ids=["16-sub-blocks", "4-sub-blocks", "2-sub-blocks"])
def test_sub_block_split(scene, block_pixels):
    """A 16x128 tile split into kernel blocks smaller than the tile: every
    sub-block walks the tile's bin list and lands at its own rows."""
    clip, tris = scene
    assert rp.block_shape(16, 128, block_pixels)[0] == block_pixels // 128
    cfg = kernel_cfg(tile_h=16, tile_w=128)
    setup = triangle_setup(clip, jnp.asarray(tris), WIDTH, HEIGHT, len(tris))
    bins, counts = bin_triangles(setup, WIDTH, HEIGHT, 16, 128, len(tris))
    id_p, z_p = rp.rasterize_pallas(setup.data, bins, counts, WIDTH, HEIGHT,
                                    cfg, block_pixels=block_pixels)
    id_j, z_j = run(clip, tris, WIDTH, HEIGHT,
                    RasterConfig(tile_h=16, tile_w=128, backend="jnp"))
    np.testing.assert_array_equal(np.asarray(id_p), id_j)
    np.testing.assert_allclose(np.asarray(z_p), z_j, atol=1e-6)


@pytest.mark.parametrize("capacity", [2, 4], ids=["cap2", "cap4"])
def test_tight_capacity_overflow_parity(scene, capacity):
    """An overflowing bin drops the same triangles in both backends (the
    silent-overflow bug class is at least deterministic + identical)."""
    clip, tris = scene
    id_j, z_j = run(clip, tris, WIDTH, HEIGHT, RasterConfig(
        tile_h=8, tile_w=128, capacity=capacity, backend="jnp"))
    id_p, z_p = run(clip, tris, WIDTH, HEIGHT, kernel_cfg(
        tile_h=8, tile_w=128, capacity=capacity))
    np.testing.assert_array_equal(id_p, id_j)
    np.testing.assert_allclose(z_p, z_j, atol=1e-6)
    # the tight capacity really overflows somewhere (test has teeth)
    full_id, _ = run(clip, tris, WIDTH, HEIGHT,
                     RasterConfig(tile_h=8, tile_w=128, backend="jnp"))
    assert (full_id != id_j).any()


@pytest.mark.parametrize("y0,slab", [(32, 16), (16, 32)],
                         ids=["rows32-48", "rows16-48"])
def test_row_slab_offset(scene, y0, slab):
    """Rastering a row slab (multi-card sharding path) equals the matching
    rows of the full-frame raster."""
    clip, tris = scene
    full_id, full_z = run(clip, tris, WIDTH, HEIGHT,
                          RasterConfig(tile_h=8, tile_w=128, backend="jnp"))
    tri_id, depth = run(clip, tris, WIDTH, HEIGHT,
                        kernel_cfg(tile_h=8, tile_w=128),
                        y_offset=y0, slice_height=slab)
    np.testing.assert_array_equal(tri_id, full_id[y0:y0 + slab])
    np.testing.assert_allclose(depth, full_z[y0:y0 + slab], atol=1e-6)


def test_shadow_tile_shape_with_partial_tiles():
    """128x256 shadow tiles over a frame that is not a whole number of
    tiles: blocks beyond the frame are cropped."""
    clip, tris = random_scene(seed=3, n_tris=30, width=200, height=72)
    id_j, z_j = run(clip, tris, 200, 72, RasterConfig(
        tile_h=128, tile_w=256, backend="jnp"))
    id_p, z_p = run(clip, tris, 200, 72, kernel_cfg(tile_h=128, tile_w=256))
    assert id_p.shape == (72, 200)
    np.testing.assert_array_equal(id_p, id_j)
    np.testing.assert_allclose(z_p, z_j, atol=1e-6)


def test_block_shape_rules():
    assert rp.block_shape(32, 128) == (16, 128)
    assert rp.block_shape(128, 256) == (16, 128)
    assert rp.block_shape(8, 64) == (8, 64)
    with pytest.raises(ValueError, match="power-of-two"):
        rp.block_shape(24, 128)


def test_auto_backend_is_jnp_on_cpu():
    assert _backend(RasterConfig()) == "jnp"
    assert _backend(RasterConfig(backend="jnp")) == "jnp"


def test_gpu_backend_without_interpret_raises_on_cpu(scene):
    clip, tris = scene
    with pytest.raises(ValueError, match="GPU only"):
        run(clip, tris, WIDTH, HEIGHT,
            RasterConfig(tile_h=8, tile_w=128, backend="pallas_triton"))
    assert _backend(kernel_cfg()) == "pallas_triton"


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown raster backend"):
        _backend(RasterConfig(backend="pallas"))
