"""Rasterizer correctness on hand-counted triangles + brute-force parity."""

import numpy as np
import jax.numpy as jnp
import pytest

from funky_tpu.ops.binning import bin_triangles, gather_bin_data, triangle_setup
from funky_tpu.ops.raster import RasterConfig, raster_scene

CFG = RasterConfig(tile_h=8, tile_w=128, capacity=16, backend="jnp")


def clip_from_screen(pts, width, height, z=0.5, w=1.0):
    """Build clip coords that land exactly at given screen (x, y) pixels."""
    pts = np.asarray(pts, np.float32)
    ndc_x = pts[:, 0] / width * 2.0 - 1.0
    ndc_y = pts[:, 1] / height * 2.0 - 1.0
    n = len(pts)
    zs = np.full(n, z, np.float32) if np.isscalar(z) else np.asarray(z, np.float32)
    return jnp.asarray(
        np.stack([ndc_x * w, ndc_y * w, zs * w, np.full(n, w)], axis=-1))


def brute_force(clip, tris, width, height):
    """Reference rasterizer: straight per-pixel loop in numpy."""
    clip = np.asarray(clip)
    ndc = clip[:, :3] / clip[:, 3:4]
    sx = (ndc[:, 0] + 1) * 0.5 * width
    sy = (ndc[:, 1] + 1) * 0.5 * height
    sz = ndc[:, 2]
    zbuf = np.full((height, width), 1.0, np.float32)
    idbuf = np.full((height, width), -1, np.int32)
    ys, xs = np.mgrid[0:height, 0:width]
    px, py = xs + 0.5, ys + 0.5
    for t, (i0, i1, i2) in enumerate(np.asarray(tris)):
        if np.any(clip[[i0, i1, i2], 3] <= 1e-6):
            continue
        x0, y0, x1, y1, x2, y2 = sx[i0], sy[i0], sx[i1], sy[i1], sx[i2], sy[i2]
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        if area == 0:
            continue
        e0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) / area
        e1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) / area
        e2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) / area
        z = e0 * sz[i0] + e1 * sz[i1] + e2 * sz[i2]
        cover = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z >= 0) & (z < zbuf)
        zbuf = np.where(cover, z, zbuf)
        idbuf = np.where(cover, t, idbuf)
    return idbuf, zbuf


def run(clip, tris, width, height, cfg=CFG):
    tri_id, depth, _ = raster_scene(
        clip, jnp.asarray(tris, jnp.int32), width, height, len(tris), cfg)
    return np.asarray(tri_id), np.asarray(depth)


def test_single_triangle_coverage():
    # Right triangle with legs of 8 px starting at pixel (4, 4).
    clip = clip_from_screen([[4, 4], [12, 4], [4, 12]], 16, 16)
    tris = [[0, 1, 2]]
    tri_id, depth = run(clip, tris, 16, 16)
    # interior pixel
    assert tri_id[5, 5] == 0
    assert depth[5, 5] == pytest.approx(0.5)
    # outside
    assert tri_id[2, 2] == -1
    assert depth[2, 2] == 1.0
    # hand-counted coverage: pixel centers (x+.5, y+.5) inside the tri
    # x+y <= 16 strictly... edge-inclusive with our >= rule:
    # centers where (px-4) + (py-4) <= 8, px,py in [4,12]
    expect = 0
    for y in range(16):
        for x in range(16):
            px, py = x + 0.5, y + 0.5
            if px >= 4 and py >= 4 and (px - 4) + (py - 4) <= 8:
                expect += 1
    assert (tri_id == 0).sum() == expect


def test_winding_both_drawn():
    # Same triangle, reversed winding (back-facing): cull NONE -> drawn.
    clip = clip_from_screen([[4, 4], [12, 4], [4, 12]], 16, 16)
    a, _ = run(clip, [[0, 1, 2]], 16, 16)
    b, _ = run(clip, [[0, 2, 1]], 16, 16)
    np.testing.assert_array_equal(a, b)


def test_depth_test_near_wins():
    quad = [[0, 0], [16, 0], [0, 16], [16, 16]]
    near = clip_from_screen(quad, 16, 16, z=0.3)
    far = clip_from_screen(quad, 16, 16, z=0.7)
    clip = jnp.concatenate([near, far])
    # Draw far quad FIRST, then near: near must win everywhere.
    tris = [[4, 5, 6], [5, 7, 6], [0, 1, 2], [1, 3, 2]]
    tri_id, depth = run(clip, tris, 16, 16)
    assert np.all(depth == pytest.approx(0.3))
    assert set(np.unique(tri_id)) <= {2, 3}
    # And reversed order: near drawn first still wins.
    tris2 = [[0, 1, 2], [1, 3, 2], [4, 5, 6], [5, 7, 6]]
    _, depth2 = run(clip, tris2, 16, 16)
    assert np.all(depth2 == pytest.approx(0.3))


def test_degenerate_culled():
    clip = clip_from_screen([[4, 4], [4, 4], [4, 4]], 16, 16)
    tri_id, _ = run(clip, [[0, 1, 2]], 16, 16)
    assert np.all(tri_id == -1)


def test_behind_camera_culled():
    clip = clip_from_screen([[4, 4], [12, 4], [4, 12]], 16, 16, w=-1.0)
    tri_id, _ = run(clip, [[0, 1, 2]], 16, 16)
    assert np.all(tri_id == -1)


def test_depth_clip():
    # z < 0 (in front of near plane) fragments must be clipped.
    clip = clip_from_screen([[0, 0], [16, 0], [0, 16]], 16, 16, z=-0.5)
    tri_id, _ = run(clip, [[0, 1, 2]], 16, 16)
    assert np.all(tri_id == -1)


def test_interpolated_depth_gradient():
    # z varies across vertices; raster depth must match the analytic plane.
    clip = clip_from_screen([[0, 0], [16, 0], [0, 16]], 16, 16,
                            z=np.array([0.0, 0.8, 0.4]))
    tri_id, depth = run(clip, [[0, 1, 2]], 16, 16)
    ref_id, ref_depth = brute_force(clip, [[0, 1, 2]], 16, 16)
    np.testing.assert_array_equal(tri_id, ref_id)
    np.testing.assert_allclose(depth, ref_depth, atol=1e-5)


def test_tile_spanning_matches_brute_force():
    # Random triangle soup across tile boundaries == brute force loop.
    rng = np.random.default_rng(7)
    width, height = 256, 64  # 2x2 tiles with 8x128 tiles... (h=64 -> 8 rows)
    n_tri = 40
    pts = rng.uniform([-20, -20], [width + 20, height + 20],
                      (n_tri * 3, 2)).astype(np.float32)
    zs = rng.uniform(0.05, 0.95, n_tri * 3).astype(np.float32)
    clip = clip_from_screen(pts, width, height, z=zs)
    tris = np.arange(n_tri * 3).reshape(n_tri, 3)
    cfg = RasterConfig(tile_h=8, tile_w=128, capacity=64, backend="jnp")
    tri_id, depth = run(clip, tris, width, height, cfg)
    ref_id, ref_depth = brute_force(clip, tris, width, height)
    mismatch = (tri_id != ref_id).mean()
    # Allow a tiny fraction of edge-on-pixel-center disagreements (fp order).
    assert mismatch < 2e-3, f"mismatch fraction {mismatch}"
    np.testing.assert_allclose(depth, ref_depth, atol=1e-4)


def test_bin_capacity_overflow_drops_latest():
    # More triangles in one tile than capacity: first `capacity` kept.
    width = height = 16
    n = 8
    clips = []
    tris = []
    for i in range(n):
        base = len(clips)
        clips.extend([[2, 2], [14, 2], [2, 14]])
        tris.append([base, base + 1, base + 2])
    zs = np.repeat(np.linspace(0.9, 0.1, n), 3)  # later = nearer
    clip = clip_from_screen(np.asarray(clips), width, height, z=zs)
    cfg = RasterConfig(tile_h=8, tile_w=128, capacity=4, backend="jnp")
    tri_id, _ = run(clip, tris, width, height, cfg)
    # Only ids 0..3 can appear; nearest of those is id 3.
    assert tri_id[4, 4] == 3


def test_binning_lists():
    width, height = 256, 16
    clip = clip_from_screen([[130, 4], [140, 4], [130, 12]], width, height)
    setup = triangle_setup(clip, jnp.asarray([[0, 1, 2]], jnp.int32),
                           width, height, 1)
    bins, counts = bin_triangles(setup, width, height, 8, 128, 4)
    counts = np.asarray(counts)
    bins = np.asarray(bins)
    # tiles: 2 rows x 2 cols; the triangle lives in x in [130,140] =>
    # tile col 1, rows 0 and 1 (y 4..12 crosses y=8).
    assert counts.tolist() == [0, 1, 0, 1]
    assert bins[1, 0] == 0 and bins[3, 0] == 0
    data = np.asarray(gather_bin_data(setup, jnp.asarray(bins)))
    assert data.shape == (4, 4, 16)
    # each real entry carries its triangle's setup row
    row = np.asarray(setup.data)[0]
    np.testing.assert_array_equal(data[1, 0], row)
    np.testing.assert_array_equal(data[3, 0], row)


def test_bin_stats_and_overflow_detection():
    """bin_stats reports occupancy; a capacity below `max` would drop
    triangles (the shadow-map regression class)."""
    from funky_tpu.ops.binning import bin_stats

    width = height = 16
    n = 6
    clips, tris = [], []
    for i in range(n):
        base = 3 * i
        clips.extend([[2, 2], [14, 2], [2, 14]])
        tris.append([base, base + 1, base + 2])
    clip = clip_from_screen(np.asarray(clips, np.float32), width, height)
    stats = bin_stats(clip, jnp.asarray(tris, jnp.int32), width, height,
                      8, 128, n)
    assert stats["max"] == n          # all triangles share each tile
    assert stats["n_tiles"] == 2
    assert stats["total"] == 2 * n    # the tris span both 8-row tiles
