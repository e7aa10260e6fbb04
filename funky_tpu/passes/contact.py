"""Contact shadows: screen-space ray march toward the light.

Port of the Tiny Glade / kajiya hybrid-root-finder technique as used in
gltf.frag:114-363 (upstream: the vendored raymarch.hlsl): 8 jittered linear
steps + 4 bisection steps against the scene depth buffer, sampled with BOTH
bilinear and nearest filters (the dual-sampler trick that rejects
stair-step and shrink-wrap artifacts, gltf.frag:143-169).

The loop is batch-parallel over pixels — a dense array program; the
sequential `break` in the shader becomes a carried `intersected` mask.

Depth source: the reference binds the depth buffer of swapchain image 0 and
never updates that descriptor (gltf_renderer.rs:408-416), so it effectively
ray-marches against a *stale* depth buffer from a previous frame. We define
this cleanly: the previous frame's depth is carried state (prev_depth in
the frame state), giving the same one-frame-lagged behavior without the
race.

Depth linearization: the reference approximates linear depth as
1/ndc_depth (gltf.frag:159-160, 270) — a reverse-Z-ism left over from the
kajiya source that, fed with a VALID standard-Z depth buffer, makes every
surface "hit" immediately (the whole ground darkens ~15% and the model
fully self-shadows; in the reference build the artifact is masked because
the bound depth image is in an un-sampleable layout). We implement the
algorithm's documented intent instead: exact view-space linearization
d = near*far / (far - z*(far-near)) (the formula in gltf.frag:132-139's
own comment), with the depth-thickness test in real world units.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sampling import (quad_pack, sample_depth_dual_packed,
                            sample_depth_dual_window, take_rows)
from .shadow_filter import interleaved_gradient_noise
from .uniforms import FrameUniforms

LINEAR_STEPS = 8        # gltf.frag:345
BISECTION_STEPS = 4     # gltf.frag:346
TRACE_DISTANCE = 0.5    # gltf.frag:335
DEPTH_THICKNESS = 0.05  # gltf.frag:347
MAX_DARKNESS = 0.8      # gltf.frag:359


def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


NEAR = 0.1     # the actual projection planes (gltf_renderer.rs:1818) —
FAR = 100.0    # NOT getLinearDepth's stale 1000 constant (gltf.frag:137)


def _linearize(ndc_z):
    """Exact view-space depth from standard-Z NDC depth
    (gltf.frag:132-139's documented formula)."""
    denom = jnp.maximum(FAR - ndc_z * (FAR - NEAR), 1e-3)
    return NEAR * FAR / denom


def _sample_depth_dual(depth_packed, uv):
    """gltf.frag:150-169: linearized depth from both filter modes,
    max for hit detection, min for penetration. depth_packed is the
    quad-packed (H, W, 4) depth buffer — one gathered row yields BOTH the
    bilinear and nearest reads (the reference needs two sampler binds;
    we need one row fetch)."""
    raw_linear, raw_nearest = sample_depth_dual_packed(depth_packed, uv)
    d_lin = _linearize(raw_linear)
    d_nst = _linearize(raw_nearest)
    return jnp.maximum(d_lin, d_nst), jnp.minimum(d_lin, d_nst)


def _ray_setup(world: jnp.ndarray, normal: jnp.ndarray,
               uni: FrameUniforms):
    """World ray toward the light -> clipped NDC march segment
    (gltf.frag:199-245). Returns (march_start, march_dir, on_screen,
    facing) with leading batch shape = world.shape[:-1]."""
    light_dir = uni.light_dir
    n_dot_l = jnp.sum(normal * light_dir, axis=-1)
    facing = n_dot_l > 0.0

    start = world + normal * 0.01                      # gltf.frag:332
    end = start + light_dir * TRACE_DISTANCE

    vp = uni.proj @ uni.view
    ones = jnp.ones(world.shape[:-1] + (1,), jnp.float32)

    def to_cs(p):
        clip = jnp.einsum("ij,...j->...i",
                          vp, jnp.concatenate([p, ones], axis=-1))
        return clip[..., :3] / jnp.where(
            jnp.abs(clip[..., 3:4]) > 1e-12, clip[..., 3:4], 1e-12)

    start_cs = to_cs(start)
    end_cs = to_cs(end)
    ray_dir = end_cs - start_cs

    # Slab-clip the ray to NDC bounds: XY to [-1,1], Z to [0,1]
    # (gltf.frag:209-236).
    t_min = jnp.zeros(facing.shape, jnp.float32)
    t_max = jnp.ones(facing.shape, jnp.float32)
    for axis, lo, hi in ((0, -1.0, 1.0), (1, -1.0, 1.0), (2, 0.0, 1.0)):
        d = ray_dir[..., axis]
        s = start_cs[..., axis]
        safe_d = jnp.where(jnp.abs(d) > 1e-4, d, 1.0)
        t1 = (lo - s) / safe_d
        t2 = (hi - s) / safe_d
        t_lo = jnp.minimum(t1, t2)
        t_hi = jnp.maximum(t1, t2)
        moving = jnp.abs(d) > 1e-4
        t_min = jnp.where(moving, jnp.maximum(t_min, t_lo), t_min)
        t_max = jnp.where(moving, jnp.minimum(t_max, t_hi), t_max)

    on_screen = t_min < t_max

    march_start = start_cs + ray_dir * t_min[..., None]
    march_dir = (start_cs + ray_dir * t_max[..., None]) - march_start
    return march_start, march_dir, on_screen, facing


def _march(depth_packed: jnp.ndarray, march_start: jnp.ndarray,
           march_dir: jnp.ndarray, jitter: jnp.ndarray,
           window=None) -> jnp.ndarray:
    """The 8-linear + 4-bisection hybrid root find (gltf.frag:253-318,
    341-349) on any batch shape. Returns (intersected, max_t, last_pen).
    `window` = (win (cw, cw, 4), origin (oy, ox), (H, W)) routes the
    dual-depth reads through a dynamic-sliced sub-table (sub-cliff
    gather rate; committed-mode march windows)."""
    shape = jitter.shape
    min_t = jnp.zeros(shape, jnp.float32)
    max_t = jnp.ones(shape, jnp.float32)
    intersected = jnp.zeros(shape, bool)
    last_pen = jnp.zeros(shape, jnp.float32)

    def probe(t):
        """Sample along the ray at parameter t: returns
        (hit_condition, penetration, uv_in_bounds)."""
        cs = march_start + march_dir * t[..., None]
        uv = cs[..., :2] * 0.5 + 0.5
        inb = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
               & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0))
        if window is not None:
            raw_l, raw_n = sample_depth_dual_window(
                window[0], window[1], window[2], uv)
            d_max = jnp.maximum(_linearize(raw_l), _linearize(raw_n))
            d_min = jnp.minimum(_linearize(raw_l), _linearize(raw_n))
        else:
            d_max, d_min = _sample_depth_dual(depth_packed, uv)
        ray_depth = _linearize(cs[..., 2])
        # ray behind the surface (farther than stored depth) => occluded
        distance = d_max - ray_depth
        penetration = ray_depth - d_min
        valid = penetration < DEPTH_THICKNESS
        return (distance < 0.0) & valid, penetration, inb

    # Linear phase with first-hit semantics (gltf.frag:253-290). The 8
    # probes are data-independent, so their dual samples ride ONE batched
    # gather (sequential small gather ops cost ~4x more per row — see
    # shadow_filter.vogel_disk_all); only the cheap dense first-hit
    # selection stays sequential.
    steps = jnp.arange(LINEAR_STEPS, dtype=jnp.float32).reshape(
        (LINEAR_STEPS,) + (1,) * jitter.ndim)
    t_all = (steps + jitter[None]) / LINEAR_STEPS
    hit_all, pen_all, inb_all = probe(t_all)
    for step in range(LINEAR_STEPS):
        t = t_all[step]
        hit, pen, inb = hit_all[step], pen_all[step], inb_all[step]
        active = ~intersected & inb        # `continue` skips oob samples
        new_hit = active & hit
        max_t = jnp.where(new_hit, t, max_t)
        last_pen = jnp.where(new_hit, pen, last_pen)
        min_t = jnp.where(active & ~hit, t, min_t)
        intersected = intersected | new_hit

    # Bisection refinement (gltf.frag:293-312).
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (min_t + max_t)
        hit, pen, _ = probe(mid)
        go = intersected
        max_t = jnp.where(go & hit, mid, max_t)
        last_pen = jnp.where(go & hit, pen, last_pen)
        min_t = jnp.where(go & ~hit, mid, min_t)
    return intersected, max_t, last_pen


def _soft_term(intersected, max_t, last_pen):
    """Soft falloff (gltf.frag:351-362)."""
    strength = 1.0 - _smoothstep(0.0, 0.5, max_t)
    pen_fade = 1.0 - _smoothstep(0.0, DEPTH_THICKNESS, last_pen)
    shadowed = 1.0 - strength * pen_fade * MAX_DARKNESS
    return jnp.where(intersected, shadowed, 1.0)


def _jitter(h, w, y0, frame):
    """Per-pixel march jitter (gltf.frag:338): IGN of fragCoord + frame."""
    frag_x = jnp.broadcast_to(
        jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5, (h, w))
    frag_y = jnp.broadcast_to(
        jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
        + jnp.asarray(y0, jnp.float32), (h, w))
    return interleaved_gradient_noise(jnp.stack(
        [frag_x + frame * 13.37, frag_y + frame * 17.17], axis=-1))


def _jitter_at(frag, frame):
    """_jitter on explicit pixel centers (x+0.5 convention), any batch."""
    return interleaved_gradient_noise(jnp.stack(
        [frag[..., 0] + frame * 13.37, frag[..., 1] + frame * 17.17],
        axis=-1))


def compute_contact_shadow(world: jnp.ndarray, normal: jnp.ndarray,
                           uni: FrameUniforms, prev_depth: jnp.ndarray,
                           y0=0, frag: jnp.ndarray | None = None
                           ) -> jnp.ndarray:
    """gltf.frag:324-363. Returns the shadow factor in [0, 1] for a row
    slab at global row y0 (frag=None), or for any batch with explicit
    `frag` pixel centers; prev_depth is always full-frame (rays can
    cross slab boundaries)."""
    # barrier: keep the packing rolls out of the probes' gather fusions
    depth_packed = jax.lax.optimization_barrier(quad_pack(prev_depth))

    march_start, march_dir, on_screen, facing = _ray_setup(world, normal,
                                                           uni)
    if frag is None:
        h, w = world.shape[:2]
        jitter = _jitter(h, w, y0, uni.debug_flags[3])
    else:
        jitter = _jitter_at(frag, uni.debug_flags[3])
    intersected, max_t, last_pen = _march(depth_packed, march_start,
                                          march_dir, jitter)
    term = _soft_term(intersected & on_screen & facing, max_t, last_pen)
    return term


# ---------------------------------------------------------------------------
# Sparse evaluation: an analytic-plane residual certificate proves most
# rays cannot hit anything, so only a small compacted set runs the exact
# 12-probe march. The certificate is sound for ANY reference plane (the
# residual is MEASURED against it), so correctness never depends on the
# scene actually containing a ground plane — only the retire rate does.
#
# Theory: a probe at screen point q hits only if the dual-sampled stored
# depth max(bilinear, nearest) < ray_ndc (gltf.frag:270-273; the
# linearization is monotone on stored depths <= 1). A plane's NDC depth
# is AFFINE in screen coordinates (planes map to planes under projective
# transforms), and bilinear interpolation REPRODUCES affine fields
# exactly at interior texels, so with the residual field
#     R = stored_depth - min(plane_ndc, 1)          (per texel)
# we get   bilinear(stored at q) >= bound(q) + min R over the footprint,
# where bound(q) = plane_ndc(q) where the footprint stays below the
# horizon clamp, 1.0 fully above it, and min(plane,1) - slope_margin in
# the transition band. The ray leaves its receiver toward the light
# (plus the 0.01 normal offset, gltf.frag:332), so ray_ndc sits BELOW the
# plane depth along its own view ray — a positive analytic gap that only
# f32 noise (covered by min R and a rounding epsilon) can eat. Ground and
# sky texels have R ~= 0; only geometry closer than the plane (the duck)
# makes R substantially negative.
#
# Stage 1 (dense, ZERO gathers — round-4 restructure): the only texels
#   with R < -eps lie inside a MEASURED screen bbox (two dense reduces
#   over the residual map); outside that bbox min R >= -eps is a frame
#   constant. cs_z(t) and plane(q(t)) are both AFFINE in the march
#   parameter t, so the certificate gap over any segment interval is
#   convex and its max sits at the interval endpoints — the whole-ray
#   check collapses to evaluating the gap at 4 endpoint parameters
#   (segment start/end + bbox entry/exit from a 2D slab test). Rays whose
#   segment misses the bbox and certify at the endpoints can never hit,
#   for ANY probe jitter. This replaces the r3 per-probe loop + box-min
#   pyramid gathers (the 29.6 ms contact bill was mostly this stage).
# Stage 2 (compacted, 8 level-0 rows): per-probe +-2px boxes -> retires
#   the shell around the occluder bbox.
# Stage 3 (compacted): the exact hybrid march.
# Overflow at either capacity falls back to the dense march (exact).
# ---------------------------------------------------------------------------

from typing import NamedTuple  # noqa: E402

FOOT = 2.0        # dual-sampler footprint half-width in texels (the quad
#                   base spans [floor(x-0.5), floor(x-0.5)+1])


class ResidualPyramid(NamedTuple):
    """Level-0 min-R map + the measured occluder bbox (see stage-1 notes
    above). Higher pyramid levels died with the r3 box-min stage."""
    rows: jnp.ndarray          # (lh * lw, 4) quad-packed level-0 min-R
    lw: int                    # level-0 cells per row (static)
    lh: int
    base: int                  # level-0 cell size in pixels
    plane: jnp.ndarray         # (3,) [a, b, c]: plane_ndc = a*px + b*py + c
    eps: jnp.ndarray           # () f32 conservative f32-rounding slack
    occl_lo: jnp.ndarray       # (2,) f32 (x, y) pixel bbox of {R < -eps},
    occl_hi: jnp.ndarray       # padded by FOOT + 1.5; lo > hi when empty


_PAD_BIG = 1e9    # min-reduce padding: never drives a window minimum down


def _reduce_min(d: jnp.ndarray, f: int) -> jnp.ndarray:
    """f x f min pool. Layout-aware: reduce the ROW axis first (layout-
    free reshape), then the lane axis as a minor-dim reduce — the naive
    reshape.min((1, 3)) puts f on the lane dim and relayouts the full
    map before every reduce (same pathology as shadow_classify._cell_max;
    experiments/bench_cellmax.py measured 2.45 ms vs 0.91 at 2048^2)."""
    h, w = d.shape
    d = jnp.pad(d, ((0, -h % f), (0, -w % f)), constant_values=_PAD_BIG)
    hp, wp = d.shape
    rows = d.reshape(hp // f, f, wp).min(axis=1)           # (hp/f, wp)
    return rows.reshape(hp // f, wp // f, f).min(axis=-1)


def reference_plane(positions: jnp.ndarray, tri_indices: jnp.ndarray,
                    view_proj: jnp.ndarray, width: int,
                    height: int) -> jnp.ndarray:
    """Residual reference plane [a, b, c] = the screen-space z-plane the
    RASTERIZER itself uses for the ground (the scene's first triangle,
    object 0, identity model — models/scene.py packs the ground quad
    first), under `view_proj` — recomputed through the very same
    near-clip expansion + triangle_setup_corners math (ops/clipping.py,
    ops/binning.py) the main raster runs, so ground residuals
    R = depth - plane are ~0 by construction (fma-regrouping ulps only).

    Near-clip expansion matters (r5 fix, VERDICT r4 weak-1): at orbit
    poses the big ground quad CROSSES the near plane, both raw triangles
    fail the w-cull, and the r4 plane degenerated to [0,0,0] — stage 1
    stopped retiring anything and every sparse contact cap ballooned to
    ~the full frame (the 10.17 -> 4.34 FPS regression). The depth buffer
    at those views holds the clipped SUB-triangles' z-planes, so the
    certificate must be built from exactly those setups.

    All rendered ground planes (surviving originals + clip sub-
    triangles) describe the same geometric plane up to f32 setup
    rounding (~4e-7 between the quad's halves at 1080p); the returned
    plane is the first valid one shifted DOWN by the exact worst-case
    screen-corner gap to every other valid one, so R >= -(eval noise)
    on all of them.

    Why not fit from projected points (fit_ground_plane below)? A fit
    reproduces the TRUE plane, but the depth buffer holds the RASTERIZED
    plane — the two differ by up to ~1.4e-6 at 1080p (measured,
    experiments/contact_plane_probe.py), which is past the certificate's
    f32 slack and turned most of the ground into "occluder" bbox.

    Degenerate references (ground fully behind the camera / zero area)
    yield the [0,0,0] sentinel: the certificate stops retiring, stages
    2-3 still bound the cost."""
    from ..ops.binning import triangle_setup_corners
    from ..ops.clipping import expand_near_clipped

    corners = positions[tri_indices[:2]]                   # (2, 3, 3)
    ones = jnp.ones((2, 3, 1), jnp.float32)
    tri_clip = jnp.concatenate([corners, ones], axis=-1) @ view_proj.T
    # Identical clip plane to frame._main_raster_inputs (w = NEAR/10).
    g = expand_near_clipped(
        tri_clip, jnp.zeros((2, 3, 1), jnp.float32),
        jnp.zeros((2,), jnp.int32), 2, capacity=2, w_eps=NEAR * 0.1)
    setup = triangle_setup_corners(g.tri_clip, width, height, g.valid)
    zp = setup.data[:, 9:12]                               # (T', 3)
    valid = setup.valid
    any_valid = jnp.any(valid)
    base_i = jnp.argmax(valid)
    base = zp[base_i]
    # Exact affine extrema sit at the screen corners: evaluate every
    # plane there and shift the base below the lowest valid one.
    corners_m = jnp.asarray(
        [[0.0, float(width), 0.0, float(width)],
         [0.0, 0.0, float(height), float(height)],
         [1.0, 1.0, 1.0, 1.0]], jnp.float32)               # (3, 4)
    vals = zp @ corners_m                                  # (T', 4)
    gaps = jnp.where(valid[:, None], vals[base_i][None] - vals, -jnp.inf)
    shift = jnp.maximum(jnp.max(gaps), 0.0)
    plane = base - jnp.stack([jnp.zeros(()), jnp.zeros(()), shift])
    return jnp.where(any_valid, plane, jnp.zeros((3,), jnp.float32))


def fit_ground_plane(view_proj: jnp.ndarray, width: int, height: int,
                     camera_pos: jnp.ndarray,
                     plane_y: float = 0.0) -> jnp.ndarray:
    """Screen-space NDC-depth plane [a, b, c] of the world plane y=plane_y
    under `view_proj`, fitted from 3 projected on-plane points near the
    camera's ground footprint (well-conditioned in f32, unlike a 4x4
    inverse whose conditioning ~ far/near). Degenerate views (camera in
    the plane, points behind the eye) yield useless-but-sound
    coefficients: the certificate just stops retiring pixels."""
    cx, cy, cz = camera_pos[0], camera_pos[1], camera_pos[2]
    # Points on the plane around the camera's vertical drop point, spread
    # a few units so their projections span a good screen area.
    base = jnp.stack([cx, jnp.asarray(plane_y, jnp.float32), cz])
    pts = jnp.stack([
        base + jnp.asarray([0.0, 0.0, -4.0], jnp.float32),
        base + jnp.asarray([3.0, 0.0, -9.0], jnp.float32),
        base + jnp.asarray([-3.0, 0.0, -9.0], jnp.float32),
    ])                                                     # (3, 3)
    ones = jnp.ones((3, 1), jnp.float32)
    clip = jnp.concatenate([pts, ones], axis=-1) @ view_proj.T
    w = clip[:, 3]
    w = jnp.where(jnp.abs(w) > 1e-4, w, 1e-4)
    ndc = clip[:, :3] / w[:, None]
    px = (ndc[:, 0] + 1.0) * (0.5 * width)    # raster convention
    py = (ndc[:, 1] + 1.0) * (0.5 * height)   # (ops/binning.py viewport)
    a_mat = jnp.stack([px, py, jnp.ones(3, jnp.float32)], axis=-1)
    det = jnp.linalg.det(a_mat)
    safe = jnp.where(jnp.abs(det) > 1e-6, det, 1e-6)
    # Cramer's rule (3x3), f32-fine for screen-spread points.
    sol = []
    for k in range(3):
        m = a_mat.at[:, k].set(ndc[:, 2])
        sol.append(jnp.linalg.det(m) / safe)
    return jnp.stack(sol)


def build_residual_pyramid(prev_depth: jnp.ndarray, plane: jnp.ndarray,
                           base: int = 8) -> ResidualPyramid:
    """Level-0 min map (base x base cells, quad-packed so a 2x2-cell
    window is ONE gathered row) of R = stored - min(plane_ndc, 1), plus
    the measured pixel bbox of {R < -eps} — the only region where a
    window minimum of R can sit below -eps. Two dense reduces; no
    multi-level chain (stage 1 no longer box-min-gathers)."""
    h, w = prev_depth.shape
    xs = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5
    ys = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
    plane_tex = plane[0] * xs + plane[1] * ys + plane[2]
    resid = prev_depth - jnp.minimum(plane_tex, 1.0)

    # f32 slack: texel-eval rounding of the plane (scales with its term
    # magnitudes) + residual subtraction rounding.
    eps = ((jnp.abs(plane[0]) * w + jnp.abs(plane[1]) * h
            + jnp.abs(plane[2])) * 4e-7 + 2e-7)

    # Occluder bbox: row/col "any" reductions -> first/last index. Padded
    # by the dual-sampler footprint so any q whose footprint touches an
    # occluder texel tests inside. Empty map -> lo > hi sentinel.
    occ = resid < -eps
    col_any = jnp.any(occ, axis=0)
    row_any = jnp.any(occ, axis=1)
    any_occ = jnp.any(occ)

    def span(any_vec, n):
        lo = jnp.argmax(any_vec).astype(jnp.float32)
        hi = (n - jnp.argmax(any_vec[::-1])).astype(jnp.float32) - 1.0
        return lo, hi

    x_lo, x_hi = span(col_any, w)
    y_lo, y_hi = span(row_any, h)
    pad = FOOT + 1.5
    big = jnp.float32(w + h)
    occl_lo = jnp.where(any_occ,
                        jnp.stack([x_lo, y_lo]) - pad,
                        jnp.stack([big, big]))
    occl_hi = jnp.where(any_occ,
                        jnp.stack([x_hi, y_hi]) + pad,
                        jnp.stack([-big, -big]))

    d0 = _reduce_min(resid, base)
    lh, lw = d0.shape
    return ResidualPyramid(
        rows=quad_pack(d0).reshape(lh * lw, 4),
        lw=lw, lh=lh, base=base,
        plane=plane, eps=eps,
        occl_lo=occl_lo, occl_hi=occl_hi)


def _point_min_l0(pyr: ResidualPyramid, p: jnp.ndarray) -> jnp.ndarray:
    """Lower bound of R over [p - FOOT, p + FOOT]: level-0 cells (base >=
    2*FOOT) always cover a point footprint with one quad window."""
    lo = p - FOOT
    cx = jnp.clip(jnp.floor(lo[..., 0] / pyr.base).astype(jnp.int32),
                  0, pyr.lw - 1)
    cy = jnp.clip(jnp.floor(lo[..., 1] / pyr.base).astype(jnp.int32),
                  0, pyr.lh - 1)
    quad = take_rows(pyr.rows, cy * pyr.lw + cx)          # (..., 4)
    return jnp.min(quad, axis=-1)


def _probe_bound(pyr: ResidualPyramid, q: jnp.ndarray, size: jnp.ndarray):
    """Analytic lower bound of the dual-sampled stored depth at screen
    point q (pixels), BEFORE adding the box min-R: handles the horizon
    clamp (min(plane,1) is concave, so bilinear reproduction only holds
    where the footprint is entirely on one side) and the edge-clamp band
    at the screen border."""
    a, b, c = pyr.plane[0], pyr.plane[1], pyr.plane[2]
    plane_q = a * q[..., 0] + b * q[..., 1] + c
    m = (jnp.abs(a) + jnp.abs(b)) * (FOOT + 0.5)
    bound = jnp.where(
        plane_q + m <= 1.0, plane_q,
        jnp.where(plane_q - m >= 1.0, 1.0,
                  jnp.minimum(plane_q, 1.0) - m))
    band = ((q[..., 0] < FOOT) | (q[..., 0] > size[0] - FOOT)
            | (q[..., 1] < FOOT) | (q[..., 1] > size[1] - FOOT))
    return bound - jnp.where(band, m, 0.0)


def _segment_cert(pyr: ResidualPyramid, march_start, march_dir, size):
    """Whole-segment no-hit certificate for the parts of each march
    segment OUTSIDE the measured occluder bbox — pure arithmetic, zero
    gathers, independent of probe jitter.

    Why endpoints suffice: cs_z(t) and plane(q(t)) are both affine in t
    (q(t) is affine: the segment is already in NDC), so on any interval
      gap(t) = cs_z(t) - bound(q(t))
    is affine when bound = plane (footprint below the horizon clamp) or
    bound = 1, and convex when bound = min(plane, 1) - m (min of affine
    and constant is concave; negating makes the gap convex) — in every
    case the max over the interval sits at an endpoint. The intervals
    outside the bbox are [0, t_in] and [t_out, 1] from a 2D slab test,
    and outside the bbox min R >= -eps by construction of the bbox.

    Returns (certified, intersects): `certified` = no probe outside the
    bbox can ever hit; `intersects` = the segment enters the bbox (those
    probes go to stage 2)."""
    p0 = (march_start[..., :2] * 0.5 + 0.5) * size
    p1 = ((march_start[..., :2] + march_dir[..., :2]) * 0.5 + 0.5) * size

    # 2D slab test of the segment against the padded occluder bbox.
    t_in = jnp.zeros(p0.shape[:-1], jnp.float32)
    t_out = jnp.ones(p0.shape[:-1], jnp.float32)
    for axis in range(2):
        d = p1[..., axis] - p0[..., axis]
        s = p0[..., axis]
        safe_d = jnp.where(jnp.abs(d) > 1e-6, d, 1e-6)
        t1 = (pyr.occl_lo[axis] - s) / safe_d
        t2 = (pyr.occl_hi[axis] - s) / safe_d
        lo_t = jnp.minimum(t1, t2)
        hi_t = jnp.maximum(t1, t2)
        moving = jnp.abs(d) > 1e-6
        inside = (s >= pyr.occl_lo[axis]) & (s <= pyr.occl_hi[axis])
        # parallel-to-axis segments: inside the slab for all t or none
        t_in = jnp.where(moving, jnp.maximum(t_in, lo_t),
                         jnp.where(inside, t_in, 2.0))
        t_out = jnp.where(moving, jnp.minimum(t_out, hi_t),
                          jnp.where(inside, t_out, -1.0))
    # Empty-bbox sentinel (lo > hi): the per-axis min/max above UNDOES
    # the inversion (t1/t2 get swapped back), silently turning "no
    # occluders" into a whole-plane slab — gate explicitly (r5 fix; with
    # the r4 degenerate plane this made EVERY ray "intersect" an empty
    # bbox at orbit poses).
    nonempty = pyr.occl_lo[0] <= pyr.occl_hi[0]
    intersects = (nonempty & (t_in <= t_out) & (t_in <= 1.0)
                  & (t_out >= 0.0))
    a = jnp.where(intersects, jnp.clip(t_in, 0.0, 1.0), 1.0)
    b = jnp.where(intersects, jnp.clip(t_out, 0.0, 1.0), 1.0)

    # Gap check at the 4 interval endpoints {0, a} u {b, 1}. Every
    # per-interval quantity below is constant over the interval, so the
    # convexity argument in the docstring applies to each case's bound.
    aa, bb = pyr.plane[0], pyr.plane[1]
    m = (jnp.abs(aa) + jnp.abs(bb)) * (FOOT + 0.5)
    thresh = -pyr.eps - pyr.eps

    def endpoint(t):
        cs_z = march_start[..., 2] + march_dir[..., 2] * t
        q = p0 + (p1 - p0) * t[..., None]
        plane_q = aa * q[..., 0] + bb * q[..., 1] + pyr.plane[2]
        return cs_z, plane_q, q

    def interval_ok(ts, te):
        z_s, pl_s, q_s = endpoint(ts)
        z_e, pl_e, q_e = endpoint(te)
        # Border-band touch per side: each screen coordinate is affine in
        # t, so its interval min/max sit at the endpoints — the interval
        # touches a side's band iff an endpoint extreme does.
        touch = jnp.zeros(ts.shape, bool)
        for k in range(2):
            cmin = jnp.minimum(q_s[..., k], q_e[..., k])
            cmax = jnp.maximum(q_s[..., k], q_e[..., k])
            touch = touch | (cmin < FOOT) | (cmax > size[k] - FOOT)
        pen = m + jnp.where(touch, m, 0.0)        # constant per interval
        # case C (always valid): bound = min(plane,1) - pen, gap convex.
        okc = ((z_s - (jnp.minimum(pl_s, 1.0) - pen) <= thresh)
               & (z_e - (jnp.minimum(pl_e, 1.0) - pen) <= thresh))
        # case A: footprint below the horizon clamp and off the border
        # for the whole interval -> bilinear reproduces the plane exactly,
        # bound = plane_q, gap affine.
        case_a = (jnp.maximum(pl_s, pl_e) + m <= 1.0) & ~touch
        oka = case_a & (z_s - pl_s <= thresh) & (z_e - pl_e <= thresh)
        # case B: fully above the clamp -> bound = 1, gap affine.
        case_b = (jnp.minimum(pl_s, pl_e) - m >= 1.0) & ~touch
        okb = case_b & (z_s <= 1.0 + thresh) & (z_e <= 1.0 + thresh)
        return okc | oka | okb

    zeros = jnp.zeros_like(a)
    ones = jnp.ones_like(a)
    cert = interval_ok(zeros, a) & interval_ok(b, ones)
    return cert, intersects


def _stage2_certify(pyr: ResidualPyramid, start, direction, jitter,
                    size) -> jnp.ndarray:
    """Per-probe level-0 box re-certification (stage 2) on any batch
    shape — all 8 probes' box rows ride ONE batched gather (per-op
    overhead dominates small sequential gathers), the rest is dense
    arithmetic. Shared by the sparse path and contact_occupancy so
    capacity sizing can't drift from the real stage-3 mask."""
    steps = jnp.arange(LINEAR_STEPS, dtype=jnp.float32).reshape(
        (LINEAR_STEPS,) + (1,) * jitter.ndim)
    t_all = (steps + jitter[None]) / LINEAR_STEPS
    cs = start[None] + direction[None] * t_all[..., None]
    uv = cs[..., :2] * 0.5 + 0.5
    inb = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
           & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0))
    q = uv * size
    min_r = _point_min_l0(pyr, q)
    bound = _probe_bound(pyr, q, size)
    ok = cs[..., 2] <= bound + min_r - pyr.eps
    return jnp.all(~inb | ok, axis=0)


def contact_classify(pyr: ResidualPyramid, march_start, march_dir,
                     cand, depth_shape):
    """Stage-1 dense certification: whole-segment convex gap check against
    the measured occluder bbox (_segment_cert — zero gathers, any batch
    shape, jitter-independent). Returns the stage-2 candidate mask (hit
    possible): rays whose segment enters the bbox, or whose out-of-bbox
    gap check fails (horizon band, screen border, steep receivers)."""
    hd, wd = depth_shape
    size = jnp.asarray([wd, hd], jnp.float32)
    cert, intersects = _segment_cert(pyr, march_start, march_dir, size)
    return cand & (intersects | ~cert)


def contact_occupancy(world: jnp.ndarray, normal: jnp.ndarray,
                      uni: FrameUniforms, prev_depth: jnp.ndarray, y0=0,
                      valid: jnp.ndarray | None = None,
                      plane: jnp.ndarray | None = None):
    """Diagnostic: dense per-stage counts for sizing
    GltfConfig.contact_capacity / contact_march_capacity (run offline;
    the stage-2 refine is evaluated densely here). Pass the SAME `plane`
    the frame passes (reference_plane) or capacities get sized for a
    different stage-2 set."""
    h, w = world.shape[:2]
    hd, wd = prev_depth.shape
    size = jnp.asarray([wd, hd], jnp.float32)
    if plane is None:
        plane = fit_ground_plane(uni.prev_view_proj, wd, hd,
                                 uni.camera_pos)
    pyr = build_residual_pyramid(prev_depth, plane)
    march_start, march_dir, on_screen, facing = _ray_setup(world, normal,
                                                           uni)
    jitter = _jitter(h, w, y0, uni.debug_flags[3])
    cand = facing & on_screen
    if valid is not None:
        cand = cand & valid
    stage2 = contact_classify(pyr, march_start, march_dir, cand,
                              prev_depth.shape)
    cert2 = _stage2_certify(pyr, march_start, march_dir, jitter, size)
    st3 = stage2 & ~cert2
    # Stage-3 probe bbox extent (pixels) — sizes the committed-mode
    # march window (GltfConfig.contact_window): probes lie on the
    # segment between the endpoints, so the {p0, p1} bbox over stage-3
    # rays (+ dual-sampler footprint) bounds them all.
    p0 = (march_start[..., :2] * 0.5 + 0.5) * size
    p1 = ((march_start[..., :2] + march_dir[..., :2]) * 0.5 + 0.5) * size
    big = jnp.float32(1 << 28)
    m = st3[..., None]
    lo = jnp.min(jnp.where(m, jnp.minimum(p0, p1), big), axis=tuple(
        range(st3.ndim)))
    hi = jnp.max(jnp.where(m, jnp.maximum(p0, p1), -big), axis=tuple(
        range(st3.ndim)))
    ext = jnp.where(jnp.any(st3),
                    jnp.ceil(jnp.max(hi - lo) + 2.0 * (FOOT + 1.0)),
                    0.0).astype(jnp.int32)
    return {"_stage2": stage2,  # raw mask (block-occupancy diagnostics)
            "contact_stage2": jnp.sum(stage2),
            "contact_march": jnp.sum(st3),
            "contact_march_extent": ext}


def compute_contact_shadow_sparse(world: jnp.ndarray, normal: jnp.ndarray,
                                  uni: FrameUniforms,
                                  prev_depth: jnp.ndarray, y0=0,
                                  capacity: int | None = None,
                                  march_capacity: int | None = None,
                                  valid: jnp.ndarray | None = None,
                                  block_capacity: int | None = None,
                                  frag: jnp.ndarray | None = None,
                                  plane: jnp.ndarray | None = None,
                                  committed: bool = False,
                                  march_window: int | None = None
                                  ) -> jnp.ndarray:
    """Sparse-exact contact shadows: identical outputs to
    compute_contact_shadow where `valid` (geometry coverage — sky pixels'
    terms are never consumed downstream). `capacity` bounds the stage-2
    per-probe-refine set (default pixels // 4), `march_capacity` the
    exact-march set (default capacity // 4); overflow at either falls back
    to the dense march (exact, slower). Size both from
    utils.diagnostics.measure_sparse_occupancy.

    Domain layouts: row slab (h, W) with y0 (frag=None), or any batch
    shape with explicit `frag` pixel centers (the blocked back half's
    flat compacted domain — two-level compaction then uses 64-runs)."""
    from ..ops.compact import (Compacted, compact_indices,
                               compact_indices_blocked, gather_rows,
                               scatter_back)

    batch = world.shape[:-1]
    hd, wd = prev_depth.shape
    n = int(np.prod(batch))
    cap2 = capacity if capacity is not None else max(n // 4, 256)
    cap3 = march_capacity if march_capacity is not None else max(
        cap2 // 4, 256)
    size = jnp.asarray([wd, hd], jnp.float32)

    depth_packed = jax.lax.optimization_barrier(quad_pack(prev_depth))
    # The residual plane belongs to prev_depth's frame: prev_view_proj.
    # Callers pass reference_plane (the rasterizer's own ground z-plane);
    # the point fit is a fallback whose residual noise (~1.4e-6 at 1080p)
    # de-certifies most of the ground — see reference_plane's docstring.
    if plane is None:
        plane = fit_ground_plane(uni.prev_view_proj, wd, hd,
                                 uni.camera_pos)
    pyr = build_residual_pyramid(prev_depth, plane)

    march_start, march_dir, on_screen, facing = _ray_setup(world, normal,
                                                           uni)
    if frag is None:
        h, w = batch
        jitter = _jitter(h, w, y0, uni.debug_flags[3])
    else:
        jitter = _jitter_at(frag, uni.debug_flags[3])

    # Footprints are in DEPTH-BUFFER pixels (uv spans the full frame even
    # when this slab is subsampled or row-sharded).
    cand = facing & on_screen
    if valid is not None:
        cand = cand & valid

    stage2 = contact_classify(pyr, march_start, march_dir, cand,
                              prev_depth.shape)

    # Stage-2 pixels cluster around real occluders: two-level compaction
    # (block-grid argsort), but only with a TUNED block budget — the
    # untuned default would make the candidate domain ~the full domain
    # and just add overhead.
    fits_blocks = jnp.ones((), bool)
    if (block_capacity is not None and stage2.ndim == 2
            and batch[0] % 8 == 0 and batch[1] % 8 == 0):
        blocked = compact_indices_blocked(stage2, cap2, 8, 8,
                                          block_capacity)
        comp2 = blocked.comp
        fits_blocks = blocked.block_count <= block_capacity
    elif (block_capacity is not None and stage2.ndim == 1
          and n % 64 == 0):
        blocked = compact_indices_blocked(stage2.reshape(n // 64, 64),
                                          cap2, 1, 64, block_capacity)
        comp2 = blocked.comp
        fits_blocks = blocked.block_count <= block_capacity
    else:
        comp2 = compact_indices(stage2, cap2)
    payload = jnp.concatenate(
        [march_start, march_dir, jitter[..., None]], axis=-1).reshape(n, 7)
    rows2 = gather_rows(payload, comp2)
    start2, dir2, jit2 = rows2[:, 0:3], rows2[:, 3:6], rows2[:, 6]

    # Stage 2: re-certify with tight per-probe level-0 boxes (shared
    # helper; retires the shell created by stage 1's whole-ray box
    # dilation around real occluders).
    cert2 = _stage2_certify(pyr, start2, dir2, jit2, size)

    # Stage 3: exact march on the survivors (compacted within comp2's
    # slot domain, then composed back to global flat indices).
    stage3 = comp2.slot_valid & ~cert2
    comp3_local = compact_indices(stage3, cap3)
    safe_slot = jnp.maximum(comp3_local.idx, 0)
    comp3 = Compacted(
        idx=jnp.where(comp3_local.slot_valid, comp2.idx[safe_slot], -1),
        slot_valid=comp3_local.slot_valid,
        count=comp3_local.count)

    fits = (comp2.count <= cap2) & (comp3.count <= cap3) & fits_blocks

    def eval_sparse(_):
        dense = jnp.ones((n,), jnp.float32)
        rows = gather_rows(payload, comp3)
        start3, dir3, jit3 = rows[:, 0:3], rows[:, 3:6], rows[:, 6]
        window = None
        if committed and march_window is not None \
                and march_window < min(hd, wd):
            # Committed-mode march window (r5): stage-3 survivors cluster
            # around the occluder bbox, so their 12 probes read a
            # dynamic-sliced sub-table of prev_depth at the sub-cliff
            # gather rate instead of the full 33 MB packed frame. Probes
            # lie on the segment between the endpoints, so the entry
            # bbox of {p0, p1} (+ dual-sampler footprint) bounds them
            # all. An entry past the static window clamps to the edge
            # (bounded local artifact); the driver polls the measured
            # extent (contact_march_extent in capacity_overflows).
            cw = march_window
            p0 = (start3[:, :2] * 0.5 + 0.5) * size
            p1 = ((start3[:, :2] + dir3[:, :2]) * 0.5 + 0.5) * size
            big = jnp.float32(1 << 28)
            v = comp3.slot_valid
            lo = jnp.minimum(
                jnp.min(jnp.where(v[:, None], jnp.minimum(p0, p1), big),
                        axis=0) - FOOT - 1.0, big)
            oy = jnp.clip(lo[1].astype(jnp.int32), 0, hd - cw)
            ox = jnp.clip(lo[0].astype(jnp.int32), 0, wd - cw)
            win = jax.lax.dynamic_slice(depth_packed, (oy, ox, 0),
                                        (cw, cw, 4))
            window = (win, (oy, ox), (hd, wd))
        inter, max_t, last_pen = _march(depth_packed, start3, dir3, jit3,
                                        window=window)
        term = _soft_term(inter & comp3.slot_valid, max_t, last_pen)
        return scatter_back(dense, comp3, term).reshape(batch)

    def eval_dense(_):
        # Capacity-overflow fallback: full dense march (only the taken
        # lax.cond branch runs — overflow costs speed, never correctness).
        inter, max_t, last_pen = _march(depth_packed, march_start,
                                        march_dir, jitter)
        return _soft_term(inter & cand, max_t, last_pen)

    if committed:
        # Elided overflow cond (GltfFrameFlags.committed): truncated
        # march entries keep the lit default — bounded local artifact,
        # detected by FrameDriver's occupancy poll.
        return eval_sparse(None)
    return jax.lax.cond(fits, eval_sparse, eval_dense, operand=None)
