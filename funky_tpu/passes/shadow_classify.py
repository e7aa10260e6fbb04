"""Shadow-map LIT/UMBRA/PENUMBRA classification for sparse filtering.

The reference GPU retires cheap shadow pixels through fragment-shader
early-outs (gltf.frag:402-423) and brute-forces the rest; designed for a
machine where every tap is a serial-loop gather row and masking saves
nothing, we classify
pixels FIRST with dense light-space prefilters and run the exact 16+16-tap
evaluation only on the compacted penumbra set (ops/compact.py).

Why not a plain dilated min/max of stored depth? Receivers SLOPE in light
space: the ground plane's own stored depth decreases toward the light, so
within any window the min dips below `receiver - bias` and nothing would
ever classify lit — even though the exact evaluation is trivially lit
(every ground pixel "finds blockers" among its downhill neighbors, the
penumbra estimate clamps to 0.5 texels, gltf.frag:429, and all compare
taps within that radius pass). The classification must therefore be
slope-proof. The trick: anchor each pixel to the stored depth at its own
texel, d(s_px) — bounded per coarse cell as plane(texel) + [min_resid,
max_resid] against an analytic per-cascade ground plane (residuals are
measured, so ANY plane is sound; matching the dominant receiver makes
the bounds tight, and no per-texel gather from the (L*S*S)-row raw map
is needed) — and precompute per coarse cell the worst-case LOCAL RELIEF
of the map:

    drop_r(c) = max over texels s in cell c of [ d(s) - min_{|t-s|<=r} d(t) ]
    rise_U(c) = max over s in c of [ max_{|t-s|<=U} d(t) - d(s) ]

Soundness (receiver = proj_z - bias, the exact biased compare value):

  LIT:   min over taps d >= d(s_px) - drop_r(cell)   [cell-max def]
         so  proj_z - d(s_px) <= bias - drop_r(cell)
         implies every compare tap passes => m1 = m2 = 1 exactly.
         Kernel radius may be 0 (no blockers) or the clamped penumbra —
         but with zero tap variance the TAA output is 1 for ANY radius,
         so the closed form is output-exact (blend bands still need both
         cascades closed; see shadow_filter.cascaded_shadow_sparse).
  UMBRA: max over taps d <= d(s_px) + rise_U(cell)
         so  proj_z - d(s_px) >= bias + rise_U(cell)  (and receiver <= 1,
         else the white border could read as a blocker while compares
         still return lit) implies every compare is shadowed AND every
         blocker-search tap hits => m1 = m2 = 0 exactly.

  The tap radius r for LIT is the PCSS penumbra, bounded per pixel from
  the blocker-window relief:  blocker_depth >= d(s_px) - drop_Lw(cell),
  so penumbra <= clip((receiver - bd_low)/bd_low * L, 0.5, 2L); we pick
  the smallest precomputed drop window >= bound + 2 (nearest/bilinear
  footprint + pixel-to-texel-center margin). A window larger than the
  taps is conservative, never wrong.

The smallest ladder rung is an EXACT-reach full-resolution dilation
(over-reach there would eat the tiny depth bias the flat-ground case
lives on). Larger rungs and the rise window run CONSERVATIVELY on
2x2-pooled hi/lo maps (see build_class_maps) — bounds only loosen, so
soundness is unaffected and only wide-penumbra cells classify slightly
less often. Softness is a traced uniform: frames with softness >
max_softness disable the closed forms entirely (everything penumbra =
exact, just slower).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from ..ops.sampling import take_rows

BORDER_DEPTH = 1.0   # CLAMP_TO_BORDER white (gltf_renderer.rs:806-833)
# Drop-window ladder (fine texels). The smallest rung carries the whole
# flat-ground case (penumbra clamps to 0.5 => taps within 2.5 texels) and
# fights the receiver slope for the depth bias — keep it tight. The top
# rung must cover pen_bound + 2 for pen_bound <= 2 * L_max =
# 4 * max_softness (default 16 -> 18 <= 34). The blocker-search window
# reuses the smallest rung that covers it (a larger window is
# conservative), keeping the cell row at 8 floats — with coarse=16 the
# whole table is 4*(2048/16)^2 x 32 B ~= 2 MB (sized for a gather that
# ran faster on small tables; not yet measured on the H100).
DROP_LADDER = (3, 6, 12, 20, 34)
FOOT_MARGIN = 2.0    # tap footprint: nearest/bilinear corners + px offset


class ShadowClassMaps(NamedTuple):
    """Per-cascade relief statistics (coarse-cell rows only — the anchor
    depth d(s_px) is BOUNDED via per-cell residuals against an analytic
    ground plane instead of gathered per texel from the raw (L*S*S)-row
    table)."""
    cell_rows: jnp.ndarray  # (L * Sc * Sc, K+2) [drop_ladder..., drop_Lw,
    #                          rise_U, min_resid, max_resid] per cell
    planes: jnp.ndarray     # (L, 3) uv-space ndc-depth plane per cascade
    size: int               # S
    coarse: int             # fine texels per cell
    max_softness: float     # static classification budget


def _dilate_exact(x: jnp.ndarray, reach: int, reduce_fn, pad_value: float,
                  collect_at: Sequence[int] = ()):
    """Exact-reach square dilation of (L, H, W) via composable shifts
    (after reach R, a +-s shift extends to R+s for any s <= R+1).
    Returns {reach: array} for every requested reach (all must be
    reachable by the step sequence 1, 1, 2, 4, ... with truncation).

    Shifts are STATIC SLICES + pad — never jnp.take/roll with an iota,
    which lowers to a gather; slices are pure HBM streams."""
    want = sorted(set(collect_at) | {reach})
    out = {}
    done = 0
    while True:
        if done in want:
            out[done] = x
        if done >= reach:
            break
        nxt = min((w for w in want if w > done))
        step = min(max(done, 1), nxt - done)
        for axis in (1, 2):
            n = x.shape[axis]
            s = min(step, n)
            pad_shape = list(x.shape)
            pad_shape[axis] = s
            pad = jnp.full(pad_shape, pad_value, x.dtype)
            fwd = jnp.concatenate(
                [jax.lax.slice_in_dim(x, s, n, axis=axis), pad], axis=axis)
            bwd = jnp.concatenate(
                [pad, jax.lax.slice_in_dim(x, 0, n - s, axis=axis)],
                axis=axis)
            x = reduce_fn(reduce_fn(x, fwd), bwd)
        done += step
    return out


def _cell_max(x: jnp.ndarray, coarse: int) -> jnp.ndarray:
    """Per-cell max over (coarse, coarse) tiles of each (S, S) map.

    Layout-aware two-stage reduction: the naive
    reshape(l, sc, coarse, sc, coarse).max((2, 4)) puts `coarse` (16) on
    the lane dim, forcing a physical relayout of the full 67 MB map
    before every reduce (measured 2.45 ms vs 0.91 at 2048^2;
    experiments/bench_cellmax.py). Reduce the ROW axis layout-free
    first, then the lane axis as a minor-dim reduce of the small
    (l, sc, s) intermediate."""
    l, s, _ = x.shape
    sc = s // coarse
    rows = x.reshape(l, sc, coarse, s).max(axis=2)        # (l, sc, s)
    return rows.reshape(l, sc, sc, coarse).max(axis=-1)


def _pool2(x: jnp.ndarray):
    """2x2 max/min pools of (L, S, S) via strided slices (layout-free;
    the reshape-reduce formulation needs a relayout)."""
    hi = jnp.maximum(x[:, 0::2, :], x[:, 1::2, :])
    hi = jnp.maximum(hi[:, :, 0::2], hi[:, :, 1::2])
    lo = jnp.minimum(x[:, 0::2, :], x[:, 1::2, :])
    lo = jnp.minimum(lo[:, :, 0::2], lo[:, :, 1::2])
    return hi, lo


def blocker_window(max_softness: float) -> int:
    # blocker search radius = lightSizeTexels = 2 * softness
    # (gltf.frag:415) + nearest-tap footprint margin
    return math.ceil(2.0 * max_softness + FOOT_MARGIN)


def rise_window(max_softness: float) -> int:
    # covers both the blocker search and the widest PCF kernel (2L)
    return math.ceil(4.0 * max_softness + FOOT_MARGIN)


def light_ground_planes(light_view_proj: jnp.ndarray,
                        plane_y: float = 0.0) -> jnp.ndarray:
    """(L, 3) per-cascade uv-space NDC-depth plane of the world plane
    y=plane_y: z_ndc(u, v) = p0*u + p1*v + p2 — exact for an ortho light
    (gltf_renderer.rs:1938-1944), fitted from 3 projected on-plane
    points. A degenerate (edge-on) light yields inf/nan coefficients,
    which simply stop the closed forms from firing (comparisons with
    nan are False) — sound, just not fast."""
    pts = jnp.asarray([[0.0, plane_y, 0.0],
                       [7.0, plane_y, 1.0],
                       [3.0, plane_y, -6.0]], jnp.float32)
    hom = jnp.concatenate([pts, jnp.ones((3, 1), jnp.float32)], axis=-1)
    clip = jnp.einsum("cij,nj->cni", light_view_proj, hom)   # (L, 3, 4)
    ndc = clip[..., :3] / clip[..., 3:4]
    uv = ndc[..., :2] * 0.5 + 0.5                 # _light_project convention
    a_mat = jnp.concatenate(
        [uv, jnp.ones(uv.shape[:-1] + (1,), jnp.float32)], axis=-1)
    return jnp.linalg.solve(a_mat, ndc[..., 2:3])[..., 0]    # (L, 3)


def _plane_at_texels(planes: jnp.ndarray, s: int) -> jnp.ndarray:
    """Evaluate each cascade's plane at every texel center: (L, S, S)."""
    u = (jnp.arange(s, dtype=jnp.float32) + 0.5) / s
    return (planes[:, 0, None, None] * u[None, None, :]
            + planes[:, 1, None, None] * u[None, :, None]
            + planes[:, 2, None, None])


def build_class_maps(shadow_maps: jnp.ndarray, coarse: int = 8,
                     max_softness: float = 4.0,
                     planes: jnp.ndarray | None = None) -> ShadowClassMaps:
    """Build classification maps from raw cascade depth (L, S, S).

    planes: (L, 3) reference planes for the anchor residual bounds
    (light_ground_planes). ANY value is sound (residuals are measured
    against it); a plane matching the dominant receiver (the ground)
    maximizes the closed-form hit rate. None = zero plane (residuals
    become raw depths — sound but slope-blind, mostly for tests)."""
    l, s, _ = shadow_maps.shape
    assert (s // coarse) * coarse == s
    uw = rise_window(max_softness)
    assert DROP_LADDER[-1] >= math.ceil(4.0 * max_softness + FOOT_MARGIN), \
        "drop ladder must cover the max PCSS penumbra"
    # Blocker-search window: smallest ladder rung that covers it (bigger
    # window => smaller min => lower blocker bound => larger penumbra
    # bound: conservative).
    assert DROP_LADDER[_lw_rung(max_softness)] >= blocker_window(
        max_softness)

    # Smallest rung: EXACT full-res dilation — it carries the whole
    # flat-ground LIT case, where the margin is the tiny depth bias and
    # any slack kills the closure.
    r0 = DROP_LADDER[0]
    mins0 = _dilate_exact(shadow_maps, r0, jnp.minimum, BORDER_DEPTH)
    drops = {r0: _cell_max(shadow_maps - mins0[r0], coarse)}

    if coarse % 2 == 0 and s % 2 == 0:
        # Larger rungs + the rise window: CONSERVATIVE multiresolution
        # dilation on 2x2-pooled maps (~4x less HBM traffic; the full-res
        # chains were ~2/3 of the class-map build). Soundness: for any
        # fine texel s in 2x2 block j, the fine ball {t: |t-s|inf <= r}
        # lies within the blocks at Chebyshev distance <= R = (r+1)//2 of
        # j, so
        #   d(s) - min_{|t-s|<=r} d(t)  <=  d_hi(j) - dilate_R(d_lo)(j)
        #   max_{|t-s|<=U} d(t) - d(s)  <=  dilate_R(d_hi)(j) - d_lo(j)
        # i.e. drop/rise computed at half res are >= the true per-texel
        # relief — looser (a few more penumbra pairs at wide rungs),
        # never unsound. The bias-critical smallest rung stays exact
        # above.
        d_hi, d_lo = _pool2(shadow_maps)
        ch = coarse // 2
        half_rungs = [(r, (r + 1) // 2) for r in DROP_LADDER[1:]]
        min2 = _dilate_exact(d_lo, half_rungs[-1][1], jnp.minimum,
                             BORDER_DEPTH,
                             collect_at=[hr for _, hr in half_rungs])
        for r, hr in half_rungs:
            drops[r] = _cell_max(d_hi - min2[hr], ch)
        ru = (uw + 1) // 2
        max2 = _dilate_exact(d_hi, ru, jnp.maximum, BORDER_DEPTH)
        rise = _cell_max(max2[ru] - d_lo, ch)
    else:
        # odd coarse/size (tests, tiny maps): exact full-res everything
        mins = _dilate_exact(shadow_maps, DROP_LADDER[-1], jnp.minimum,
                             BORDER_DEPTH, collect_at=DROP_LADDER)
        drops = {r: _cell_max(shadow_maps - mins[r], coarse)
                 for r in DROP_LADDER}
        maxs = _dilate_exact(shadow_maps, uw, jnp.maximum, BORDER_DEPTH)
        rise = _cell_max(maxs[uw] - shadow_maps, coarse)

    if planes is None:
        planes = jnp.zeros((l, 3), jnp.float32)
    resid = shadow_maps - _plane_at_texels(planes, s)
    # f32 slack for plane evaluation both here and in classify()
    eps = (jnp.sum(jnp.abs(planes), axis=-1) * 4e-7 + 2e-7)[:, None, None]
    min_resid = -_cell_max(-(resid - eps), coarse)
    max_resid = _cell_max(resid + eps, coarse)

    cell = jnp.stack([drops[r] for r in DROP_LADDER]
                     + [rise, min_resid, max_resid],
                     axis=-1)                          # (L, Sc, Sc, K+3)
    sc = s // coarse
    return ShadowClassMaps(
        cell_rows=cell.reshape(l * sc * sc, len(DROP_LADDER) + 3),
        planes=planes,
        size=s, coarse=coarse, max_softness=max_softness)


def _lw_rung(max_softness: float) -> int:
    """Index of the smallest ladder rung covering the blocker window."""
    lw = blocker_window(max_softness)
    for i, r in enumerate(DROP_LADDER):
        if r >= lw:
            return i
    return len(DROP_LADDER) - 1


def classify(cmaps: ShadowClassMaps, layer: jnp.ndarray, uv: jnp.ndarray,
             receiver: jnp.ndarray, softness: jnp.ndarray,
             use_pcss: bool):
    """Per-pixel class for one cascade: returns (lit, umbra) bool arrays.

    receiver: biased compare reference (proj_z - bias). ONE gathered row
    per element (the cell stats); the anchor depth d(s_px) is bounded as
    plane(texel center) + [min_resid, max_resid] of the cell — dense
    arithmetic instead of a gather from the (L*S*S)-row raw map."""
    s = cmaps.size
    sc = s // cmaps.coarse
    px = jnp.clip(jnp.floor(uv[..., 0] * s).astype(jnp.int32), 0, s - 1)
    py = jnp.clip(jnp.floor(uv[..., 1] * s).astype(jnp.int32), 0, s - 1)

    cx = px // cmaps.coarse
    cy = py // cmaps.coarse
    # NOTE (r4, measured): a 2x2-screen-block variant of this gather (one
    # row per block from a 3x3-conservative table, straddling blocks
    # falling back) LOST 17 ms in-frame despite gathering 4x fewer rows —
    # the interleaving up-sample reshapes + strided block masks relayout
    # the minor dim (the take_rows/_reduce_min pathology, CLAUDE.md), and
    # the extra unclosed silhouette pixels raised every capacity. The
    # per-pixel gather below (2 MB table, fast layout) is the measured
    # optimum; experiments/ab_lightflags.py is the harness that judged it.
    cell = take_rows(cmaps.cell_rows,
                     (layer * sc + cy) * sc + cx)         # (..., K+3)
    n_ladder = len(DROP_LADDER)
    drop_lw = cell[..., _lw_rung(cmaps.max_softness)]
    rise_u = cell[..., n_ladder]
    min_resid = cell[..., n_ladder + 1]
    max_resid = cell[..., n_ladder + 2]

    n_planes = cmaps.planes.shape[0]
    oh_l = (layer[..., None] == jnp.arange(n_planes, dtype=jnp.int32))
    psel = lambda k: jnp.sum(  # noqa: E731 — one-hot cascade plane select
        jnp.where(oh_l, cmaps.planes[:, k], 0.0), axis=-1)
    plane_a = (psel(0) * (px.astype(jnp.float32) + 0.5) / s
               + psel(1) * (py.astype(jnp.float32) + 0.5) / s + psel(2))
    anchor_lb = plane_a + min_resid
    anchor_ub = plane_a + max_resid

    # excess = receiver - d(s_px): how far the receiver sits BELOW the
    # stored surface at its own texel (positive = deeper = more occluded).
    # LIT needs the certificate at the LARGEST possible excess, UMBRA at
    # the smallest.
    excess_ub = receiver - anchor_lb
    excess_lb = receiver - anchor_ub

    if use_pcss:
        light_size = softness * 2.0                       # gltf.frag:415
        bd_low = anchor_lb - drop_lw
        ratio_bound = (receiver - bd_low) / jnp.maximum(bd_low, 1e-8)
        pen_bound = jnp.clip(ratio_bound * light_size, 0.5,
                             light_size * 2.0)
        need_r = pen_bound + FOOT_MARGIN
    else:
        radius = jnp.maximum(softness, 0.5)               # gltf.frag:456
        need_r = jnp.broadcast_to(radius + FOOT_MARGIN, excess_ub.shape)

    # smallest ladder drop window covering the taps
    drop_sel = cell[..., n_ladder - 1]
    for i in range(n_ladder - 2, -1, -1):
        drop_sel = jnp.where(need_r <= DROP_LADDER[i], cell[..., i],
                             drop_sel)

    ok = softness <= cmaps.max_softness
    lit = (excess_ub <= -drop_sel) & (need_r <= DROP_LADDER[-1]) & ok
    # receiver > 1 could turn the white border into a "blocker" for taps
    # outside the map while compare taps still read lit — exclude.
    umbra = (excess_lb > rise_u) & (receiver <= BORDER_DEPTH) & ok
    return lit, umbra
