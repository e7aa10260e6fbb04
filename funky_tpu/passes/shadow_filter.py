"""Shadow filtering: cascade select/blend + PCF + PCSS (gltf.frag:45-527).

Fully vectorized over the framebuffer: every pixel evaluates its cascade
pair (c0, c1) with per-pixel gathered light matrices; the 16-tap Vogel-disk
loops are unrolled statically (the tap count is a shader-constant in the
reference too). The PCF fast path (3x3 when radius <= 1.25,
gltf.frag:474-489) is selected by a frame-uniform lax.cond, so only one
path executes per frame.

Returns the reference's ShadowResult moments (v, m1, m2, kernel radius)
which feed the shadow TAA variance clamp (gltf.frag:38-43, 569-577).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.sampling import (sample_nearest_border_packed,
                            sample_nearest_border_window,
                            sample_shadow_compare_packed,
                            sample_shadow_compare_window, take_rows)
from .uniforms import FrameUniforms

BLOCKER_SAMPLES = 16   # gltf.frag:373
PCF_SAMPLES = 16       # gltf.frag:436, 494
GOLDEN_ANGLE = 2.4     # gltf.frag:108


class ShadowResult(NamedTuple):
    v: jnp.ndarray                    # (H, W)
    m1: jnp.ndarray
    m2: jnp.ndarray
    kernel_radius_texels: jnp.ndarray


def interleaved_gradient_noise(screen_pos: jnp.ndarray) -> jnp.ndarray:
    """IGN (gltf.frag:84-87). screen_pos: (..., 2)."""
    magic = jnp.asarray([0.06711056, 0.00583715], jnp.float32)
    d = screen_pos[..., 0] * magic[0] + screen_pos[..., 1] * magic[1]
    return jnp.mod(52.9829189 * jnp.mod(d, 1.0), 1.0)


def shadow_frame_phi(screen_pos: jnp.ndarray, frame: jnp.ndarray,
                     taa_enabled: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel rotation angle; animated only when shadow TAA is on
    (gltf.frag:89-98)."""
    offset = jnp.stack([frame * 13.37, frame * 17.17])
    p = jnp.where(taa_enabled > 0.5, screen_pos + offset, screen_pos)
    return interleaved_gradient_noise(p) * 6.2831853


def vogel_disk(i: int, count: int, phi: jnp.ndarray):
    """Tap i of a Vogel disk rotated by per-pixel phi (gltf.frag:107-112).
    Returns (dx, dy) arrays shaped like phi."""
    r = jnp.sqrt(jnp.float32(i) + 0.5) / jnp.sqrt(jnp.float32(count))
    theta = jnp.float32(i) * GOLDEN_ANGLE + phi
    return r * jnp.cos(theta), r * jnp.sin(theta)


def vogel_disk_all(count: int, phi: jnp.ndarray):
    """All `count` Vogel taps at once: (dx, dy) shaped (count, *phi.shape).

    Independent taps are issued as ONE batched gather (designed around
    per-op gather overhead; not yet measured on the H100)."""
    i = jnp.arange(count, dtype=jnp.float32).reshape(
        (count,) + (1,) * phi.ndim)
    r = jnp.sqrt(i + 0.5) / jnp.sqrt(jnp.float32(count))
    theta = i * GOLDEN_ANGLE + phi[None]
    return r * jnp.cos(theta), r * jnp.sin(theta)


def select_cascade_blend(view_depth: jnp.ndarray, splits: jnp.ndarray):
    """Cascade pair + blend factor (gltf.frag:52-80). Vectorized over
    pixels; the if-chain becomes priority selection on band masks."""
    s0, s1, s2 = splits[0], splits[1], splits[2]
    f0 = jnp.maximum(0.10 * s0, 0.5)
    f1 = jnp.maximum(0.10 * s1, 0.5)
    f2 = jnp.maximum(0.10 * s2, 0.5)

    def smoothstep(e0, e1, x):
        t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    in0 = (view_depth > s0 - f0) & (view_depth < s0 + f0)
    in1 = (view_depth > s1 - f1) & (view_depth < s1 + f1)
    in2 = (view_depth > s2 - f2) & (view_depth < s2 + f2)

    # selectCascade fallback (gltf.frag:45-50)
    base = (jnp.int32(0)
            + (view_depth >= s0).astype(jnp.int32)
            + (view_depth >= s1).astype(jnp.int32)
            + (view_depth >= s2).astype(jnp.int32))

    c0 = jnp.where(in0, 0, jnp.where(in1, 1, jnp.where(in2, 2, base)))
    c1 = jnp.where(in0, 1, jnp.where(in1, 2, jnp.where(in2, 3, base)))
    t = jnp.where(in0, smoothstep(s0 - f0, s0 + f0, view_depth),
                  jnp.where(in1, smoothstep(s1 - f1, s1 + f1, view_depth),
                            jnp.where(in2, smoothstep(s2 - f2, s2 + f2,
                                                      view_depth), 0.0)))
    return c0, c1, t


def _project_all(uni: FrameUniforms, world: jnp.ndarray,
                 normal: jnp.ndarray, n_dot_l: jnp.ndarray):
    """Normal-offset bias + light-space projection through ALL cascades
    (gltf.frag:391-410 == 453-469): returns ((C, ..., 3) proj, bias).
    Factored out of _light_project so the pair classification projects
    ONCE and selects twice (c0 AND c1) instead of paying the dense
    16-dot einsum twice per pixel (r5)."""
    normal_bias = 0.02 * (1.0 - n_dot_l)
    biased = world + normal * normal_bias[..., None]

    ones = jnp.ones(biased.shape[:-1] + (1,), jnp.float32)
    hom = jnp.concatenate([biased, ones], axis=-1)        # (..., 4)
    # (C, ..., 4) clip coords through every cascade
    clip_all = jnp.einsum("cij,...j->c...i", uni.light_view_proj, hom)
    proj_all = clip_all[..., :3] / clip_all[..., 3:4]     # ortho: w == 1

    base_bias = 0.0008
    slope_bias = 0.0025 * (1.0 - n_dot_l)
    bias = base_bias + slope_bias
    return proj_all, bias


def _select_cascade(proj_all: jnp.ndarray, cascade: jnp.ndarray):
    """One-hot select one cascade's projection: (uv, receiver, in_bounds).
    Pure elementwise work — no per-pixel matrix gather."""
    n_casc = proj_all.shape[0]
    sel = (cascade[None] == jnp.arange(n_casc, dtype=jnp.int32).reshape(
        (n_casc,) + (1,) * cascade.ndim))
    proj = jnp.sum(jnp.where(sel[..., None], proj_all, 0.0), axis=0)

    uv = proj[..., :2] * 0.5 + 0.5
    receiver = proj[..., 2]
    in_bounds = ((uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
                 & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0))
    return uv, receiver, in_bounds


def _light_project(uni: FrameUniforms, cascade: jnp.ndarray,
                   world: jnp.ndarray, normal: jnp.ndarray,
                   n_dot_l: jnp.ndarray):
    """Normal-offset bias + light-space projection for one cascade
    (gltf.frag:391-410 == 453-469).

    Projecting densely through ALL 4 cascades and one-hot selecting
    replaces a per-pixel 4x4 matrix gather (lightViewProj[cascade]) with
    elementwise work."""
    proj_all, bias = _project_all(uni, world, normal, n_dot_l)
    uv, receiver, in_bounds = _select_cascade(proj_all, cascade)
    return uv, receiver, bias, in_bounds


def _pcss_taps(uni: FrameUniforms, shadow_maps: jnp.ndarray,
               layer: jnp.ndarray, uv: jnp.ndarray, receiver: jnp.ndarray,
               phi: jnp.ndarray, window=None, radius_only: bool = False):
    """The PCSS tap core (gltf.frag:366-449) on arbitrary batch shapes:
    blocker search + penumbra estimate + penumbra-radius PCF.

    receiver is already biased (gltf.frag:410). `window` optionally
    rebases all taps into a dynamic-sliced sub-table of ONE cascade:
    (rows (Wc, Wc, 4), origin (2,) int32 (oy, ox), full map size S) —
    bit-identical values, small-table gather speed (ops/sampling.py).
    radius_only skips the 16-tap PCF phase and returns m1 = m2 = 1: for
    LIT-certified entries every compare tap provably passes
    (shadow_classify LIT soundness), so only the blocker search is
    needed — for the penumbra radius the TAA variance clamp consumes —
    at 16 gathered rows instead of 34 (r5 radius-only groups).
    Returns (m1, m2, penumbra, has_blockers)."""
    texel = uni.shadow_map_size[2]
    light_size_texels = uni.shadow_bias[0] * 2.0          # gltf.frag:415

    # Step 1: blocker search (gltf.frag:366-388). The raw-depth sampler is
    # NEAREST + CLAMP_TO_BORDER white (gltf_renderer.rs:822-833). All 16
    # taps ride ONE batched gather (see vogel_disk_all).
    dx, dy = vogel_disk_all(BLOCKER_SAMPLES, phi)
    off = jnp.stack([dx, dy], axis=-1) * (light_size_texels * texel)
    if window is not None:
        d = sample_nearest_border_window(window[0], window[1], window[2],
                                         uv[None] + off, border=1.0)
    else:
        d = sample_nearest_border_packed(shadow_maps, layer[None],
                                         uv[None] + off, border=1.0)
    hit = d < receiver[None]
    blocker_sum = jnp.sum(jnp.where(hit, d, 0.0), axis=0)
    blocker_cnt = jnp.sum(hit.astype(jnp.float32), axis=0)

    has_blockers = blocker_cnt > 0.0
    blocker_depth = blocker_sum / jnp.maximum(blocker_cnt, 1.0)

    # Step 2: penumbra estimate with contact hardening (gltf.frag:425-431).
    penumbra_ratio = (receiver - blocker_depth) / jnp.maximum(
        blocker_depth, 1e-8)
    penumbra = jnp.clip(penumbra_ratio * light_size_texels, 0.5,
                        light_size_texels * 2.0)

    if radius_only:
        one = jnp.ones_like(penumbra)
        return one, one, penumbra, has_blockers

    # Step 3: PCF with penumbra-sized kernel (gltf.frag:433-449), again
    # one batched gather for all 16 taps.
    dx, dy = vogel_disk_all(PCF_SAMPLES, phi)
    off = jnp.stack([dx, dy], axis=-1) * (penumbra * texel)[None, ..., None]
    if window is not None:
        s = sample_shadow_compare_window(window[0], window[1], window[2],
                                         uv[None] + off, receiver[None])
    else:
        s = sample_shadow_compare_packed(shadow_maps, layer[None],
                                         uv[None] + off, receiver[None])
    s_sum = jnp.sum(s, axis=0)
    s_sum2 = jnp.sum(s * s, axis=0)

    return s_sum / PCF_SAMPLES, s_sum2 / PCF_SAMPLES, penumbra, has_blockers


def shadow_pcss(uni: FrameUniforms, shadow_maps: jnp.ndarray,
                cascade: jnp.ndarray, world: jnp.ndarray,
                normal: jnp.ndarray, n_dot_l: jnp.ndarray,
                phi: jnp.ndarray) -> ShadowResult:
    """PCSS with contact hardening (gltf.frag:366-450).

    shadow_maps: quad-packed cascades (4, S, S, 4) from
    ops.sampling.quad_pack."""
    uv, receiver, bias, in_bounds = _light_project(
        uni, cascade, world, normal, n_dot_l)
    receiver = receiver - bias                            # gltf.frag:410

    m1, m2, penumbra, has_blockers = _pcss_taps(
        uni, shadow_maps, cascade, uv, receiver, phi)

    # No blockers or out of bounds => fully lit (gltf.frag:402-403,420-423).
    lit = ~has_blockers | ~in_bounds
    one = jnp.ones_like(m1)
    return ShadowResult(
        v=jnp.where(lit, one, m1),
        m1=jnp.where(lit, one, m1),
        m2=jnp.where(lit, one, m2),
        kernel_radius_texels=jnp.where(lit, 0.0, penumbra),
    )


def _pcf_taps(uni: FrameUniforms, shadow_maps: jnp.ndarray,
              layer: jnp.ndarray, uv: jnp.ndarray, ref: jnp.ndarray,
              phi: jnp.ndarray, window=None):
    """Fixed-radius PCF tap core (gltf.frag:453-507) on arbitrary batch
    shapes; ref is already biased. `window` as in _pcss_taps. Returns
    (m1, m2, kernel)."""
    texel = uni.shadow_map_size[2]
    radius = jnp.maximum(uni.shadow_bias[0], 0.5)

    def compare(off):
        if window is not None:
            return sample_shadow_compare_window(
                window[0], window[1], window[2], uv[None] + off, ref[None])
        return sample_shadow_compare_packed(shadow_maps, layer[None],
                                            uv[None] + off, ref[None])

    # Both paths issue all taps as ONE batched gather (vogel_disk_all).
    def taps_3x3(_):
        offs = jnp.asarray([[dx, dy] for dy in (-1, 0, 1)
                            for dx in (-1, 0, 1)], jnp.float32) * texel
        off = offs.reshape((9,) + (1,) * ref.ndim + (2,))
        s = compare(off)
        return (jnp.sum(s, axis=0) / 9.0, jnp.sum(s * s, axis=0) / 9.0,
                jnp.ones_like(ref))

    def taps_vogel(_):
        dx, dy = vogel_disk_all(PCF_SAMPLES, phi)
        off = jnp.stack([dx, dy], axis=-1) * (radius * texel)
        s = compare(off)
        return (jnp.sum(s, axis=0) / PCF_SAMPLES,
                jnp.sum(s * s, axis=0) / PCF_SAMPLES,
                jnp.full_like(ref, radius))

    # Frame-uniform branch (radius is a per-frame scalar): only one path
    # executes (gltf.frag:474 "Cheap 3x3 for hard shadows").
    return jax.lax.cond(radius <= 1.25, taps_3x3, taps_vogel, operand=None)


def pcf_frame_kernel(uni: FrameUniforms) -> jnp.ndarray:
    """The frame-constant PCF kernel radius the reference reports in
    ShadowResult (1.0 on the 3x3 fast path, else the Vogel radius)."""
    radius = jnp.maximum(uni.shadow_bias[0], 0.5)
    return jnp.where(radius <= 1.25, 1.0, radius)


def shadow_pcf(uni: FrameUniforms, shadow_maps: jnp.ndarray,
               cascade: jnp.ndarray, world: jnp.ndarray,
               normal: jnp.ndarray, n_dot_l: jnp.ndarray,
               phi: jnp.ndarray) -> ShadowResult:
    """Fixed-radius PCF (gltf.frag:453-507)."""
    uv, depth_ref, bias, in_bounds = _light_project(
        uni, cascade, world, normal, n_dot_l)
    ref = depth_ref - bias

    m1, m2, kernel = _pcf_taps(uni, shadow_maps, cascade, uv, ref, phi)

    one = jnp.ones_like(m1)
    return ShadowResult(
        v=jnp.where(in_bounds, m1, one),
        m1=jnp.where(in_bounds, m1, one),
        m2=jnp.where(in_bounds, m2, one),
        kernel_radius_texels=jnp.where(in_bounds, kernel, 0.0),
    )


def mix_shadow(a: ShadowResult, b: ShadowResult,
               t: jnp.ndarray) -> ShadowResult:
    """gltf.frag:520-527."""
    return ShadowResult(
        v=a.v + (b.v - a.v) * t,
        m1=a.m1 + (b.m1 - a.m1) * t,
        m2=a.m2 + (b.m2 - a.m2) * t,
        kernel_radius_texels=(a.kernel_radius_texels
                              + (b.kernel_radius_texels
                                 - a.kernel_radius_texels) * t),
    )


def cascaded_shadow(uni: FrameUniforms, shadow_maps: jnp.ndarray,
                    world: jnp.ndarray, normal: jnp.ndarray,
                    n_dot_l: jnp.ndarray, view_depth: jnp.ndarray,
                    screen_pos: jnp.ndarray, use_pcss: bool):
    """Main shadow evaluation (gltf.frag:604-613): select cascade pair,
    filter both, blend. `use_pcss` is static (frame-level recompile on
    toggle, like a pipeline switch).

    Returns (ShadowResult, c0, c1, t) — the extras feed debug coloring.
    """
    c0, c1, t = select_cascade_blend(view_depth, uni.cascade_splits)
    phi = shadow_frame_phi(screen_pos, uni.debug_flags[3], uni.debug_flags[2])

    fn = shadow_pcss if use_pcss else shadow_pcf
    s0 = fn(uni, shadow_maps, c0, world, normal, n_dot_l, phi)
    s1 = fn(uni, shadow_maps, c1, world, normal, n_dot_l, phi)
    s = mix_shadow(s0, s1, t)
    # Where t == 0 the reference never evaluates s1; mix(a,a,0)=a matches.
    return s, c0, c1, t


# ---------------------------------------------------------------------------
# Sparse evaluation: classify -> compact -> exact taps on penumbra pixels.
#
# Designed for a machine where gathers dominated the shadow stack and
# masking did not save them (not yet re-measured on the H100). The conservative LIT/UMBRA classification
# (passes/shadow_classify.py) yields the EXACT reference result in closed
# form for most pixels; only penumbra pixels (and umbra pixels inside a
# cascade-blend band, whose PCSS kernel radius feeds the TAA variance
# clamp) run the real 16+16 taps, on a compacted list.
# ---------------------------------------------------------------------------


def _classified_project(uni: FrameUniforms, cmaps, cascade, world, normal,
                        n_dot_l, softness, use_pcss):
    from .shadow_classify import classify

    uv, receiver, bias, inb = _light_project(uni, cascade, world, normal,
                                             n_dot_l)
    receiver = receiver - bias                            # gltf.frag:410
    lit, umbra = classify(cmaps, cascade, uv, receiver, softness, use_pcss)
    return uv, receiver, inb, lit, umbra


def _classified_select(cmaps, proj_all, bias, cascade, softness,
                       use_pcss):
    """_classified_project on a precomputed _project_all result."""
    from .shadow_classify import classify

    uv, receiver, inb = _select_cascade(proj_all, cascade)
    receiver = receiver - bias                            # gltf.frag:410
    lit, umbra = classify(cmaps, cascade, uv, receiver, softness, use_pcss)
    return uv, receiver, inb, lit, umbra


def _pair_classification(uni: FrameUniforms, cmaps, c0, c1, blend, world,
                         normal, n_dot_l, softness, use_pcss: bool,
                         valid, committed: bool = False):
    """Project + classify both cascades and derive the exact-evaluation
    pair masks — shared by cascaded_shadow_sparse and classify_stats so
    the capacity-sizing diagnostic can never drift from the mask the
    sparse path actually compacts. Works on any domain shape (the blocked
    back half passes flat block-major arrays).

    Returns (uv0, r0, inb0, lit0, um0, uv1, r1, inb1, lit1, um1,
    needs0, needs1)."""
    from ..ops.compact import gather_rows, scatter_back
    from .shadow_classify import classify as _classify

    n = blend.size

    # ONE dense projection through all cascades; c0 and c1 each one-hot
    # select from it (the einsum was previously paid twice — r5).
    proj_all, bias = _project_all(uni, world, normal, n_dot_l)
    uv0, r0, inb0, lit0, um0 = _classified_select(
        cmaps, proj_all, bias, c0, softness, use_pcss)

    # c1's classes are only CONSUMED inside the blend band (needs1 has
    # `& blend`; the pair-closure `where(blend, ...)` ignores them
    # elsewhere), and bands cover a few % of the screen — so c1's cell
    # gather runs block-sparsely over band blocks (projection itself is
    # dense math and stays dense: uv1/r1 feed the tap payload).
    uv1, recv1, inb1 = _select_cascade(proj_all, c1)
    r1 = recv1 - bias                                    # gltf.frag:410
    band_mask = blend & valid

    def classify_c1_dense(_):
        return _classify(cmaps, c1, uv1, r1, softness, use_pcss)

    from ..ops.compact import compact_blocks_any

    band_bcap = max((n // 64) // 8, 128)
    comp_band = compact_blocks_any(band_mask, band_bcap)
    if comp_band is not None:
        def classify_c1_blocks(_):
            uv_e = gather_rows(uv1.reshape(n, 2), comp_band)
            r_e = gather_rows(r1.reshape(n), comp_band)
            c_e = gather_rows(c1.reshape(n), comp_band)
            lit_e, um_e = _classify(cmaps, c_e, uv_e, r_e, softness,
                                    use_pcss)
            lit = scatter_back(jnp.zeros((n,), bool), comp_band,
                               lit_e & comp_band.slot_valid)
            um = scatter_back(jnp.zeros((n,), bool), comp_band,
                              um_e & comp_band.slot_valid)
            return lit.reshape(blend.shape), um.reshape(blend.shape)

        if committed:
            # Elided cond (GltfFrameFlags.committed): a band overflow
            # drops blocks whose lit1/um1 stay False — CONSERVATIVE
            # (those pixels just become pairs), so this site is safe
            # even unverified.
            lit1, um1 = classify_c1_blocks(None)
        else:
            lit1, um1 = jax.lax.cond(comp_band.count <= band_bcap,
                                     classify_c1_blocks,
                                     classify_c1_dense, operand=None)
    else:
        lit1, um1 = classify_c1_dense(None)

    if use_pcss:
        # A PCSS closed form fixes m1/m2 but NOT the kernel radius (a lit
        # pixel's penumbra may be 0 or the 0.5-clamped estimate), and the
        # radius feeds the TAA variance clamp — which only matters when
        # the mixed tap variance is nonzero. So outside blend bands any
        # closed class is output-exact; inside, the PAIR must be closed
        # the same way ((lit,lit) => 1, (umbra,umbra) => 0), else both
        # cascades evaluate exactly. Out-of-bounds acts as lit with a
        # known radius 0 (gltf.frag:402-403) — which is why the umbra
        # pair additionally requires BOTH cascades in bounds: with one
        # side out of bounds the dense pair mixes (0, 1) with nonzero
        # variance, and the in-bounds side's exact kernel radius feeds
        # the TAA clamp, so it must really be evaluated.
        lit0e = lit0 | ~inb0
        lit1e = lit1 | ~inb1
        closed = jnp.where(blend,
                           (lit0e & lit1e) | (um0 & um1 & inb0 & inb1),
                           lit0e | um0)
        needs0 = valid & inb0 & ~closed
        needs1 = valid & inb1 & blend & ~closed
    else:
        # PCF's kernel radius is a frame constant: classes are
        # independently closed per cascade.
        needs0 = valid & inb0 & ~lit0 & ~um0
        needs1 = valid & inb1 & blend & ~lit1 & ~um1
    return (uv0, r0, inb0, lit0, um0, uv1, r1, inb1, lit1, um1, needs0,
            needs1)


def cascaded_shadow_sparse(uni: FrameUniforms, shadow_maps: jnp.ndarray,
                           cmaps, world: jnp.ndarray, normal: jnp.ndarray,
                           n_dot_l: jnp.ndarray, view_depth: jnp.ndarray,
                           screen_pos: jnp.ndarray, use_pcss: bool,
                           valid: jnp.ndarray | None = None,
                           capacity: int | None = None,
                           cascade_caps: tuple | None = None,
                           block_capacity: int | None = None,
                           tap_windows: tuple | None = None,
                           light_maps=None,
                           skip_backfacing: bool = False,
                           committed: bool = False,
                           lit_cascade_caps: tuple | None = None,
                           route_windows=None,
                           route_caps: tuple | None = None):
    """Sparse-exact main shadow evaluation: identical outputs to
    `cascaded_shadow` — bit-exact while the compaction capacities hold,
    and on overflow lax.cond falls back to the full dense evaluation
    (still exact, just a slow frame).

    Args:
      cmaps: ShadowClassMaps built from the raw cascade depths.
      valid: (H, W) bool — pixels actually covered by geometry (sky pixels
        never consume tap budget; their shadow value is unused).
      capacity: static max penumbra (pixel, cascade) pairs; default
        H*W // 16. Overflow falls back to the dense evaluation (exact).
      cascade_caps: static per-cascade pair capacities (4-tuple). The
        compaction groups pairs by cascade so each cascade's taps gather
        from its OWN (S, S, 4) table — a 4M-row 16 B-row table gathers
        ~40% faster than the fused 16M-row one (PERF.md). None = each
        cascade sized at `capacity` (correct, more padded slots).
      tap_windows: static per-cascade window sizes (4-tuple of texels;
        0 = full table for that cascade). Penumbra taps cluster in a
        small uv region, so each cascade's taps can gather from a
        dynamic-sliced (Wc, Wc, 4) sub-table — under the ~2.5 MB gather
        cliff at Wc <= 384 the serial gather runs ~3-4x faster
        (PERF.md). Bit-identical values; a frame whose taps don't fit
        the window lax.cond-falls back to the full table per cascade.
      light_maps: optional (rows, origins, sizes, fetch_caps) from the
        dense light-space ground evaluation (passes/shadow_lightspace):
        rows[c] is a (sizes[c]**2, 4) per-texel [v, m2, kernel, 1] map,
        origins[c] its (oy, ox). Ground-plane penumbra pixels inside a
        window fetch their result with ONE gathered row instead of ~34
        tap rows (a documented perf deviation — see the module
        docstring); everything else keeps the exact tap path.
      lit_cascade_caps: static per-cascade capacities for the
        RADIUS-ONLY groups (r5, PCSS only): a pair entry whose own side
        is LIT-certified has m1 = m2 = 1 provably (shadow_classify LIT
        soundness — every compare tap passes), so it only needs the
        16-tap blocker search for the penumbra radius the TAA variance
        clamp consumes, not the 34-row full core. Bit-exact vs the full
        evaluation. None = no split (every entry full-core).
      route_windows: (origins, sizes) of pre-planned per-cascade
        occluder-footprint windows (passes/shadow_lightspace
        plan_windows) for ROUTED window tap groups (r5): entries whose
        base texel sits inside a window minus the traced tap-reach
        margin go to a group whose 34 rows gather from the dynamic-
        sliced sub-cliff window — EXACT containment by construction (a
        per-entry VALUE test, no fit certificate, works conded or
        committed), ~2x the gather rate of the 67 MB full table. This
        is how cascade 1's taps (extent ~1341 texels — no single
        measured-bbox window fits) still get windowed: its occluder
        (duck) footprint is ~150 texels and holds most of its entries.
      route_caps: static per-cascade capacities for the routed groups
        (0 disables a cascade's route).
    """
    from ..ops.compact import (Compacted, compact_indices,
                               compact_indices_blocked, gather_rows,
                               scatter_back)

    c0, c1, t = select_cascade_blend(view_depth, uni.cascade_splits)
    phi = shadow_frame_phi(screen_pos, uni.debug_flags[3], uni.debug_flags[2])
    softness = uni.shadow_bias[0]

    n = c0.size
    cap = capacity if capacity is not None else max(n // 16, 256)
    if valid is None:
        valid = jnp.ones(c0.shape, bool)
    blend = t > 0.0

    (uv0, r0, inb0, lit0, um0, uv1, r1, inb1, lit1, um1, needs0,
     needs1) = _pair_classification(uni, cmaps, c0, c1, blend, world,
                                    normal, n_dot_l, softness, use_pcss,
                                    valid, committed=committed)

    if skip_backfacing:
        # Back-facing pixels (n_dot_l <= 0) cannot affect the image: the
        # shadow term only multiplies max(n_dot_l, 0) * diffuse
        # (gltf.frag:611-614). Perf deviation (their TAA history carries
        # the lit placeholder) — see GltfFrameFlags.skip_backfacing_shadows.
        facing = n_dot_l > 0.0
        needs0 = needs0 & facing
        needs1 = needs1 & facing

    # Dense closed-form results; penumbra placeholders are overwritten by
    # the scatter.
    def dense_base(inb, umbra):
        m = jnp.where(umbra & inb, 0.0, 1.0)
        if use_pcss:
            r = jnp.zeros(c0.shape, jnp.float32)      # lit radius == 0
        else:
            r = jnp.where(inb, pcf_frame_kernel(uni),
                          jnp.zeros(c0.shape, jnp.float32))
        return jnp.stack([m, m, m, r], axis=-1)       # (..., 4)

    needs = jnp.stack([needs0, needs1])               # (2, ...)
    n_casc = shadow_maps.shape[0]
    s_full = shadow_maps.shape[1]
    pair_layer = jnp.stack([c0, c1])                  # (2, ...) int32

    # Light-space ground fetch (see `light_maps` in the docstring): split
    # the needed pairs into FETCH entries (ground-plane receivers inside a
    # cascade's dense light-space window — one gathered row each) and TAP
    # entries (everything else — the exact 16+16-tap core). The split is
    # a per-pixel VALUE test, so a miss just stays on the exact path.
    if light_maps is not None:
        from .shadow_lightspace import ground_eligible

        light_rows, light_origins, light_sizes, light_caps = light_maps
        ok_soft = softness <= cmaps.max_softness   # window halo budget

        def _fetchable(cas, uv, recv, needs_h):
            el = ground_eligible(world, normal, recv) & ok_soft
            tx = jnp.floor(uv[..., 0] * s_full).astype(jnp.int32)
            ty = jnp.floor(uv[..., 1] * s_full).astype(jnp.int32)
            inw = jnp.zeros(needs_h.shape, bool)
            for c in range(n_casc):
                if light_sizes[c]:
                    oy, ox = light_origins[c]
                    inw = inw | ((cas == c)
                                 & (tx >= ox) & (tx < ox + light_sizes[c])
                                 & (ty >= oy) & (ty < oy + light_sizes[c]))
            return needs_h & el & inw

        fetch = jnp.stack([_fetchable(c0, uv0, r0, needs0),
                           _fetchable(c1, uv1, r1, needs1)])
        caps_f = tuple(light_caps) if light_caps is not None \
            else tuple(cap if light_sizes[c] else 0 for c in range(n_casc))
    else:
        fetch = jnp.zeros(needs.shape, bool)
        caps_f = ()

    # Traced tap-reach margin (texels): blocker search <= 2*softness,
    # penumbra PCF <= 4*softness, + bilinear footprint/snap. Shared by
    # the measured-bbox windows below and the route containment test.
    pad = jnp.ceil(4.0 * jnp.maximum(softness, 1.0)).astype(
        jnp.int32) + 2

    # Radius-only split (see lit_cascade_caps in the docstring): entries
    # whose own side is LIT-certified only need the blocker search. A
    # fetchable entry stays a fetch (1 row beats 16).
    rad_split = use_pcss and lit_cascade_caps is not None
    if rad_split:
        rad = jnp.stack([needs0 & lit0, needs1 & lit1]) & ~fetch
        caps_r = tuple(lit_cascade_caps)
    else:
        rad = jnp.zeros(needs.shape, bool)
        caps_r = ()

    # Routed window groups (see route_windows in the docstring): a
    # per-entry containment test against the pre-planned footprint
    # windows. Precedence fetch > route > radius (1 row beats 34 small
    # rows beats 16 big rows).
    routable = (route_windows is not None and route_caps is not None
                and any(route_caps))
    if routable:
        r_origins, r_sizes = route_windows
        caps_rt = tuple(route_caps)

        def _in_route(cas, uv):
            bx = jnp.floor(uv[..., 0] * s_full - 0.5).astype(jnp.int32)
            by = jnp.floor(uv[..., 1] * s_full - 0.5).astype(jnp.int32)
            inw = jnp.zeros(cas.shape, bool)
            for c in range(n_casc):
                if r_sizes[c] and caps_rt[c] and r_sizes[c] < s_full:
                    oy, ox = r_origins[c]
                    inw = inw | (
                        (cas == c)
                        & (bx >= ox + pad) & (bx < ox + r_sizes[c] - pad
                                              - 1)
                        & (by >= oy + pad) & (by < oy + r_sizes[c] - pad
                                              - 1))
            return inw

        route = (jnp.stack([_in_route(c0, uv0), _in_route(c1, uv1)])
                 & needs & ~fetch)
        rad = rad & ~route
    else:
        route = jnp.zeros(needs.shape, bool)
        caps_rt = ()

    # Group order: [full taps x n_casc][radius-only][route][fetch] (each
    # kind present only when configured). Each group is a contiguous
    # segment of ONE grouped compaction.
    nk = 1
    if rad_split:
        rad_k = nk
        nk += 1
    if routable:
        route_k = nk
        nk += 1
    if caps_f:
        fetch_k = nk
        nk += 1
    n_kinds = nk
    kind = jnp.zeros(needs.shape, jnp.int32)
    if rad_split:
        kind = jnp.where(rad, rad_k, kind)
    if routable:
        kind = jnp.where(route, route_k, kind)
    if caps_f:
        kind = jnp.where(fetch, fetch_k, kind)
    group_key = pair_layer + n_casc * kind
    n_groups = n_kinds * n_casc

    # Group the compacted pairs by (cascade, tap|fetch): each cascade's
    # tap segment gathers from its OWN (S, S, 4) table (see cascade_caps),
    # each fetch segment from its light-space result map.
    # Penumbra pairs cluster along shadow edges, so the compaction runs
    # two-level where the shape allows (block grid argsort instead of the
    # ~8 ms full-domain one): 8x8 spatial blocks on 2D domains, 64-runs
    # on flat block-major ones (the blocked back half).
    # Two-level compaction only with a TUNED block budget: the default
    # would make the candidate domain ~the full domain and just add
    # overhead (measured: worse than the plain argsort).
    fits_blocks = jnp.ones((), bool)
    if block_capacity is not None and c0.ndim == 2 \
            and c0.shape[0] % 8 == 0 and c0.shape[1] % 8 == 0:
        blocked = compact_indices_blocked(
            needs, cap, 8, 8, block_capacity, group_key=group_key)
        comp = blocked.comp
        fits_blocks = blocked.block_count <= block_capacity
    elif block_capacity is not None and c0.ndim == 1 and n % 64 == 0:
        blocked = compact_indices_blocked(
            needs.reshape(2, n // 64, 64), cap, 1, 64, block_capacity,
            group_key=group_key.reshape(2, n // 64, 64))
        comp = blocked.comp
        fits_blocks = blocked.block_count <= block_capacity
    else:
        comp = compact_indices(needs, cap, group_key=group_key)
    counts_c = jnp.stack([
        jnp.sum(needs & (group_key == g), dtype=jnp.int32)
        for g in range(n_groups)])
    offs = jnp.cumsum(counts_c) - counts_c
    caps_c = tuple(cascade_caps) if cascade_caps is not None \
        else (cap,) * n_casc
    caps_all = caps_c + caps_r + caps_rt + caps_f
    fits = (comp.count <= cap) & fits_blocks & jnp.all(
        counts_c <= jnp.asarray(caps_all, jnp.int32))

    def eval_sparse(_):
        """Exact taps on the compacted penumbra pairs (per-cascade
        segments), scattered into the closed-form base."""
        dense = jnp.stack([dense_base(inb0, um0),
                           dense_base(inb1, um1)]).reshape(2 * n, 4)
        # phi rides the payload row (4-wide): one fast-layout gather per
        # slot instead of a separate 1-wide phi gather (PERF.md r3 law —
        # 1-wide gathers are the SLOWEST row width at ~9.6 ns/row).
        phi2 = jnp.broadcast_to(phi.reshape(1, n), (2, n))
        payload = jnp.stack([
            jnp.stack([uv0[..., 0], uv0[..., 1], r0], axis=-1),
            jnp.stack([uv1[..., 0], uv1[..., 1], r1], axis=-1),
        ]).reshape(2 * n, 3)
        payload = jnp.concatenate([payload, phi2.reshape(2 * n, 1)],
                                  axis=-1)
        idx_pad = jnp.concatenate(
            [comp.idx, jnp.full((max(caps_all),), -1, jnp.int32)])

        # Per-cascade tap windows (see the docstring): bounding box of
        # the needed base texels + the tap-radius bound. The radius bound
        # is TRACED (blocker search <= 2*softness, penumbra PCF <=
        # 4*softness, fixed PCF <= max(softness, 1)), so the window-fit
        # certificate covers any softness — an oversized radius just
        # fails the extent check and takes the full-table branch. The
        # bbox is reduced over each cascade's COMPACTED segment (~tens of
        # k rows), not the full pixel domain: under `fits` the segments
        # contain every needed pair, so the certificate is exact, and the
        # r3 A/B loss from 16 full-frame reductions + a dense (2n, 2)
        # relayout is gone. (`pad` is the traced tap-reach margin
        # computed above, shared with the route containment test.)

        for g in range(len(caps_all)):
            c = g % n_casc
            gk = g // n_casc
            is_radius = rad_split and gk == rad_k
            is_route = routable and gk == route_k
            is_fetch = bool(caps_f) and gk == fetch_k
            cc = caps_all[g]
            if cc == 0:
                continue
            slot = jnp.arange(cc, dtype=jnp.int32)
            idx_c = jax.lax.dynamic_slice(idx_pad, (offs[g],), (cc,))
            valid_c = slot < counts_c[g]
            compc = Compacted(idx=jnp.where(valid_c, idx_c, -1),
                              slot_valid=valid_c, count=counts_c[g])
            rows = gather_rows(payload, compc)
            uv_e = rows[:, :2]
            recv_e = rows[:, 2]
            phi_e = rows[:, 3]

            if is_fetch:
                # ONE row per entry from the cascade's dense light-space
                # result map (passes/shadow_lightspace) — entries are
                # in-window by construction of the fetch groups.
                wcs = light_sizes[c]
                oy, ox = light_origins[c]
                txe = jnp.floor(uv_e[:, 0] * s_full).astype(jnp.int32)
                tye = jnp.floor(uv_e[:, 1] * s_full).astype(jnp.int32)
                loc = (jnp.clip(tye - oy, 0, wcs - 1) * wcs
                       + jnp.clip(txe - ox, 0, wcs - 1))
                r4 = take_rows(light_rows[c], loc)        # (cc, 4)
                vals = jnp.stack([r4[:, 0], r4[:, 0], r4[:, 1], r4[:, 2]],
                                 axis=-1)
                dense = scatter_back(dense, compc, vals)
                continue

            maps_c = shadow_maps[c:c + 1]
            layer0 = jnp.zeros((cc,), jnp.int32)

            def taps(window, c=c, uv_e=uv_e, recv_e=recv_e, phi_e=phi_e,
                     maps_c=maps_c, layer0=layer0, is_radius=is_radius):
                if use_pcss:
                    # Radius-only groups: the side is LIT-certified, so
                    # m1 = m2 = 1 provably and _pcss_taps skips the PCF
                    # phase (16 rows instead of 34) — bit-exact.
                    m1, m2, pen, hasb = _pcss_taps(uni, maps_c, layer0,
                                                   uv_e, recv_e, phi_e,
                                                   window=window,
                                                   radius_only=is_radius)
                    one = jnp.ones_like(m1)
                    # Entries are in-bounds by construction; the
                    # no-blocker lit override still applies
                    # (classification is conservative).
                    return jnp.stack([jnp.where(hasb, m1, one),
                                      jnp.where(hasb, m1, one),
                                      jnp.where(hasb, m2, one),
                                      jnp.where(hasb, pen, 0.0)], axis=-1)
                m1, m2, kern = _pcf_taps(uni, maps_c, layer0, uv_e,
                                         recv_e, phi_e, window=window)
                return jnp.stack([m1, m1, m2, kern], axis=-1)

            if is_route:
                # Routed groups: every entry is inside the pre-planned
                # footprint window minus the tap-reach margin — the
                # dynamic-sliced sub-table read is EXACT by construction
                # (no fit certificate, no cond). A window >= the map
                # (inconsistent config) degenerates to the full table.
                wcr = int(r_sizes[c])
                if 0 < wcr < s_full:
                    oy, ox = r_origins[c]
                    win = jax.lax.dynamic_slice(
                        shadow_maps, (c, oy, ox, 0), (1, wcr, wcr, 4))[0]
                    vals = taps((win, (oy, ox), s_full))
                else:
                    vals = taps(None)
                dense = scatter_back(dense, compc, vals)
                continue

            wc = (int(tap_windows[c])
                  if tap_windows is not None and tap_windows[c] else 0)
            if 0 < wc < s_full:
                big = jnp.int32(1 << 28)
                bx_e = jnp.floor(uv_e[:, 0] * s_full - 0.5).astype(
                    jnp.int32)
                by_e = jnp.floor(uv_e[:, 1] * s_full - 0.5).astype(
                    jnp.int32)
                lo_x = jnp.min(jnp.where(valid_c, bx_e, big)) - pad
                hi_x = jnp.max(jnp.where(valid_c, bx_e, -big)) + pad + 1
                lo_y = jnp.min(jnp.where(valid_c, by_e, big)) - pad
                hi_y = jnp.max(jnp.where(valid_c, by_e, -big)) + pad + 1
                fits_w = ((hi_x - lo_x) < wc) & ((hi_y - lo_y) < wc)
                oy = jnp.clip(lo_y, 0, s_full - wc)
                ox = jnp.clip(lo_x, 0, s_full - wc)
                win = jax.lax.dynamic_slice(
                    shadow_maps, (c, oy, ox, 0), (1, wc, wc, 4))[0]
                if committed:
                    # Elided window-fit cond (GltfFrameFlags.committed):
                    # the r3 verdict against windows was the fit cert +
                    # cond serialization, not the gather rate — with the
                    # cond gone the sub-cliff window gathers ~2x faster
                    # rows. An entry outside the window clamps to its
                    # edge texels (bounded local artifact); the driver's
                    # poll sees tap_extent_per_cascade vs the window
                    # (utils.autotune.capacity_overflows) and re-tunes.
                    vals = taps((win, (oy, ox), s_full))
                else:
                    vals = jax.lax.cond(
                        fits_w,
                        lambda _, win=win, oy=oy, ox=ox: taps(
                            (win, (oy, ox), s_full)),
                        lambda _: taps(None), operand=None)
            else:
                vals = taps(None)
            dense = scatter_back(dense, compc, vals)
        return dense

    def eval_dense(_):
        """Capacity-overflow fallback: the full dense evaluation. Only the
        taken lax.cond branch executes at runtime, so correctness never
        depends on the capacity guess — overflow just costs dense speed."""
        fn = shadow_pcss if use_pcss else shadow_pcf
        sd0 = fn(uni, shadow_maps, c0, world, normal, n_dot_l, phi)
        sd1 = fn(uni, shadow_maps, c1, world, normal, n_dot_l, phi)
        return jnp.stack([jnp.stack(sd0, axis=-1),
                          jnp.stack(sd1, axis=-1)]).reshape(2 * n, 4)

    if committed:
        out = eval_sparse(None)
    else:
        out = jax.lax.cond(fits, eval_sparse, eval_dense, operand=None)
    out = out.reshape((2,) + c0.shape + (4,))
    s0 = ShadowResult(out[0, ..., 0], out[0, ..., 1], out[0, ..., 2],
                      out[0, ..., 3])
    s1 = ShadowResult(out[1, ..., 0], out[1, ..., 1], out[1, ..., 2],
                      out[1, ..., 3])
    s = mix_shadow(s0, s1, t)
    return s, c0, c1, t


def classify_stats(uni: FrameUniforms, cmaps, world, normal, n_dot_l,
                   view_depth, screen_pos, use_pcss: bool,
                   valid: jnp.ndarray | None = None,
                   light_windows=None, skip_backfacing: bool = False,
                   committed: bool = False, route_windows=None):
    """Diagnostic: classification histogram + the exact-tap pair count the
    sparse path would compact (use to size GltfConfig.shadow_pen_capacity,
    like ops.binning.bin_stats for raster capacities).

    light_windows: optional (origins, sizes) of the light-space ground
    windows — splits the counts into fetch entries (sizes
    GltfConfig.light_fetch_caps) and residual tap entries (the
    per-cascade caps). skip_backfacing / committed mirror the frame
    flags — committed matters because the band-classify elision can DROP
    band blocks (their pixels become pairs), so a committed frame's pair
    set must be measured with the same committed classification
    (ADVICE r4, low)."""
    c0, c1, t = select_cascade_blend(view_depth, uni.cascade_splits)
    softness = uni.shadow_bias[0]
    if valid is None:
        valid = jnp.ones(c0.shape, bool)
    blend = t > 0.0
    (uv0, r0, _, lit0, um0, uv1, r1, _, lit1, _, needs0,
     needs1) = _pair_classification(uni, cmaps, c0, c1, blend, world,
                                    normal, n_dot_l, softness, use_pcss,
                                    valid, committed=committed)
    if skip_backfacing:
        facing = n_dot_l > 0.0
        needs0 = needs0 & facing
        needs1 = needs1 & facing
    needs = jnp.stack([needs0, needs1])
    pair_layer = jnp.stack([c0, c1])

    fetch = jnp.zeros_like(needs)
    if light_windows is not None:
        from .shadow_lightspace import ground_eligible

        origins, sizes = light_windows
        s_map = cmaps.size
        ok_soft = softness <= cmaps.max_softness

        def _fetchable(cas, uv, recv, needs_h):
            el = ground_eligible(world, normal, recv) & ok_soft
            tx = jnp.floor(uv[..., 0] * s_map).astype(jnp.int32)
            ty = jnp.floor(uv[..., 1] * s_map).astype(jnp.int32)
            inw = jnp.zeros(needs_h.shape, bool)
            for c in range(4):
                if sizes[c]:
                    oy, ox = origins[c]
                    inw = inw | ((cas == c)
                                 & (tx >= ox) & (tx < ox + sizes[c])
                                 & (ty >= oy) & (ty < oy + sizes[c]))
            return needs_h & el & inw

        fetch = jnp.stack([_fetchable(c0, uv0, r0, needs0),
                           _fetchable(c1, uv1, r1, needs1)])
    taps = needs & ~fetch
    # Routed window entries (r5): base texel inside a pre-planned
    # footprint window minus the traced tap-reach margin — mirrors
    # cascaded_shadow_sparse's containment test exactly (precedence
    # fetch > route > radius).
    routem = jnp.zeros(taps.shape, bool)
    s_full = cmaps.size
    if route_windows is not None:
        r_origins, r_sizes = route_windows
        pad = jnp.ceil(4.0 * jnp.maximum(softness, 1.0)).astype(
            jnp.int32) + 2

        def _in_route(cas, uv):
            bx = jnp.floor(uv[..., 0] * s_full - 0.5).astype(jnp.int32)
            by = jnp.floor(uv[..., 1] * s_full - 0.5).astype(jnp.int32)
            inw = jnp.zeros(cas.shape, bool)
            for c in range(4):
                if r_sizes[c]:
                    oy, ox = r_origins[c]
                    inw = inw | (
                        (cas == c)
                        & (bx >= ox + pad) & (bx < ox + r_sizes[c] - pad
                                              - 1)
                        & (by >= oy + pad) & (by < oy + r_sizes[c] - pad
                                              - 1))
            return inw

        routem = taps & jnp.stack([_in_route(c0, uv0),
                                   _in_route(c1, uv1)])
    # Radius-only split (r5): entries whose own side is LIT-certified go
    # to the 16-row blocker-only groups (shadow_lit_cascade_caps); the
    # full-core caps are sized from the remainder.
    if use_pcss:
        radm = taps & jnp.stack([lit0, lit1]) & ~routem
    else:
        radm = jnp.zeros(taps.shape, bool)
    taps_full = taps & ~radm & ~routem

    # Per-cascade base-texel bounding-box extents of the needed taps —
    # sizes GltfConfig.shadow_tap_windows (add the tap-radius padding
    # outside; see cascaded_shadow_sparse).
    uvp = jnp.stack([uv0, uv1])
    bx = jnp.floor(uvp[..., 0] * s_full - 0.5).astype(jnp.int32)
    by = jnp.floor(uvp[..., 1] * s_full - 0.5).astype(jnp.int32)
    big = jnp.int32(1 << 28)
    extents = []
    for c in range(4):
        m = taps & (pair_layer == c)
        ex = (jnp.max(jnp.where(m, bx, -big)) -
              jnp.min(jnp.where(m, bx, big)) + 1)
        ey = (jnp.max(jnp.where(m, by, -big)) -
              jnp.min(jnp.where(m, by, big)) + 1)
        has = jnp.any(m)
        extents.append(jnp.where(has, jnp.maximum(ex, ey), 0))

    # Band-block occupancy vs _pair_classification's static budget: the
    # committed band-classify elision drops blocks past band_bcap (their
    # pixels become pairs), so the driver's poll must see the overflow
    # (ADVICE r4, low). band_bcap uses this domain's n — the frame's
    # slab/blocked domain may be smaller (tighter bcap), so this is a
    # lower bound on the frame's overflow.
    band_mask = blend & valid
    hh, ww = band_mask.shape
    bm = jnp.pad(band_mask, ((0, -hh % 8), (0, -ww % 8)))
    band_blocks = jnp.sum(bm.reshape(bm.shape[0] // 8, 8,
                                     bm.shape[1] // 8, 8).any(axis=(1, 3)))
    band_bcap = jnp.asarray(max((band_mask.size // 64) // 8, 128),
                            jnp.int32)

    return {
        "_needs": needs,   # raw mask (private: block-occupancy diagnostics)
        "band_blocks": band_blocks,
        "band_bcap": band_bcap,
        "pairs": jnp.sum(needs),
        # tap-only counts size the per-cascade tap caps; fetch counts size
        # light_fetch_caps
        "pairs_per_cascade": jnp.stack(
            [jnp.sum(taps_full & (pair_layer == c)) for c in range(4)]),
        "pairs_lit_per_cascade": jnp.stack(
            [jnp.sum(radm & (pair_layer == c)) for c in range(4)]),
        "pairs_route_per_cascade": jnp.stack(
            [jnp.sum(routem & (pair_layer == c)) for c in range(4)]),
        "light_fetch_per_cascade": jnp.stack(
            [jnp.sum(fetch & (pair_layer == c)) for c in range(4)]),
        "tap_extent_per_cascade": jnp.stack(extents),
        "lit0": jnp.sum(valid & lit0),
        "umbra0": jnp.sum(valid & um0),
        "pixels": jnp.sum(valid),
    }
