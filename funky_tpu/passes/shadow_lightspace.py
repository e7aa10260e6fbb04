"""Dense LIGHT-SPACE shadow evaluation for planar (ground) receivers.

Designed around a per-pixel PCSS tap core where every tap is a
serial-loop gather row; the flagship view had ~82k penumbra
(pixel, cascade) pairs x ~34 rows each. But most penumbra pixels lie on the
GROUND PLANE, whose receiver depth is AFFINE in shadow uv (the same plane
shadow_classify.light_ground_planes fits for the closed forms). For such
receivers the whole PCSS evaluation — blocker search + penumbra estimate +
penumbra-radius PCF (gltf.frag:366-449) — depends only on the light-space
texel, not on the screen pixel, so it can run DENSELY over a light-space
window as shifted-image elementwise ops with ZERO gathers:

  - every tap offset is spatially constant over the domain, so a tap is a
    (traced) integer window shift + constant bilinear weights;
  - the compare threshold `receiver` is a dense affine image;
  - ground pixels then fetch their final (v, m2, kernel) with ONE gathered
    row each, instead of ~34.

Documented DEVIATIONS from the reference's per-pixel math (this is a perf
mode, gated by GltfFrameFlags.light_space_ground_shadows, default off;
the exact sparse path remains the default and the parity reference):

  1. The evaluation point snaps to the light-space texel center (<= half a
     texel; the screen fetch reads the nearest evaluated texel).
  2. The per-pixel IGN Vogel rotation (gltf.frag:84-98) becomes a small
     set of per-frame angles selected by TEXEL PARITY (a 2x2 checkerboard
     of `phases` rotations, each a dense pass): fully constant rotation
     made marginal self-shadowing stripe-coherent (verified visually at
     small map sizes); the checkerboard restores neighbor decorrelation
     as high-frequency noise that shadow TAA averages, like the IGN it
     replaces. The IGN temporal sequence still animates frame to frame.
  3. PCSS's penumbra-radius PCF is evaluated at `rungs` static kernel radii
     (log-spaced over the exact clamp range [0.5, 2*lightSize],
     gltf.frag:429-431) and log-linearly interpolated per texel. The fixed
     -radius PCF path (use_pcss=False) needs no ladder and matches the
     per-pixel math exactly up to (1) and (2).

Duck-receiver pixels (not on the plane) and pixels outside the window keep
the exact per-pixel sparse path — eligibility is a per-pixel VALUE test
(world position on the plane, unit up normal), so a wrong guess is
impossible: any pixel that fails the test simply stays exact.

Reference semantics: gltf.frag:366-527 (PCSS + PCF cores),
gltf_renderer.rs:806-833 (samplers).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .shadow_filter import (BLOCKER_SAMPLES, PCF_SAMPLES, shadow_frame_phi,
                            vogel_disk_all)
from .uniforms import FrameUniforms

# World height of the planar receiver (the reference's ground quad,
# gltf_renderer.rs:610-678, lies at y=0 with an identity model matrix).
GROUND_Y = 0.0

# Static halo: taps reach at most 2*lightSize texels (the penumbra clamp,
# gltf.frag:429-431) + the bilinear footprint; softness is clamped to
# GltfConfig.max_softness (default 4) by the same `ok` guard the closed
# forms use.
def halo_texels(max_softness: float) -> int:
    return math.ceil(4.0 * max_softness) + 2


def ground_constants(uni: FrameUniforms):
    """Frame constants of a y-up planar receiver: (n_dot_l, world-space
    normal offset, depth bias) — gltf.frag:391-410 evaluated at
    normal == (0, 1, 0)."""
    ndl = jnp.maximum(uni.light_dir[1], 0.0)
    normal_off = 0.02 * (1.0 - ndl)
    bias = 0.0008 + 0.0025 * (1.0 - ndl)
    return ndl, normal_off, bias


def biased_ground_planes(light_view_proj: jnp.ndarray,
                         plane_y: jnp.ndarray) -> jnp.ndarray:
    """(L, 3) uv-space NDC-depth planes of the world plane y=plane_y
    (traced height — the receiver plane is offset by the constant ground
    normal bias). Same fit as shadow_classify.light_ground_planes."""
    ys = jnp.broadcast_to(plane_y, (3,))
    pts = jnp.stack([
        jnp.stack([jnp.float32(0.0), ys[0], jnp.float32(0.0)]),
        jnp.stack([jnp.float32(7.0), ys[1], jnp.float32(1.0)]),
        jnp.stack([jnp.float32(3.0), ys[2], jnp.float32(-6.0)]),
    ])
    hom = jnp.concatenate([pts, jnp.ones((3, 1), jnp.float32)], axis=-1)
    clip = jnp.einsum("cij,nj->cni", light_view_proj, hom)   # (L, 3, 4)
    ndc = clip[..., :3] / clip[..., 3:4]
    uv = ndc[..., :2] * 0.5 + 0.5
    a_mat = jnp.concatenate(
        [uv, jnp.ones(uv.shape[:-1] + (1,), jnp.float32)], axis=-1)
    return jnp.linalg.solve(a_mat, ndc[..., 2:3])[..., 0]    # (L, 3)


def occluder_uv_bbox(world_v: jnp.ndarray, vert_object: jnp.ndarray,
                     light_view_proj: jnp.ndarray):
    """Per-cascade uv bbox of all NON-ground vertices — because the light
    projection is orthographic ALONG the light direction, a vertex and its
    shadow point on the ground project to the same light-space (u, v), so
    this bbox IS the scene's shadow footprint on the ground. Returns
    (lo, hi): each (L, 2) in uv units."""
    mask = (vert_object != 0)[None, :]                       # (1, V)
    ones = jnp.ones((world_v.shape[0], 1), jnp.float32)
    hom = jnp.concatenate([world_v, ones], axis=-1)
    clip = jnp.einsum("cij,vj->cvi", light_view_proj, hom)   # (L, V, 4)
    uv = clip[..., :2] / clip[..., 3:4] * 0.5 + 0.5          # (L, V, 2)
    big = jnp.float32(1e30)
    lo = jnp.min(jnp.where(mask[..., None], uv, big), axis=1)
    hi = jnp.max(jnp.where(mask[..., None], uv, -big), axis=1)
    return lo, hi


def window_pad(max_softness: float, coarse: int) -> int:
    """Texels of margin around the shadow footprint that can still hold
    unclosed ground pixels: penumbra/tap reach (halo) + the classification
    cell quantization and its dilation looseness around silhouettes."""
    return halo_texels(max_softness) + 2 * coarse + 16


def window_size_for_extent(extent: int, pad: int,
                           fetch_count: int = 1 << 30) -> int:
    """Static window size for a measured footprint extent (host math, used
    by autotune): footprint + 2*pad rounded up to 128, capped at 768 (the
    dense pass cost grows with the window; tails past the cap just stay on
    the exact path), 0 when too few pixels fetch to pay for a dense pass."""
    if fetch_count < 1024 or extent <= 0:
        return 0
    want = -(-(extent + 2 * pad) // 128) * 128
    return int(min(max(want, 256), 768))


def plan_windows(uni: FrameUniforms, world_v: jnp.ndarray,
                 vert_object: jnp.ndarray, sizes, map_size: int,
                 max_softness: float, coarse: int):
    """Per-cascade window origins for the given static sizes (None where
    size is 0), placed on the scene's shadow-footprint bbox. Shared by
    render_gltf_frame and the autotune diagnostics so the measured fetch
    counts match the frame's actual windows."""
    lo, hi = occluder_uv_bbox(world_v, vert_object, uni.light_view_proj)
    pad = window_pad(max_softness, coarse)
    origins = []
    for c in range(len(sizes)):
        if sizes[c]:
            origins.append(window_origin(lo[c], hi[c], map_size, sizes[c],
                                         pad))
        else:
            origins.append(None)
    return tuple(origins), (lo, hi)


def window_origin(lo_uv: jnp.ndarray, hi_uv: jnp.ndarray, size: int,
                  wc: int, pad: int):
    """Clamped integer window origin (oy, ox) for one cascade from the
    footprint bbox (uv) + pad texels; centers the window on the footprint
    when it's smaller than the bbox (pixels outside simply stay exact)."""
    lo_t = jnp.floor(lo_uv * size).astype(jnp.int32) - pad
    hi_t = jnp.ceil(hi_uv * size).astype(jnp.int32) + pad
    center = (lo_t + hi_t) // 2
    org = jnp.clip(center - wc // 2, 0, max(size - wc, 0))
    # align to 8 for stable layout
    org = (org // 8) * 8
    return org[1], org[0]     # (oy, ox) from (u, v) = (x, y)


def _shift(window: jnp.ndarray, halo: int, wc: int, sy, sx):
    """(wc, wc) view of the haloed window at traced integer shift."""
    return jax.lax.dynamic_slice(
        window, (halo + sy, halo + sx), (wc, wc))


def _compare_taps(qwin, halo, wc, receiver, dx, dy, radius_texels,
                  count):
    """Mean and mean-square of `count` compare-bilinear taps (the
    sampler2DArrayShadow tap, ops/sampling.sample_shadow_compare_packed)
    at spatially-constant offsets (dx, dy) * radius_texels. Out-of-map
    corners read the 1.0 border pad => lit, matching CLAMP_TO_BORDER
    white for receiver <= 1 (callers guard receiver <= 1).

    qwin: QUAD-PACKED haloed window (wc+2h, wc+2h, 4) — one dynamic
    slice per tap delivers all four bilinear corners (taps never touch
    the packed array's clamped last row/col: |base shift| <= halo - 2)."""
    s_sum = jnp.zeros_like(receiver)
    s_sum2 = jnp.zeros_like(receiver)
    for k in range(count):
        ox = dx[k] * radius_texels
        oy = dy[k] * radius_texels
        x0 = jnp.floor(ox).astype(jnp.int32)
        y0 = jnp.floor(oy).astype(jnp.int32)
        fx = ox - x0.astype(jnp.float32)
        fy = oy - y0.astype(jnp.float32)
        q = jax.lax.dynamic_slice(qwin, (halo + y0, halo + x0, 0),
                                  (wc, wc, 4))
        t00 = (receiver <= q[..., 0]).astype(jnp.float32)
        t10 = (receiver <= q[..., 1]).astype(jnp.float32)
        t01 = (receiver <= q[..., 2]).astype(jnp.float32)
        t11 = (receiver <= q[..., 3]).astype(jnp.float32)
        top = t00 * (1 - fx) + t10 * fx
        bot = t01 * (1 - fx) + t11 * fx
        tap = top * (1 - fy) + bot * fy
        s_sum = s_sum + tap
        s_sum2 = s_sum2 + tap * tap
    return s_sum / count, s_sum2 / count


def build_light_shadow_map(raw_map: jnp.ndarray, origin, plane: jnp.ndarray,
                           uni: FrameUniforms, use_pcss: bool, wc: int,
                           max_softness: float, bias: jnp.ndarray,
                           rungs: int = 6, phases: int = 4) -> jnp.ndarray:
    """Dense PCSS/PCF over a (wc, wc) light-space window of one cascade,
    for a planar receiver at `plane` (biased-ground NDC-depth plane).

    raw_map: (S, S) raw cascade depth. origin: (oy, ox) traced int32,
    pre-clamped to [0, S-wc]. Returns (wc*wc, 4) rows
    [v, m2, kernel_radius, 1.0] — the exact ShadowResult fields a sparse
    penumbra entry would produce (lit/no-blocker overrides pre-applied).
    """
    from ..ops.sampling import quad_pack

    s = raw_map.shape[0]
    halo = halo_texels(max_softness)
    padded = jnp.pad(raw_map, halo, constant_values=1.0)
    window = jax.lax.dynamic_slice(
        padded, (origin[0], origin[1]), (wc + 2 * halo, wc + 2 * halo))
    # One quad-packed copy serves every compare tap (1 slice/tap, not 4);
    # the barrier keeps XLA from re-deriving the pack inside each tap.
    qwin = jax.lax.optimization_barrier(quad_pack(window))

    # receiver = biased plane depth at texel centers (dense affine image)
    tx = (origin[1].astype(jnp.float32) + jnp.arange(wc, dtype=jnp.float32)
          + 0.5) / s
    ty = (origin[0].astype(jnp.float32) + jnp.arange(wc, dtype=jnp.float32)
          + 0.5) / s
    receiver = (plane[0] * tx[None, :] + plane[1] * ty[:, None]
                + plane[2]) - bias

    softness = uni.shadow_bias[0]

    # Rotation phases (deviation #2): a 2x2 checkerboard of `phases`
    # distinct Vogel rotations — IGN sampled at 4 screen points, so the
    # temporal animation matches the per-pixel path's — selected by
    # GLOBAL texel parity (stable as the window origin moves).
    phase_grid = ((origin[0] + jnp.arange(wc, dtype=jnp.int32)) % 2
                  )[:, None] * 2 + (
        (origin[1] + jnp.arange(wc, dtype=jnp.int32)) % 2)[None, :]

    def eval_phase(phi):
        if not use_pcss:
            # Fixed-radius PCF (gltf.frag:453-507): radius is frame
            # -uniform, so this path has NO ladder — it matches the per
            # -pixel tap core exactly up to the texel-center snap + the
            # phase-quantized rotation.
            radius = jnp.maximum(softness, 0.5)

            def taps_3x3(_):
                offs = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
                s_sum = jnp.zeros_like(receiver)
                s_sum2 = jnp.zeros_like(receiver)
                for ox, oy in offs:
                    t = (receiver <= _shift(window, halo, wc,
                                            jnp.int32(oy), jnp.int32(ox))
                         ).astype(jnp.float32)
                    s_sum = s_sum + t
                    s_sum2 = s_sum2 + t * t
                return (s_sum / 9.0, s_sum2 / 9.0,
                        jnp.ones_like(receiver))

            def taps_vogel(_):
                dx, dy = vogel_disk_all(PCF_SAMPLES, phi)
                m1, m2 = _compare_taps(qwin, halo, wc, receiver, dx, dy,
                                       radius, PCF_SAMPLES)
                return m1, m2, jnp.full_like(receiver, radius)

            m1, m2, kern = jax.lax.cond(radius <= 1.25, taps_3x3,
                                        taps_vogel, operand=None)
            return jnp.stack([m1, m2, kern, jnp.ones_like(m1)], axis=-1)

        light_size = softness * 2.0                       # gltf.frag:415

        # --- blocker search (gltf.frag:366-388): NEAREST taps -> integer
        # shifts (tap texel = floor(t + 0.5 + d) = t + floor(0.5 + d)).
        dx, dy = vogel_disk_all(BLOCKER_SAMPLES, phi)
        b_sum = jnp.zeros_like(receiver)
        b_cnt = jnp.zeros_like(receiver)
        for k in range(BLOCKER_SAMPLES):
            sx = jnp.floor(0.5 + dx[k] * light_size).astype(jnp.int32)
            sy = jnp.floor(0.5 + dy[k] * light_size).astype(jnp.int32)
            d = _shift(window, halo, wc, sy, sx)
            hit = d < receiver
            b_sum = b_sum + jnp.where(hit, d, 0.0)
            b_cnt = b_cnt + hit.astype(jnp.float32)
        has_blockers = b_cnt > 0.0
        blocker_depth = b_sum / jnp.maximum(b_cnt, 1.0)

        # --- penumbra estimate (gltf.frag:425-431)
        ratio = (receiver - blocker_depth) / jnp.maximum(blocker_depth,
                                                         1e-8)
        penumbra = jnp.clip(ratio * light_size, 0.5, light_size * 2.0)

        # --- PCF at `rungs` log-spaced radii + per-texel log-linear
        # interpolation
        dx, dy = vogel_disk_all(PCF_SAMPLES, phi)
        span = jnp.log(jnp.maximum(light_size * 4.0, 1.0 + 1e-6))
        m1 = jnp.zeros_like(receiver)
        m2 = jnp.zeros_like(receiver)
        pos = (rungs - 1) * jnp.log(penumbra / 0.5) / span
        for j in range(rungs):
            r_j = 0.5 * jnp.exp(span * (j / (rungs - 1)))
            w_j = jnp.clip(1.0 - jnp.abs(pos - j), 0.0, 1.0)
            m1_j, m2_j = _compare_taps(qwin, halo, wc, receiver, dx, dy,
                                       r_j, PCF_SAMPLES)
            m1 = m1 + w_j * m1_j
            m2 = m2 + w_j * m2_j

        one = jnp.ones_like(m1)
        v = jnp.where(has_blockers, m1, one)
        m2w = jnp.where(has_blockers, m2, one)
        kern = jnp.where(has_blockers, penumbra, 0.0)
        return jnp.stack([v, m2w, kern, one], axis=-1)

    out = jnp.zeros((wc, wc, 4), jnp.float32)
    for p in range(phases):
        off = jnp.asarray([float(p % 2), float(p // 2)], jnp.float32)
        phi = shadow_frame_phi(off, uni.debug_flags[3], uni.debug_flags[2])
        sel = (phase_grid % phases) == p
        out = jnp.where(sel[..., None], eval_phase(phi), out)
    return out.reshape(wc * wc, 4)


def ground_eligible(world: jnp.ndarray, normal: jnp.ndarray,
                    receiver: jnp.ndarray) -> jnp.ndarray:
    """Pixels whose shadow evaluation is EXACTLY the planar-receiver math:
    on the plane, unit up normal (=> the constant ground bias/offset), and
    receiver inside the map's depth range (the border-pad compare identity
    needs receiver <= 1)."""
    return ((jnp.abs(world[..., 1] - GROUND_Y) < 1e-4)
            & (normal[..., 1] > 0.9999)
            & (receiver <= 1.0))
