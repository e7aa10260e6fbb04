"""Near-plane triangle clipping (static-shape expansion).

The reference gets near-plane clipping for free from Vulkan's
fixed-function clipper (implicit in the pipeline, gltf_renderer.rs:1324-
1444): a triangle crossing the near plane is replaced by up to two
sub-triangles covering its in-front part. Round 1 culled such triangles
whole (ops/binning.py w-cull) — fly the camera to the ground and geometry
pops out of existence.

Array-program design: clipping must not change array shapes under jit, so we
expand a STATIC number of extra triangle slots. Crossing triangles are
rare (zero in the default views), so a small compacted capacity covers
them; overflow degrades the excess to whole-triangle culls (round-1
behavior), never to wrong pixels.

Clip plane: w = w_eps in clip space, not z = 0. Vulkan's visible volume
(0 <= z <= w) means any fragment with w in (0, w_near) has z outside
[0, 1) and dies to the raster's per-pixel depth clip, so any
0 < w_eps <= w_near yields the same image as the exact fixed-function
clip — and a not-too-tiny w_eps keeps projected coordinates of clipped
corners well-conditioned in f32 (1/w blows up screen coordinates).

Each sub-triangle is a GENUINE triangle: its corners are barycentric
combinations of the original corners, so corner attributes interpolate
linearly in clip space (the definition of clipping) and the per-corner
inv_w in the shade block is recomputed from the clipped w. Deferred
perspective-correct interpolation (passes/deferred.py) therefore needs no
changes — sub-triangles ride the same tables under ids >= T.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .compact import compact_indices


class ClippedGeometry(NamedTuple):
    """Main-raster inputs after near-clip expansion (T' = T + 2*K)."""
    tri_clip: jnp.ndarray   # (T', 3, 4) per-corner clip positions
    blocks: jnp.ndarray     # (T', 3, B) shade blocks (inv_w in last slot)
    tri_flags: jnp.ndarray  # (T',) int32
    valid: jnp.ndarray      # (T',) bool — originals that were clipped (or
    #                         fully behind) are invalidated here
    overflow: jnp.ndarray   # () bool — crossing count exceeded capacity
    #                         (excess triangles culled whole)


def expand_near_clipped(tri_clip: jnp.ndarray, blocks: jnp.ndarray,
                        tri_flags: jnp.ndarray,
                        num_triangles: int | None,
                        capacity: int = 64,
                        w_eps: float = 1e-2) -> ClippedGeometry:
    """Clip triangles crossing w = w_eps into sub-triangles.

    Args:
      tri_clip: (T, 3, 4) clip-space corners (= clip[tri_indices]).
      blocks: (T, 3, B) shade blocks; [..., :B-1] interpolate linearly,
        [..., B-1] is inv_w (recomputed for clipped corners).
      tri_flags: (T,) int32 per-triangle flags.
      num_triangles: real triangle count (padded tail invalid), or None.
      capacity: static max crossing triangles handled per frame.
      w_eps: clip plane; must be <= clip w at the near plane.
    """
    t = tri_clip.shape[0]
    k = min(capacity, t)
    w = tri_clip[..., 3]                                   # (T, 3)
    inside = w > w_eps
    n_in = jnp.sum(inside, axis=-1)
    real = (jnp.arange(t) < num_triangles if num_triangles is not None
            else jnp.ones((t,), bool))
    crossing = (n_in > 0) & (n_in < 3) & real

    comp = compact_indices(crossing, k)
    safe = jnp.maximum(comp.idx, 0)
    c = tri_clip[safe]                                     # (K, 3, 4)
    b = blocks[safe]                                       # (K, 3, B)
    f = tri_flags[safe]
    ins = inside[safe]
    cnt = jnp.sum(ins, axis=-1)                            # 1 or 2

    # Rotate corners to a canonical order:
    #   cnt == 1 -> the inside corner at local 0
    #   cnt == 2 -> the outside corner at local 2
    idx_in = jnp.argmax(ins, axis=-1).astype(jnp.int32)
    idx_out = jnp.argmax(~ins, axis=-1).astype(jnp.int32)
    r = jnp.where(cnt == 1, idx_in, (idx_out + 1) % 3)
    perm = (r[:, None] + jnp.arange(3, dtype=jnp.int32)[None, :]) % 3
    cr = jnp.take_along_axis(c, perm[..., None], axis=1)   # (K, 3, 4)
    br = jnp.take_along_axis(b, perm[..., None], axis=1)
    wr = cr[..., 3]                                        # (K, 3)

    def isect(wa, wb):
        """Edge parameter where w == w_eps (one endpoint each side). The
        true crossing always lies ON the edge, so the parameter is clamped
        to [0, 1]: a near-degenerate denominator (both endpoints within
        ~1e-30 of w_eps) then yields a valid edge point instead of a
        huge/garbage parameter (ADVICE r2)."""
        d = wb - wa
        t = (w_eps - wa) / jnp.where(jnp.abs(d) > 1e-30, d, 1e-30)
        return jnp.clip(t, 0.0, 1.0)[:, None]

    e = jnp.eye(3, dtype=jnp.float32)
    t01 = isect(wr[:, 0], wr[:, 1])
    t02 = isect(wr[:, 0], wr[:, 2])
    t12 = isect(wr[:, 1], wr[:, 2])

    # Clipped polygon as local-barycentric rows (K, 4, 3):
    #   cnt == 2 (quad):     [e0, e1, lerp(e1,e2,t12), lerp(e0,e2,t02)]
    #   cnt == 1 (triangle): [e0, lerp(e0,e1,t01), lerp(e0,e2,t02), dup]
    is1 = (cnt == 1)[:, None]
    q0 = jnp.broadcast_to(e[0], t01.shape[:1] + (3,))
    q1 = jnp.where(is1, e[0] * (1.0 - t01) + e[1] * t01, e[1])
    q2 = jnp.where(is1, e[0] * (1.0 - t02) + e[2] * t02,
                   e[1] * (1.0 - t12) + e[2] * t12)
    q3 = e[0] * (1.0 - t02) + e[2] * t02
    quad = jnp.stack([q0, q1, q2, q3], axis=1)             # (K, 4, 3)

    quad_clip = jnp.einsum("kqj,kjc->kqc", quad, cr)       # (K, 4, 4)
    attr = jnp.einsum("kqj,kjc->kqc", quad, br[..., :-1])  # (K, 4, B-1)
    inv_w = 1.0 / jnp.maximum(quad_clip[..., 3], 1e-12)
    quad_blocks = jnp.concatenate([attr, inv_w[..., None]], axis=-1)

    corners_a = (0, 1, 2)
    corners_b = (0, 2, 3)
    tri_a = quad_clip[:, corners_a, :]
    tri_b = quad_clip[:, corners_b, :]
    blk_a = quad_blocks[:, corners_a, :]
    blk_b = quad_blocks[:, corners_b, :]

    valid_a = comp.slot_valid
    valid_b = comp.slot_valid & (cnt == 2)   # cnt==1's B is a degenerate dup

    # Originals with any corner at w <= w_eps never raster directly: either
    # replaced by their sub-triangles or (all-behind / overflow) culled.
    valid_orig = real & jnp.all(inside, axis=-1)

    return ClippedGeometry(
        tri_clip=jnp.concatenate([tri_clip, tri_a, tri_b], axis=0),
        blocks=jnp.concatenate([blocks, blk_a, blk_b], axis=0),
        tri_flags=jnp.concatenate([tri_flags, f, f], axis=0),
        valid=jnp.concatenate([valid_orig, valid_a, valid_b], axis=0),
        overflow=comp.count > k,
    )
