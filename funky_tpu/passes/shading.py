"""Fragment shading math — jnp ports of cube.frag and gltf.frag's lighting.

Pure element-wise work over (H, W, ...) arrays; XLA fuses the whole
thing into the surrounding passes. Shadow/TAA/contact terms are computed by
their own passes and fed in as the `shadow` scalar field.

Parity notes:
- viewDir = normalize(cameraPos) — the reference normalizes the camera
  *position*, not the per-pixel view vector (cube.frag:18, gltf.frag:598).
  Reproduced verbatim: it is visibly part of the reference look.
- fill light dir (-0.5, 0.3, -0.8) normalized (both shaders).
- cube: ambient 0.20, diffuse 0.65, spec pow 64 * 0.4, blue rim light
  pow2 * 0.5 (cube.frag:16-46).
- gltf: ambient 0.25, diffuse 0.65 * shadow, spec pow 32 * 0.3 gated on
  useTexture, alpha from texture (gltf.frag:592-655).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.scene import FLAG_USE_TEXTURE
from ..ops.sampling import (quad_pack_nhwc,
                            sample_bilinear_repeat_packed_layers)
from .deferred import GBuffer

_FILL_DIR = (-0.5, 0.3, -0.8)


def _normalize(v, axis=-1):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=axis, keepdims=True), 1e-12)


def shade_cube(gbuf: GBuffer, camera_pos: jnp.ndarray,
               light_dir: jnp.ndarray, background: jnp.ndarray) -> jnp.ndarray:
    """cube.frag:16-46. Returns (H, W, 4) linear RGBA."""
    normal = _normalize(gbuf.normal)
    light = _normalize(light_dir)
    view = _normalize(camera_pos)

    n_dot_l = jnp.sum(normal * light, axis=-1, keepdims=True)
    diff = jnp.maximum(n_dot_l, 0.0)

    fill_dir = _normalize(jnp.asarray(_FILL_DIR, jnp.float32))
    fill_diff = jnp.maximum(
        jnp.sum(normal * fill_dir, axis=-1, keepdims=True), 0.0) * 0.3

    half_dir = _normalize(light + view)
    spec = jnp.power(
        jnp.maximum(jnp.sum(normal * half_dir, axis=-1, keepdims=True), 0.0),
        64.0)

    rim = 1.0 - jnp.maximum(
        jnp.sum(normal * view, axis=-1, keepdims=True), 0.0)
    rim = jnp.power(rim, 2.0) * 0.5

    color = gbuf.color
    result = (0.20 * color + 0.65 * diff * color + fill_diff * color
              + 0.4 * spec + rim * jnp.asarray([0.8, 0.9, 1.0], jnp.float32))

    rgb = jnp.where(gbuf.valid[..., None], result, background)
    alpha = jnp.ones_like(rgb[..., :1])
    return jnp.concatenate([rgb, alpha], axis=-1)


def shade_gltf(gbuf: GBuffer, texture: jnp.ndarray,
               texture_sizes: jnp.ndarray, camera_pos: jnp.ndarray,
               light_dir: jnp.ndarray, shadow: jnp.ndarray,
               background: jnp.ndarray,
               texture_block_capacity: int | None = None,
               committed: bool = False) -> jnp.ndarray:
    """gltf.frag main lighting (gltf.frag:592-655), with the shadow term
    (already TAA'd and min'd with contact shadows) supplied.

    texture is layered (N, H, W, 4); the per-pixel layer comes from the
    triangle flag high bits (per-mesh textures — an extension over the
    reference's single binding, gltf_renderer.rs:217-277).

    texture_block_capacity: sample the texture only for 8x8 screen blocks
    that contain textured pixels (compacted; the duck covers a few % of
    the screen but its 512^2 packed table gathers at the above-cliff
    rate, ~24 ms dense at 1080p). None = dense. Overflow falls back to
    the dense sampling via lax.cond (exact either way — identical
    sampler on identical inputs).

    Returns (H, W, 4) linear RGBA.
    """
    use_texture = (gbuf.flags & FLAG_USE_TEXTURE) != 0
    layer = gbuf.flags >> 8
    # Quad-packed bilinear: one gathered row per pixel instead of four.
    # The barrier keeps the packing rolls from fusing into the gather.
    tex_packed = jax.lax.optimization_barrier(
        jax.vmap(quad_pack_nhwc)(texture))

    def sample_dense(_):
        return sample_bilinear_repeat_packed_layers(
            tex_packed, texture_sizes, layer, gbuf.uv)

    comp = None
    if texture_block_capacity is not None:
        from ..ops.compact import (compact_blocks_any, gather_rows,
                                   scatter_back)

        # 8x8 spatial blocks on 2D domains, 64-runs on the blocked back
        # half's flat compacted domain.
        comp = compact_blocks_any(use_texture, texture_block_capacity)
    if comp is not None:
        n = use_texture.size

        def sample_blocks(_):
            uv_e = gather_rows(gbuf.uv.reshape(n, 2), comp)
            layer_e = gather_rows(layer.reshape(n), comp)
            vals = sample_bilinear_repeat_packed_layers(
                tex_packed, texture_sizes, layer_e, uv_e)
            return scatter_back(jnp.ones((n, 4), jnp.float32), comp,
                                vals).reshape(use_texture.shape + (4,))

        if committed:
            # Elided overflow cond (GltfFrameFlags.committed): dropped
            # blocks sample flat white — bounded local artifact, caught
            # by FrameDriver's occupancy poll.
            tex = sample_blocks(None)
        else:
            tex = jax.lax.cond(comp.count <= texture_block_capacity,
                               sample_blocks, sample_dense, operand=None)
    else:
        tex = sample_dense(None)
    tex = jnp.where(use_texture[..., None], tex, 1.0)

    normal = _normalize(gbuf.normal)
    light = _normalize(light_dir)
    view = _normalize(camera_pos)

    n_dot_l = jnp.sum(normal * light, axis=-1, keepdims=True)
    diff = jnp.maximum(n_dot_l, 0.0)

    fill_dir = _normalize(jnp.asarray(_FILL_DIR, jnp.float32))
    fill_diff = jnp.maximum(
        jnp.sum(normal * fill_dir, axis=-1, keepdims=True), 0.0) * 0.3

    half_dir = _normalize(light + view)
    spec = jnp.power(
        jnp.maximum(jnp.sum(normal * half_dir, axis=-1, keepdims=True), 0.0),
        32.0)

    base_color = tex[..., :3] * gbuf.color
    ambient = 0.25 * base_color
    diffuse = 0.65 * diff * base_color * shadow[..., None]
    fill = fill_diff * base_color
    spec_factor = jnp.where(use_texture[..., None], 1.0, 0.0)
    specular = 0.3 * spec * spec_factor

    result = ambient + diffuse + fill + specular
    rgb = jnp.where(gbuf.valid[..., None], result, background)
    alpha = jnp.where(gbuf.valid[..., None], tex[..., 3:4], 1.0)
    return jnp.concatenate([rgb, alpha], axis=-1)


def cascade_debug_color(gbuf: GBuffer, c0: jnp.ndarray, c1: jnp.ndarray,
                        ct: jnp.ndarray, shadow: jnp.ndarray,
                        background: jnp.ndarray) -> jnp.ndarray:
    """Cascade visualization mode (gltf.frag:621-634)."""
    colors = jnp.asarray([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2],
                          [0.2, 0.4, 1.0], [1.0, 1.0, 0.2]], jnp.float32)

    def pick(idx):  # one-hot select (per-pixel table gathers are slow)
        oh = (idx[..., None] == jnp.arange(4, dtype=jnp.int32)).astype(
            jnp.float32)
        return oh @ colors

    base = pick(c0)
    blended = jnp.where((ct > 0.0)[..., None],
                        base * (1.0 - ct[..., None])
                        + pick(c1) * ct[..., None],
                        base)
    rgb = blended * (0.35 + 0.65 * shadow[..., None])
    rgb = jnp.where(gbuf.valid[..., None], rgb, background)
    return jnp.concatenate([rgb, jnp.ones_like(rgb[..., :1])], axis=-1)
