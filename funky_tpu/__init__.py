"""funky_tpu — a JAX software rendering framework.

A re-design of the capabilities of funky-renderer (a Rust/Vulkan forward
renderer) as a pure-JAX engine, run on an NVIDIA GPU (CPU for tests):

- Scene buffers (vertices, indices, textures, shadow maps) are HBM-resident
  jnp arrays (struct-of-arrays), not Vulkan buffer objects.
- The whole frame — 4 cascaded shadow passes, the main visibility pass,
  deferred PCF/PCSS shading, shadow TAA, contact-shadow ray marching and the
  UI overlay composite — is ONE jit-compiled pure function
  ``state, image = render_frame(scene, params, state)``.
- Rasterization is tile-binned: triangle setup and binning are vectorized
  XLA ops; the per-tile depth-tested raster loop is a Pallas GPU kernel
  through Triton (with a pure-jnp reference implementation, the CPU path).
- Temporal state (shadow TAA history, previous depth buffer for contact
  shadows, previous view-proj) is an explicit carried pytree, not mutable
  GPU images.

Layer map (mirrors SURVEY.md section 2 component inventory):

=====================  =====================================================
funky_tpu.math3d       glam-equivalent mat4/quat math (exact conventions)
funky_tpu.ecs          ECS-lite world (components/resources/systems)
funky_tpu.models       scene content: glTF loader, cube demo, ground plane,
                       SDF raymarch demo, PNG io
funky_tpu.ops          kernels: binning, raster (jnp + Pallas), sampling,
                       blending
funky_tpu.passes       frame passes: uniforms/cascade fit, shadow, geometry,
                       deferred shading, TAA, contact shadows, overlay
funky_tpu.parallel     device mesh + shard_map multi-chip frame
funky_tpu.app          frame driver, camera controller, debug UI, stats
funky_tpu.utils        image io, profiling
funky_tpu.frame        composed frame functions + compile cache
=====================  =====================================================
"""

__version__ = "0.1.0"

import jax as _jax

# Full f32 matmuls everywhere: on the GPU the default precision lets XLA
# run f32 matmuls in TF32 (~3 decimal digits), which a renderer cannot
# afford (inverse-projected far-plane frustum corners cancel 10 - 9.99 to
# 0 => NaN cascades; vertex positions jitter by whole units). "highest"
# rules TF32 out. Geometry math is tiny next to the per-pixel passes.
_jax.config.update("jax_default_matmul_precision", "highest")
