"""Multi-device frame: shard_map over framebuffer rows.

Parallel decomposition (the generalization of the reference's
tile fan-out, SURVEY.md section 2 #14):

- scene buffers, per-frame params and temporal state are REPLICATED
  (geometry is KBs; pixel buffers are what matters);
- each device rasterizes + shades its row slab of the framebuffer
  (H / n rows) AND its row slab of every shadow cascade (S / n rows);
- shadow-map slabs all-gather before filtering (every pixel can
  sample any cascade texel); finished rgba / history / depth slabs
  all-gather at the end so the returned state is replicated for the next
  frame.

All collectives are jax.lax.all_gather along the 1D 'rows' mesh axis —
device-to-device traffic (NCCL on GPUs), no host involvement. The reference's equivalents were
Vulkan pipeline barriers + a single GPU's hardware scheduler.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..frame import (FrameState, GltfConfig, GltfParams, _main_raster_inputs,
                     compute_frame_uniforms, shade_slab)
from ..models.scene import DeviceScene
from ..ops.raster import raster_corners, raster_scene
from ..passes import geometry
from .mesh import ROWS_AXIS


def sharded_gltf_frame(mesh: Mesh, cfg: GltfConfig):
    """Build a jitted multi-chip frame function.

    Requires cfg.height % (n * tile_h) == 0 and shadow_map_size % (n *
    shadow tile_h) == 0 so row slabs align with raster tiles.

    Returns fn(scene, params, state) -> (rgba, new_state), with all
    inputs/outputs replicated across the mesh.
    """
    n = mesh.shape[ROWS_AXIS]
    flags = cfg.flags
    slab_h = cfg.height // n
    sm_slab = cfg.shadow_map_size // n
    if slab_h * n != cfg.height or slab_h % cfg.raster.tile_h:
        raise ValueError(
            f"height {cfg.height} must split into {n} tile-aligned slabs")
    if sm_slab * n != cfg.shadow_map_size or sm_slab % cfg.shadow_raster.tile_h:
        raise ValueError("shadow map size must split into tile-aligned slabs")

    def frame_body(scene: DeviceScene, params: GltfParams,
                   state: FrameState):
        idx = jax.lax.axis_index(ROWS_AXIS)
        uni = compute_frame_uniforms(params, state, cfg)

        # -- replicated vertex stage (tiny) --
        world_v, clip, normals_v = geometry.transform_vertices(
            scene, uni.models, uni.view_proj)
        blocks = geometry.build_shade_blocks(scene, world_v, clip, normals_v)

        # -- shadow cascades --
        light_maps = None
        if flags.enable_shadows:
            from ..ops.sampling import quad_pack
            from ..passes import shadow
            from ..passes.shadow_classify import (build_class_maps,
                                                  light_ground_planes)

            light_sizes = cfg.effective_light_windows()
            origins = None
            if light_sizes is not None and any(light_sizes):
                from ..passes import shadow_lightspace as lsm

                origins, _ = lsm.plan_windows(
                    uni, world_v, scene.vert_object, light_sizes,
                    cfg.shadow_map_size, cfg.max_softness,
                    cfg.class_coarse)

            if flags.synth_shadow_maps and origins is not None:
                # Synthesized maps are REPLICATED math (analytic ground +
                # a tiny occluder-window raster) — ZERO shadow-map
                # collectives, vs the raw-slab all-gather's 67 MB/frame
                # at 2048^2 (the biggest collective term). The
                # window-overflow fallback is a replicated full raster,
                # so neither cond branch holds a collective (`ok` is
                # replicated: computed from replicated inputs).
                maps_s, synth_ok = shadow.synthesize_shadow_maps(
                    scene, world_v, uni, cfg.shadow_map_size, light_sizes,
                    origins)
                raw_maps = jax.lax.cond(
                    synth_ok, lambda _: maps_s,
                    lambda _: shadow.render_shadow_maps(
                        world_v, scene.tri_indices, scene.num_triangles,
                        uni.light_view_proj, cfg.shadow_raster,
                        cfg.shadow_map_size),
                    operand=None)
            else:
                # each device rasters its row slab of each cascade, then
                # all-gather to the full (4, S, S) maps
                sm_y0 = idx * sm_slab
                ones = jnp.ones((world_v.shape[0], 1), jnp.float32)
                hom = jnp.concatenate([world_v, ones], axis=-1)
                slabs = []
                for c in range(uni.light_view_proj.shape[0]):
                    clip_c = hom @ uni.light_view_proj[c].T
                    _, depth_c, _ = raster_scene(
                        clip_c, scene.tri_indices, cfg.shadow_map_size,
                        cfg.shadow_map_size, scene.num_triangles,
                        cfg.shadow_raster, sm_y0, sm_slab)
                    slabs.append(depth_c)
                local_sm = jnp.stack(slabs)             # (4, S/n, S)
                raw_maps = jax.lax.all_gather(
                    local_sm, ROWS_AXIS, axis=1, tiled=True)  # (4, S, S)
            raw_maps = jax.lax.optimization_barrier(raw_maps)

            class_maps = (build_class_maps(
                raw_maps, cfg.class_coarse, cfg.max_softness,
                light_ground_planes(uni.light_view_proj))
                if flags.sparse_shadows else None)
            shadow_maps = jax.lax.optimization_barrier(
                jax.vmap(quad_pack)(raw_maps))

            if (flags.light_space_ground_shadows and class_maps is not None
                    and origins is not None):
                # replicated dense ground evaluation (tiny windows)
                _, n_off, gbias = lsm.ground_constants(uni)
                planes_b = lsm.biased_ground_planes(
                    uni.light_view_proj, lsm.GROUND_Y + n_off)
                rows_l = []
                for c in range(len(light_sizes)):
                    if light_sizes[c]:
                        rows_l.append(lsm.build_light_shadow_map(
                            raw_maps[c], origins[c], planes_b[c], uni,
                            flags.use_pcss, light_sizes[c],
                            cfg.max_softness, gbias, cfg.light_pcf_rungs))
                    else:
                        rows_l.append(None)
                light_maps = (tuple(rows_l), tuple(origins),
                              tuple(light_sizes), cfg.light_fetch_caps)
        else:
            shadow_maps = None
            class_maps = None

        # -- main pass: row slab of the framebuffer --
        # Near-clip expansion is replicated per device (dense, tiny) so
        # every slab rasters identical extended tables.
        y0 = idx * slab_h
        tri_clip, blocks_m, tri_flags_m, tri_valid = _main_raster_inputs(
            scene, clip, blocks, cfg.clip_capacity)
        tri_id, depth, setup = raster_corners(
            tri_clip, tri_valid, cfg.width, cfg.height, cfg.raster, y0,
            slab_h)

        rgba_slab, hist_slab = shade_slab(
            scene, uni, state, shadow_maps, tri_id, depth, setup.data,
            blocks_m, cfg, y0, class_maps=class_maps,
            tri_flags=tri_flags_m, light_maps=light_maps)

        # -- gather slabs back to replicated full buffers --
        rgba = jax.lax.all_gather(rgba_slab, ROWS_AXIS, axis=0, tiled=True)
        new_history = jax.lax.all_gather(hist_slab, ROWS_AXIS, axis=0,
                                         tiled=True)
        new_depth = jax.lax.all_gather(depth, ROWS_AXIS, axis=0, tiled=True)

        new_state = FrameState(
            shadow_history=new_history,
            prev_depth=new_depth,
            prev_view_proj=uni.view_proj,
            has_prev=jnp.ones((), bool),
            frame_index=state.frame_index + 1,
        )
        return rgba, new_state

    shmapped = jax.shard_map(
        frame_body, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False)
    return jax.jit(shmapped)
