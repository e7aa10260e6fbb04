"""Vertex stage: object->world->clip transforms + per-triangle shade blocks.

The reference runs gltf.vert per vertex per draw (model matrix via push
constant, gltf.vert:33-47). Here the whole scene transforms in one shot:
positions (V,3) go through a single batched matmul against the per-object
model matrices (selected by object slot), then the view-proj matrix.

Outputs:
- clip positions (V, 4) for triangle setup,
- per-triangle "shade blocks" (T, 3, 12): for each corner
  [world_pos(3), normal(3), uv(2), color(3), inv_w(1)] — everything deferred
  shading needs, pre-gathered per triangle so the shading pass does ONE
  row gather per pixel instead of ten scattered ones.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.scene import DeviceScene

SHADE_BLOCK_WIDTH = 12


def transform_vertices(scene: DeviceScene, models: jnp.ndarray,
                       view_proj: jnp.ndarray):
    """Transform all vertices.

    Args:
      scene: DeviceScene (positions/normals are object space).
      models: (O, 4, 4) per-object model matrices.
      view_proj: (4, 4) proj @ view.

    Returns:
      world (V, 3), clip (V, 4), world_normals (V, 3)
    """
    num_objects = models.shape[0]
    onehot = (scene.vert_object[:, None]
              == jnp.arange(num_objects, dtype=jnp.int32)[None, :]
              ).astype(jnp.float32)                       # (V, O)

    # world_o = pos @ M_o[:3,:3]^T + M_o[:3,3]; select per vertex.
    rot = models[:, :3, :3]                               # (O, 3, 3)
    trans = models[:, :3, 3]                              # (O, 3)
    world_per_obj = jnp.einsum("vj,oij->voi", scene.positions, rot,
                               preferred_element_type=jnp.float32)
    world = jnp.einsum("vo,voi->vi", onehot, world_per_obj) + onehot @ trans

    # Normal matrix = mat3(model) assuming uniform scale (gltf.vert:42-43).
    nrm_per_obj = jnp.einsum("vj,oij->voi", scene.normals, rot,
                             preferred_element_type=jnp.float32)
    nrm = jnp.einsum("vo,voi->vi", onehot, nrm_per_obj)
    nrm = nrm / jnp.maximum(
        jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)

    ones = jnp.ones((world.shape[0], 1), jnp.float32)
    clip = jnp.concatenate([world, ones], axis=-1) @ view_proj.T  # (V, 4)
    return world, clip, nrm


def build_shade_blocks(scene: DeviceScene, world: jnp.ndarray,
                       clip: jnp.ndarray, normals: jnp.ndarray) -> jnp.ndarray:
    """Pack per-corner attributes for deferred shading: (T, 3, 12)."""
    inv_w = 1.0 / jnp.maximum(clip[:, 3:4], 1e-12)        # (V, 1)
    per_vertex = jnp.concatenate(
        [world, normals, scene.uvs, scene.colors, inv_w], axis=-1)  # (V, 12)
    return per_vertex[scene.tri_indices]                  # (T, 3, 12)
