"""Device scene packing: CPU scene description -> HBM-resident SoA arrays.

This replaces the reference's Vulkan vertex/index/uniform buffer machinery
(gltf_renderer.rs:466-560 and cube.rs:66-100): instead of per-mesh buffer
objects and per-draw push constants, the whole scene is concatenated into
struct-of-arrays jnp arrays with a per-vertex / per-triangle *object slot*.
Per-object model matrices and flags (useTexture) are small (O, ...) arrays
computed per frame, so "one draw call per mesh with push constants" becomes
"one fully vectorized vertex/raster pass over everything".

Arrays are padded to multiples of ROW_QUANTUM rows; padded triangles are
degenerate (all indices 0 via a zero-area guard in the rasterizer).

Material base colors are baked into vertex colors exactly like the reference
(gltf_renderer.rs:469-490); textures are decoded sRGB->linear float, which
is what sampling R8G8B8A8_SRGB returns in hardware (gltf_renderer.rs:1495).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .gltf import GltfScene
from .png_io import srgb_to_linear
from .primitives import ground_plane_geometry

# Row padding: scenes whose sizes round to the same multiple share one
# compiled frame, and every row count stays a multiple of a GPU warp (32)
# and of the 128-entry bin-capacity quantum (utils/autotune).
ROW_QUANTUM = 128


def _pad_rows(arr: np.ndarray, multiple: int = ROW_QUANTUM) -> np.ndarray:
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceScene:
    """HBM-resident scene. A pytree: jit-traceable, shardable."""
    positions: jnp.ndarray    # (V, 3) f32 object space
    normals: jnp.ndarray      # (V, 3) f32
    uvs: jnp.ndarray          # (V, 2) f32
    colors: jnp.ndarray       # (V, 3) f32 (material base color baked)
    vert_object: jnp.ndarray  # (V,) i32 object slot per vertex
    tri_indices: jnp.ndarray  # (T, 3) i32
    tri_object: jnp.ndarray   # (T,) i32
    tri_flags: jnp.ndarray    # (T,) i32 — bit 0: useTexture; bits 8+:
    #                           texture layer (per-mesh textures, an
    #                           extension over the reference's single
    #                           binding, gltf_renderer.rs:217-277)
    texture: jnp.ndarray      # (N, Th, Tw, 4) f32 linear RGBA layers;
    #                           smaller textures are WRAP-padded to the
    #                           common size so REPEAT addressing against
    #                           the true size stays exact
    texture_sizes: jnp.ndarray  # (N, 2) f32 true (h, w) per layer
    num_vertices: int         # static: real (unpadded) counts
    num_triangles: int
    num_objects: int

    def tree_flatten(self):
        children = (self.positions, self.normals, self.uvs, self.colors,
                    self.vert_object, self.tri_indices, self.tri_object,
                    self.tri_flags, self.texture, self.texture_sizes)
        aux = (self.num_vertices, self.num_triangles, self.num_objects)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


FLAG_USE_TEXTURE = 1

# Object slot layout for the glTF scene (matches the reference draw order,
# gltf_renderer.rs:2283-2341: ground first with useTexture=0, then meshes
# with useTexture=1):
OBJ_GROUND = 0
OBJ_MODEL = 1  # all glTF meshes share the duck model transform


def build_device_scene(scene: Optional[GltfScene],
                       include_ground: bool = True,
                       ground_size: float = 20.0) -> DeviceScene:
    """Pack ground plane + glTF meshes into a DeviceScene.

    Object slots: 0 = ground (identity model), 1 = the glTF model (all its
    primitives share one model matrix, like the reference's duck_model).
    """
    pos_l, nrm_l, uv_l, col_l, obj_l = [], [], [], [], []
    tri_l, tobj_l, tflag_l = [], [], []
    base = 0

    def add_mesh(p, n, uv, c, idx, obj, flags):
        nonlocal base
        pos_l.append(p); nrm_l.append(n); uv_l.append(uv); col_l.append(c)
        obj_l.append(np.full(len(p), obj, np.int32))
        tri = idx.reshape(-1, 3).astype(np.int64) + base
        tri_l.append(tri)
        tobj_l.append(np.full(len(tri), obj, np.int32))
        tflag_l.append(np.full(len(tri), flags, np.int32))
        base += len(p)

    if include_ground:
        gp, gn, guv, gc, gi = ground_plane_geometry(ground_size)
        add_mesh(gp, gn, guv, gc, gi, OBJ_GROUND, 0)

    texture = None
    texture_sizes = None
    if scene is not None:
        has_texture = len(scene.textures) > 0
        for mesh in scene.meshes:
            v = mesh.vertices
            # Bake material base color over vertex color
            # (gltf_renderer.rs:469-490).
            color = v.colors
            # glTF semantics: textured iff the material names a
            # baseColorTexture (the reference binds texture[0] for every
            # mesh instead, gltf_renderer.rs:217-277 — identical for its
            # one-mesh-one-texture sample scenes; meshes whose material
            # has no texture are correctly untextured here). Meshes with
            # no material at all keep texture 0 when the scene has one.
            tex_idx = 0 if has_texture else None
            if mesh.material_index is not None and mesh.material_index < len(
                    scene.materials):
                mat = scene.materials[mesh.material_index]
                color = np.tile(mat.base_color[:3].astype(np.float32),
                                (len(v.positions), 1))
                tex_idx = mat.base_color_texture_index
            flags = 0
            if has_texture and tex_idx is not None:
                flags = FLAG_USE_TEXTURE | (min(
                    tex_idx, len(scene.textures) - 1) << 8)
            add_mesh(v.positions, v.normals, v.tex_coords, color,
                     mesh.indices, OBJ_MODEL, flags)
        if has_texture:
            texture, texture_sizes = _pack_texture_layers(scene.textures)

    if texture is None:
        # 1x1 white fallback (create_fallback_texture,
        # gltf_renderer.rs:1577-1586), padded to an 8x128 layer.
        texture = np.ones((1, 8, 128, 4), np.float32)
        texture_sizes = np.asarray([[8.0, 128.0]], np.float32)

    positions = _pad_rows(np.concatenate(pos_l).astype(np.float32))
    num_vertices = base
    num_triangles = sum(len(t) for t in tri_l)

    return DeviceScene(
        positions=jnp.asarray(positions),
        normals=jnp.asarray(_pad_rows(np.concatenate(nrm_l).astype(np.float32))),
        uvs=jnp.asarray(_pad_rows(np.concatenate(uv_l).astype(np.float32))),
        colors=jnp.asarray(_pad_rows(np.concatenate(col_l).astype(np.float32))),
        vert_object=jnp.asarray(_pad_rows(np.concatenate(obj_l))),
        tri_indices=jnp.asarray(
            _pad_rows(np.concatenate(tri_l).astype(np.int32))),
        tri_object=jnp.asarray(_pad_rows(np.concatenate(tobj_l))),
        tri_flags=jnp.asarray(_pad_rows(np.concatenate(tflag_l))),
        texture=jnp.asarray(texture),
        texture_sizes=jnp.asarray(texture_sizes),
        num_vertices=num_vertices,
        num_triangles=num_triangles,
        num_objects=2,
    )


def _pack_texture_layers(textures):
    """Decode sRGB->linear and stack textures into one (N, H, W, 4) array.
    Smaller layers are WRAP-padded (tiled) to the common size: REPEAT
    addressing resolves against the TRUE size (texture_sizes), and the
    wrap padding makes the quad-packed +1 neighbors at a layer's true
    edge hold the correct wrapped texel."""
    max_h = max(t.height for t in textures)
    max_w = max(t.width for t in textures)
    layers = []
    sizes = []
    for t in textures:
        tex8 = t.data
        lin = np.concatenate([
            srgb_to_linear(tex8[..., :3].astype(np.float32) / 255.0),
            tex8[..., 3:].astype(np.float32) / 255.0,
        ], axis=-1).astype(np.float32)
        reps = (-(-max_h // t.height), -(-max_w // t.width), 1)
        layers.append(np.tile(lin, reps)[:max_h, :max_w])
        sizes.append([float(t.height), float(t.width)])
    return (np.stack(layers).astype(np.float32),
            np.asarray(sizes, np.float32))


def build_cube_scene() -> DeviceScene:
    """The rotating-cube demo scene (cube.rs) as a single-object
    DeviceScene (object slot 0 = the cube)."""
    from .primitives import cube_geometry

    p, n, c, idx = cube_geometry()
    uv = np.zeros((len(p), 2), np.float32)
    tri = idx.reshape(-1, 3).astype(np.int32)
    return DeviceScene(
        positions=jnp.asarray(_pad_rows(p)),
        normals=jnp.asarray(_pad_rows(n)),
        uvs=jnp.asarray(_pad_rows(uv)),
        colors=jnp.asarray(_pad_rows(c)),
        vert_object=jnp.asarray(_pad_rows(np.zeros(len(p), np.int32))),
        tri_indices=jnp.asarray(_pad_rows(tri)),
        tri_object=jnp.asarray(_pad_rows(np.zeros(len(tri), np.int32))),
        tri_flags=jnp.asarray(_pad_rows(np.zeros(len(tri), np.int32))),
        texture=jnp.ones((1, 8, 128, 4), jnp.float32),
        texture_sizes=jnp.asarray([[8.0, 128.0]], jnp.float32),
        num_vertices=len(p),
        num_triangles=len(tri),
        num_objects=1,
    )
