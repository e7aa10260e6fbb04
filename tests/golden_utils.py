"""Shared golden-image render configs (used by tests and regeneration).

Run `python tests/golden_utils.py` to (re)generate tests/goldens/*.png.
Goldens are sRGB-encoded u8 PNGs rendered on the CPU backend; tests
compare with a small tolerance to absorb fp-reorder differences.
"""

import os
import pathlib
import sys

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "goldens"
TOL = 3.0 / 255.0   # u8 quantization + fp-reordering headroom
MAX_BAD_FRAC = 2e-3  # allow a few edge pixels to flicker
DUCK = pathlib.Path("/root/reference/models/scene.gltf")


def golden_mismatch(got, want):
    """(fraction of pixels whose worst channel is off by more than TOL,
    largest difference) between two sRGB images in [0, 1]."""
    diff = np.abs(np.asarray(got, np.float32)
                  - np.asarray(want, np.float32)).max(axis=-1)
    return float((diff > TOL).mean()), float(diff.max())


def render_cube():
    import jax.numpy as jnp

    from funky_tpu.frame import (FrameConfig, compiled_cube_frame,
                                 default_cube_params)
    from funky_tpu.models.scene import build_cube_scene
    from funky_tpu.ops.raster import RasterConfig

    cfg = FrameConfig(width=128, height=128,
                      raster=RasterConfig(tile_h=16, tile_w=128,
                                          capacity=32, backend="jnp"))
    img = compiled_cube_frame(cfg)(build_cube_scene(),
                                   default_cube_params(rotation=0.6))
    return np.asarray(img[..., :3])


def _duck_frame(flags=None, frames=2):
    from funky_tpu.frame import (GltfConfig, GltfFrameFlags,
                                 compiled_gltf_frame, default_gltf_params,
                                 init_frame_state)
    from funky_tpu.models.gltf import GltfScene
    from funky_tpu.models.scene import build_device_scene
    from funky_tpu.ops.raster import RasterConfig

    duck = GltfScene.load(DUCK)
    scene = build_device_scene(duck)
    tile = RasterConfig(tile_h=16, tile_w=128, capacity=4352, backend="jnp")
    cfg = GltfConfig(width=256, height=144, shadow_map_size=256,
                     raster=tile, shadow_raster=tile,
                     flags=flags or GltfFrameFlags())
    params = default_gltf_params(gltf_min_y=float(duck.bounds_min[1]))
    frame = compiled_gltf_frame(cfg)
    state = init_frame_state(cfg)
    for _ in range(frames):
        rgba, state = frame(scene, params, state)
    return np.asarray(rgba[..., :3])


def render_duck():
    return _duck_frame()


def render_duck_cascades():
    from funky_tpu.frame import GltfFrameFlags

    return _duck_frame(GltfFrameFlags(debug_cascades=True))


def render_sdf():
    from funky_tpu.models.sdf import (SdfConfig, compiled_sdf_frame,
                                      default_sdf_camera)

    cfg = SdfConfig(width=160, height=96)
    pos, yaw, pitch, fov = default_sdf_camera()
    img = compiled_sdf_frame(cfg)(1.0, pos, yaw, pitch, fov)
    return np.asarray(img[..., :3])


def render_duck_pcf():
    from funky_tpu.frame import GltfFrameFlags

    return _duck_frame(GltfFrameFlags(use_pcss=False))


def render_duck_no_taa():
    from funky_tpu.frame import GltfFrameFlags

    return _duck_frame(GltfFrameFlags(use_shadow_taa=False))


def render_duck_contact_only():
    from funky_tpu.frame import GltfFrameFlags

    return _duck_frame(GltfFrameFlags(enable_shadows=False,
                                      enable_contact_shadows=True),
                       frames=3)


def render_duck_ui():
    """Full frame + debug-panel composite (the overlay path)."""
    from funky_tpu.app.driver import FrameDriver
    from funky_tpu.frame import GltfConfig
    from funky_tpu.models.png_io import srgb_to_linear
    from funky_tpu.ops.raster import RasterConfig

    tile = RasterConfig(tile_h=16, tile_w=128, capacity=4352, backend="jnp")
    cfg = GltfConfig(width=448, height=256, shadow_map_size=256,
                     raster=tile, shadow_raster=tile)
    drv = FrameDriver(cfg, scene_path=str(DUCK), autotune=False)
    for _ in range(2):
        drv.step()
    # readback() returns sRGB; goldens store linear -> round-trip back.
    return srgb_to_linear(drv.readback())


def render_multimesh():
    import tempfile

    from funky_tpu.frame import (GltfConfig, compiled_gltf_frame,
                                 default_gltf_params, init_frame_state)
    from funky_tpu.models.gltf import GltfScene
    from funky_tpu.models.sample_scenes import build_multimesh_glb
    from funky_tpu.models.scene import build_device_scene
    from funky_tpu.ops.raster import RasterConfig

    with tempfile.TemporaryDirectory() as td:
        glb = build_multimesh_glb(pathlib.Path(td) / "multi.glb",
                                  two_textures=True)
        scene = GltfScene.load(glb)
    ds = build_device_scene(scene)
    tile = RasterConfig(tile_h=16, tile_w=128, backend="jnp")
    cfg = GltfConfig(width=256, height=144, shadow_map_size=256,
                     raster=tile, shadow_raster=tile)
    params = default_gltf_params(gltf_min_y=float(scene.bounds_min[1]),
                                 gltf_scale=1.0)
    frame = compiled_gltf_frame(cfg)
    state = init_frame_state(cfg)
    for _ in range(2):
        rgba, state = frame(ds, params, state)
    return np.asarray(rgba[..., :3])


def render_jpeg_quad():
    """JPEG-textured quad (embedded image/jpeg GLB) — parity with the
    reference's any-format texture decode (gltf_loader.rs:100,116)."""
    import tempfile

    from funky_tpu.frame import (GltfConfig, compiled_gltf_frame,
                                 default_gltf_params, init_frame_state)
    from funky_tpu.models.gltf import GltfScene
    from funky_tpu.models.sample_scenes import build_textured_quad_glb
    from funky_tpu.models.scene import build_device_scene
    from funky_tpu.ops.raster import RasterConfig

    jpg = (pathlib.Path(__file__).parent / "assets"
           / "quad_tex_420p.jpg").read_bytes()
    with tempfile.TemporaryDirectory() as td:
        glb = build_textured_quad_glb(pathlib.Path(td) / "quad.glb", jpg)
        scene = GltfScene.load(glb)
    ds = build_device_scene(scene)
    tile = RasterConfig(tile_h=16, tile_w=128, capacity=64, backend="jnp")
    cfg = GltfConfig(width=192, height=112, shadow_map_size=64,
                     raster=tile, shadow_raster=tile)
    params = default_gltf_params(gltf_min_y=0.0, gltf_scale=1.0)
    frame = compiled_gltf_frame(cfg)
    state = init_frame_state(cfg)
    for _ in range(2):
        rgba, state = frame(ds, params, state)
    return np.asarray(rgba[..., :3])


GOLDENS = {
    "cube_r06_128.png": render_cube,
    "duck_shadows_256x144.png": render_duck,
    "duck_cascade_debug_256x144.png": render_duck_cascades,
    "duck_pcf_256x144.png": render_duck_pcf,
    "duck_no_taa_256x144.png": render_duck_no_taa,
    "duck_contact_only_256x144.png": render_duck_contact_only,
    "duck_ui_448x256.png": render_duck_ui,
    "multimesh_pbr_256x144.png": render_multimesh,
    "jpeg_quad_192x112.png": render_jpeg_quad,
    "sdf_t1_160x96.png": render_sdf,
}


def generate():
    from funky_tpu.models.png_io import linear_to_srgb, write_png

    GOLDEN_DIR.mkdir(exist_ok=True)
    for name, fn in GOLDENS.items():
        img = np.asarray(linear_to_srgb(fn()))
        write_png(GOLDEN_DIR / name, img)
        print("wrote", name, img.shape)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    generate()
