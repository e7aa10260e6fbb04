#!/usr/bin/env python
"""Render every demo scene to out/*.png (headless).

    python demo.py [--out DIR] [--scale S] [--cpu]

Configs mirror BASELINE.json:
1. rotating cube, 512x512
2+4. a glTF scene through FrameDriver with the full shadow stack, 1080p
   (scaled by --scale); the in-repo multi-mesh GLB
3. multi-mesh PBR scene (synthetic GLB from the test builder)
5. raymarched SDF scene + debug-UI overlay composite
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="out")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="resolution scale (1.0 = full)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--interactive", action="store_true",
                    help="interactive terminal viewer (WASD/arrows camera,"
                         " ESC exit, 3=UI, f=fullscreen, n=minimize,"
                         " TAB=panel focus)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import tempfile

    from funky_tpu.models.sample_scenes import build_multimesh_glb
    from funky_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    scene_dir = tempfile.TemporaryDirectory()
    glb_path = build_multimesh_glb(
        pathlib.Path(scene_dir.name) / "multi.glb", two_textures=True)

    if args.interactive:
        from funky_tpu.app.driver import FrameDriver
        from funky_tpu.app.viewer import TerminalViewer
        from funky_tpu.frame import GltfConfig
        from funky_tpu.ops.raster import RasterConfig

        s = args.scale if args.scale != 1.0 else 0.25
        w = int(1920 * s) // 128 * 128 or 256
        h = int(1088 * s) // 64 * 64 or 128
        tile = RasterConfig(tile_h=16, tile_w=128, capacity=4480)
        cfg = GltfConfig(width=w, height=h, shadow_map_size=512,
                         raster=tile, shadow_raster=tile)
        drv = FrameDriver(cfg, scene_path=glb_path, gltf_scale=1.0,
                          autotune=True)
        print("\x1b[2J", end="")
        TerminalViewer(drv, cols=100).run()
        return

    from funky_tpu.app.driver import FrameDriver
    from funky_tpu.frame import (FrameConfig, GltfConfig,
                                 compiled_cube_frame, default_cube_params)
    from funky_tpu.models.png_io import linear_to_srgb, write_png
    from funky_tpu.models.scene import build_cube_scene
    from funky_tpu.models.sdf import (SdfConfig, compiled_sdf_frame,
                                      default_sdf_camera)
    from funky_tpu.ops.raster import RasterConfig

    out = pathlib.Path(args.out)
    out.mkdir(exist_ok=True)
    s = args.scale

    def save(name, img):
        write_png(out / name, np.asarray(linear_to_srgb(img[..., :3])))
        print("wrote", out / name)

    # 1. rotating cube
    cfg = FrameConfig(width=512, height=512)
    img = compiled_cube_frame(cfg)(build_cube_scene(),
                                   default_cube_params(rotation=0.6))
    save("cube.png", img)

    # 2+4. glTF scene with the full shadow stack (+ UI overlay = 5a)
    w, h = int(1920 * s) // 128 * 128 or 256, int(1088 * s) // 64 * 64 or 128
    cap = 4480
    tile = RasterConfig(tile_h=16, tile_w=128, capacity=cap)
    gcfg = GltfConfig(width=w, height=h, shadow_map_size=2048 if s >= 1
                      else 512, raster=tile, shadow_raster=tile)
    drv = FrameDriver(gcfg, scene_path=glb_path, gltf_scale=1.0,
                      autotune=True)
    for _ in range(3):
        drv.step()
    write_png(out / "gltf_shadows_ui.png", drv.readback())
    print("wrote", out / "gltf_shadows_ui.png")
    drv.toggle_ui()
    write_png(out / "gltf_shadows.png", drv.readback())
    print("wrote", out / "gltf_shadows.png")

    # 3. multi-mesh PBR scene (two PBR cubes + textured ground quad,
    # per-mesh textures — BASELINE config 3)
    from funky_tpu.frame import (compiled_gltf_frame, default_gltf_params,
                                 init_frame_state)
    from funky_tpu.models.gltf import GltfScene
    from funky_tpu.models.scene import build_device_scene

    mscene = GltfScene.load(glb_path)
    ds = build_device_scene(mscene)
    mw = int(1280 * s) // 128 * 128 or 256
    mh = int(768 * s) // 64 * 64 or 128
    mcfg = GltfConfig(width=mw, height=mh,
                      shadow_map_size=1024 if s >= 1 else 256,
                      raster=RasterConfig(tile_h=16, tile_w=128),
                      shadow_raster=RasterConfig(tile_h=128, tile_w=128))
    mparams = default_gltf_params(gltf_min_y=float(mscene.bounds_min[1]),
                                  gltf_scale=1.0)
    mframe = compiled_gltf_frame(mcfg)
    mstate = init_frame_state(mcfg)
    for _ in range(3):
        rgba, mstate = mframe(ds, mparams, mstate)
    save("multimesh_pbr.png", np.asarray(rgba))

    # 5b. SDF raymarch
    scfg = SdfConfig(width=int(960 * s) or 320, height=int(540 * s) or 180)
    pos, yaw, pitch, fov = default_sdf_camera()
    img = compiled_sdf_frame(scfg)(1.2, pos, yaw, pitch, fov)
    save("sdf.png", img)


if __name__ == "__main__":
    main()
