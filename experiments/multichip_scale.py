#!/usr/bin/env python
"""Multi-device row sharding at real scale on the 8-device CPU mesh:
parity vs the single-device frame at 1920x1088 / 4x2048^2 cascades, plus
per-frame collective traffic counted from the compiled HLO (the
communication model, checked without cards).

    python experiments/multichip_scale.py          # SCALE=full|mid|small

The scene is the in-repo multi-mesh GLB (models/sample_scenes.py). On
cards, `python chip_smoke.py --four-cards` runs the sharded frame.
"""

import os
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

# 8 virtual devices time-share one physical core: a full-scale slab takes
# minutes, far beyond the default 20 s/40 s collective rendezvous
# warn/abort (DebugOptions, passed at compile time below).
_TIMEOUTS = {
    "xla_cpu_collective_call_warn_stuck_seconds": int(os.environ.get("WT", 3600)),
    "xla_cpu_collective_call_terminate_timeout_seconds": int(os.environ.get("TT", 7200)),
    "xla_cpu_collective_timeout_seconds": 7200,
}

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "pred": 1, "bf16": 2,
                "f16": 2, "s8": 1, "u8": 1, "f64": 8, "s64": 8}


def collective_bytes(hlo: str):
    """Sum output bytes of every collective in an HLO dump."""
    out = {}
    for m in re.finditer(
            r"= ?\(?([a-z0-9]+)\[([\d,]*)\][^=]*? "
            r"(all-gather|all-reduce|reduce-scatter|collective-permute|"
            r"all-to-all)", hlo):
        dt, shape, kind = m.group(1), m.group(2), m.group(3)
        n = 1
        for d in shape.split(","):
            if d:
                n *= int(d)
        out.setdefault(kind, [0, 0])
        out[kind][0] += 1
        out[kind][1] += n * _DTYPE_BYTES.get(dt, 4)
    return out


def main():
    import tempfile

    from funky_tpu.frame import (GltfConfig, compiled_gltf_frame,
                                 default_gltf_params, init_frame_state)
    from funky_tpu.models.gltf import GltfScene
    from funky_tpu.models.sample_scenes import build_multimesh_glb
    from funky_tpu.models.scene import build_device_scene
    from funky_tpu.ops.raster import RasterConfig
    from funky_tpu.parallel.mesh import make_mesh
    from funky_tpu.parallel.sharded_frame import sharded_gltf_frame

    scale = os.environ.get("SCALE", "full")
    if scale == "mid":
        # Largest scale that clears XLA-CPU's HARDCODED 40 s collective
        # rendezvous abort (8 virtual devices execute serially on this
        # 1-core host, so skew ~= 7x the per-slab front time; the
        # DebugOptions timeouts are not plumbed into rendezvous.cc in
        # this jaxlib). Full-scale collective BYTES still come from the
        # compiled HLO below, which needs no execution.
        w, h, sm = 960, 512, 1024
        tile = RasterConfig(tile_h=16, tile_w=128, backend="jnp")
        stile = RasterConfig(tile_h=128, tile_w=128, backend="jnp")
    elif scale == "full":
        # 1088 rows: 8 slabs of 136 = 17 tiles of 8 (1080 doesn't split
        # into 8 tile-aligned slabs; the demo renders 1088 too)
        w, h, sm = 1920, 1088, 2048
        tile = RasterConfig(tile_h=8, tile_w=128, capacity=1664,
                            backend="jnp")
        stile = RasterConfig(tile_h=128, tile_w=128, capacity=4224,
                             backend="jnp")
    else:
        w, h, sm = 512, 256, 512
        tile = RasterConfig(tile_h=16, tile_w=128, backend="jnp")
        stile = RasterConfig(tile_h=64, tile_w=128, backend="jnp")
    cfg = GltfConfig(width=w, height=h, shadow_map_size=sm,
                     raster=tile, shadow_raster=stile)

    with tempfile.TemporaryDirectory() as td:
        gltf = GltfScene.load(build_multimesh_glb(Path(td) / "multi.glb",
                                                  two_textures=True))
    scene = build_device_scene(gltf)
    params = default_gltf_params(gltf_min_y=float(gltf.bounds_min[1]),
                                 gltf_scale=1.0)

    mesh = make_mesh(8)
    sharded = sharded_gltf_frame(mesh, cfg)

    # --- collective accounting from the compiled HLO ---
    state0 = init_frame_state(cfg)
    compiled = sharded.lower(scene, params, state0).compile(
        compiler_options=_TIMEOUTS)
    stats = collective_bytes(compiled.as_text())
    total = 0
    print(f"# collectives per frame at {w}x{h} / {sm}^2, 8-way rows:")
    for kind, (count, nbytes) in sorted(stats.items()):
        print(f"#   {kind:20s} x{count:3d}  {nbytes / 1e6:9.2f} MB")
        total += nbytes
    print(f"#   TOTAL {total / 1e6:.2f} MB/frame")

    # --- bit-exact parity vs single-device ---
    single = compiled_gltf_frame(cfg)
    st_s, st_m = init_frame_state(cfg), init_frame_state(cfg)
    for i in range(2):
        rgba_s, st_s = single(scene, params, st_s)
        rgba_m, st_m = compiled(scene, params, st_m)
        a, b = np.asarray(rgba_s), np.asarray(rgba_m)
        if np.array_equal(a, b):
            print(f"# frame {i}: BIT-EXACT ({a.shape})")
        else:
            d = np.abs(a - b)
            print(f"# frame {i}: MISMATCH max {d.max()} at "
                  f"{d.mean():.2e} mean, {(d > 0).mean():.4%} px")
    hs, hm = np.asarray(st_s.shadow_history), np.asarray(st_m.shadow_history)
    print("# history bit-exact:", np.array_equal(hs, hm))


if __name__ == "__main__":
    main()
