#!/usr/bin/env python
"""Benchmark: the flagship glTF + 4-cascade-shadow frame at 1080p.

    python bench.py          # on the GPU; BENCH_FRAMES / BENCH_REPEATS

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "fps", "vs_baseline": N,
   "median_of": R, "min": ..., "max": ...}

`value` is the MEDIAN of R independent timing runs (each a chained batch
of frames). Scene: models/scene.gltf (the Duck) when present, else the
in-repo multi-mesh GLB (models/sample_scenes.py); the metric names it.

Baseline: the reference claims 60+ FPS for the glTF scene with GPU sync on
its laptop GPU (README.md:12; BASELINE.md) — vs_baseline = fps / 60.

Timing protocol: frames are CHAINED through the carried temporal state and
drained with a value fetch at the end of each run.
"""

import json
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

DUCK_PATH = Path(__file__).resolve().parent / "models" / "scene.gltf"


def orbit_params(params, i: int):
    """Pose i of the bench's motion trajectory: camera orbiting the duck
    (0.02 rad/frame) while the duck slides — the steady-state moving
    frame the reference's interactive numbers represent. Shared with the
    experiments (ablate_stack) so ladders measure the SHIPPED config."""
    import dataclasses
    import math

    import jax.numpy as jnp

    a = 0.02 * i
    target = np.asarray([0.0, 0.6, 0.0], np.float32)
    rel = np.asarray([0.0, 2.5, 10.0], np.float32) - target
    rot = np.asarray([[math.cos(a), 0, math.sin(a)],
                      [0, 1, 0],
                      [-math.sin(a), 0, math.cos(a)]], np.float32)
    pos = target + rot @ rel
    d = target - pos
    dn = d / np.linalg.norm(d)
    return dataclasses.replace(
        params,
        camera_pos=jnp.asarray(pos),
        camera_yaw=jnp.float32(math.atan2(float(dn[2]), float(dn[0]))),
        camera_pitch=jnp.float32(math.asin(float(dn[1]))),
        duck_position=params.duck_position
        + jnp.asarray([0.3 * math.sin(3 * a), 0.0,
                       0.3 * math.cos(3 * a) - 0.3], jnp.float32))


def bench_poses(params, n):
    """The pose set bench.py autotunes over (parked + 3 orbit poses)."""
    return [params, orbit_params(params, n // 3),
            orbit_params(params, 2 * n // 3), orbit_params(params, n - 1)]


def find_scene():
    """(GltfScene, name, world scale): the Duck if present, else the
    in-repo multi-mesh GLB. Never a ground-only scene."""
    import tempfile

    from funky_tpu.models.gltf import GltfScene
    from funky_tpu.models.sample_scenes import build_multimesh_glb

    if DUCK_PATH.exists():
        return GltfScene.load(DUCK_PATH), "glTF Duck", 0.01
    with tempfile.TemporaryDirectory() as td:
        glb = build_multimesh_glb(Path(td) / "multimesh.glb",
                                  two_textures=True)
        return GltfScene.load(glb), "multi-mesh glTF", 1.0


def timed_runs(frame_fn, make_state, scene, params, n_frames, repeats):
    """Median-of-N chained-and-drained timing: each run chains `n_frames`
    through the carried state and fetches once. Returns list of FPS."""
    state = make_state()
    rgba, state = frame_fn(scene, params, state)   # warm / compile
    float(np.asarray(rgba.ravel()[0]))
    fps = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n_frames):
            rgba, state = frame_fn(scene, params, state)
        float(np.asarray(rgba.ravel()[0]))
        fps.append(n_frames / (time.perf_counter() - t0))
    return fps


def main():
    import dataclasses

    from funky_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from funky_tpu.frame import (GltfConfig, GltfFrameFlags,
                                 compiled_gltf_frame, default_gltf_params,
                                 init_frame_state)
    from funky_tpu.models.scene import build_device_scene
    from funky_tpu.utils.autotune import autotune_config

    gltf, scene_name, gltf_scale = find_scene()
    scene = build_device_scene(gltf)
    n_tris = int(scene.num_triangles)
    assert n_tris > 2, f"{scene_name}: {n_tris} triangles (ground only)"
    gltf_min_y = float(gltf.bounds_min[1])

    # 1920x1080, 4x2048^2 cascades, PCSS+TAA+contact, COMMITTED mode —
    # the same math as the exact path with every verified overflow cond
    # elided (frame.GltfFrameFlags.committed: each cond is an XLA
    # scheduling barrier; capacities are verified by the autotune below
    # over exactly these poses) — PLUS synthesized cascade maps (the
    # documented ~1-ulp-class deviation, passes/shadow.py), with the
    # synth_ok window-fit certificate polled at runtime instead of a
    # cond. The other deviation modes (light-space ground PCSS, back-face
    # skip) stay off. Synthesized maps also carry the multi-device path,
    # where they delete the cascade all-gather
    # (parallel/sharded_frame.py).
    cfg = GltfConfig(flags=GltfFrameFlags(committed=True,
                                          synth_shadow_maps=True))
    params = default_gltf_params(gltf_min_y=gltf_min_y,
                                 gltf_scale=gltf_scale)

    n = int(os.environ.get("BENCH_FRAMES", "24"))
    r = int(os.environ.get("BENCH_REPEATS", "3"))

    # Measured-occupancy capacity tuning (utils/autotune.py — the same
    # path FrameDriver/entry() use). Tuned over the parked view AND
    # orbit poses, so the motion metric below runs with capacities a
    # real app would settle on for this trajectory (single-pose tuning
    # pins moving frames to the exact-but-dense overflow fallback).
    poses = bench_poses(params, n)
    cfg = autotune_config(scene, poses, cfg, verbose=True)

    frame = compiled_gltf_frame(cfg)
    fps = timed_runs(frame, lambda: init_frame_state(cfg), scene, params,
                     n, r)

    # --- motion metric: orbiting camera + sliding duck (the steady-state
    # frame the reference's interactive numbers represent: TAA takes its
    # slow reprojection path, slab spans and capacities drift, window
    # origins move). Same autotuned config — overflowing a capacity costs
    # honest dense-fallback frames here.
    motion_med = None
    try:
        all_motion = [orbit_params(params, i) for i in range(n)]
        state = init_frame_state(cfg)
        rgba, state = frame(scene, all_motion[0], state)
        float(np.asarray(rgba.ravel()[0]))
        mfps = []
        for _ in range(r):
            t0 = time.perf_counter()
            for p in all_motion:
                rgba, state = frame(scene, p, state)
            float(np.asarray(rgba.ravel()[0]))
            mfps.append(n / (time.perf_counter() - t0))
        motion_med = statistics.median(mfps)
        print(f"# motion (orbit+slide): median {motion_med:.2f} fps "
              f"(min {min(mfps):.2f} max {max(mfps):.2f})",
              file=sys.stderr)
    except Exception as e:
        print(f"# motion metric failed: {e}", file=sys.stderr)

    # Print the PRIMARY line before the slow secondary metrics: a
    # driver-side timeout mid-secondaries must not lose the headline.
    med = statistics.median(fps)
    out = {
        "metric": f"{scene_name} ({n_tris} triangles) + 4-cascade PCSS "
                  "shadows + TAA + contact shadows, 1920x1080",
        "value": round(med, 3),
        "unit": "fps",
        "vs_baseline": round(med / 60.0, 4),
        "median_of": r,
        "min": round(min(fps), 3),
        "max": round(max(fps), 3),
    }
    if motion_med is not None:
        out["motion_fps"] = round(motion_med, 3)
    print(json.dumps(out), flush=True)

    # Secondary metrics (stderr; the driver consumes only the stdout line).
    try:
        import dataclasses

        from funky_tpu.frame import (FrameConfig, GltfFrameFlags,
                                     compiled_cube_frame,
                                     default_cube_params)
        from funky_tpu.models.scene import build_cube_scene

        # half-res gets its OWN autotune: sparse capacities are what the
        # gather passes actually pay (padded slots gather too), so reusing
        # full-res caps would throw the 4x domain shrink away.
        half = dataclasses.replace(
            cfg, flags=dataclasses.replace(cfg.flags,
                                           half_res_shadows=True),
            shadow_pen_capacity=None, shadow_pen_cascade_caps=None,
            light_fetch_caps=None, contact_capacity=None,
            contact_march_capacity=None)
        half = autotune_config(scene, poses, half)
        fps_half = timed_runs(compiled_gltf_frame(half),
                              lambda: init_frame_state(half), scene,
                              params, n, 1)[0]
        print(f"# half-res shadows: {fps_half:.2f} fps", file=sys.stderr)

        import jax
        import jax.numpy as jnp

        from funky_tpu.models.sdf import (SdfConfig, default_sdf_camera,
                                          render_sdf_frame)

        scfg = SdfConfig(width=960, height=540)
        pos, yaw, pitch, fov = default_sdf_camera()

        # Chained inside ONE jit: each frame's time depends on the
        # previous frame's output, so the final fetch proves all 20
        # executed.
        @jax.jit
        def sdf_chain(t0v):
            def body(carry, i):
                img = render_sdf_frame(carry + i * 0.02, pos, yaw, pitch,
                                       fov, scfg)
                return carry + (img[0, 0, 0] * 1e-30).astype(jnp.float32), \
                    None
            out, _ = jax.lax.scan(body, t0v,
                                  jnp.arange(20, dtype=jnp.float32))
            return out

        d = sdf_chain(jnp.float32(1.0))
        float(np.asarray(d))
        sdf_fps = []
        for _ in range(r):
            t0 = time.perf_counter()
            d = sdf_chain(jnp.float32(1.0))
            float(np.asarray(d))
            sdf_fps.append(20 / (time.perf_counter() - t0))
        print(f"# sdf 960x540: median {statistics.median(sdf_fps):.1f} fps "
              f"(min {min(sdf_fps):.1f} max {max(sdf_fps):.1f})",
              file=sys.stderr)

        ccfg = FrameConfig(width=512, height=512)
        cscene = build_cube_scene()
        cframe = compiled_cube_frame(ccfg)
        # pre-build params so host-side eager transfers stay off the clock
        all_params = [default_cube_params(i * 0.02) for i in range(30)]
        img = cframe(cscene, all_params[0])
        float(np.asarray(img.ravel()[0]))
        cube_fps = []
        for _ in range(r):
            t0 = time.perf_counter()
            for p in all_params:
                img = cframe(cscene, p)
            float(np.asarray(img.ravel()[0]))
            cube_fps.append(30 / (time.perf_counter() - t0))
        print(f"# cube 512x512: median {statistics.median(cube_fps):.1f} "
              f"fps (min {min(cube_fps):.1f} max {max(cube_fps):.1f}; "
              f"reference headline: 144+)", file=sys.stderr)
    except Exception as e:  # secondary metrics must never break the bench
        print(f"# secondary metrics failed: {e}", file=sys.stderr)

if __name__ == "__main__":
    main()
