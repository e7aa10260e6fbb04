#!/usr/bin/env python
"""Smoke run of the renderer on one GPU: every phase on the card.

    python chip_smoke.py [--out DIR]      # one card
    python chip_smoke.py --four-cards     # the row-sharded frame on 4 cards

Phases (one process; any failure makes the exit code non-zero):

- device:   refuse anything but a GPU; print the card's name and power
            limit (nvidia-smi).
- raster:   the Pallas GPU raster kernel against the jnp path, both
            compiled for the card, at 1920x1080 (main tiles) and 2048^2
            (shadow tiles) on seeded ~4k and ~64k triangle meshes; then
            the whole raster_scene timed both ways.
- frame:    the multi-mesh glTF scene through FrameDriver (1080p, 4x2048^2
            cascades, PCSS, shadow TAA, contact shadows, committed mode +
            synthesized maps, autotune), 8 frames with readback and the UI
            composite; then 8 chained compiled_gltf_frame calls on that
            config, on the exact config and on the config with the jnp
            raster; then the cube (512^2) and SDF (960x540) demos.
- gpu-tests: the test suite's `gpu`-marked tests, in this process.
- goldens:  the four goldens that need no external asset, rendered on the
            card and compared with their committed CPU renders.

--four-cards runs only the sharded frame (1920x1024 over a 4-card
`rows` mesh) and the same config on one card.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Timings and memory are printed for information; they are not a benchmark.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Relative tolerance for "an edge function or depth lies within epsilon of
# 0": a fused multiply-add and a separate multiply and add may round
# a*px + b*py + c differently by a few ulps of the largest term.
EDGE_EPS = 1e-6
DEPTH_TOL = 1e-6            # |depth| difference where both pick one id
FRAMES = 8


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Seeded raster workloads and the kernel-vs-jnp comparison
# ---------------------------------------------------------------------------

def random_mesh(n_tris: int, width: int, height: int, overdraw: float = 2.5,
                seed: int = 0):
    """Seeded screen-covering triangle soup: `n_tris` triangles whose
    summed area is ~`overdraw` x the screen. Returns (clip (3T, 4) f32,
    tri_indices (T, 3) int32)."""
    rng = np.random.default_rng(seed)
    area = overdraw * width * height / n_tris
    r = np.sqrt(2.0 * area / (3.0 * np.sqrt(3.0) / 2.0))   # circumradius
    centers = rng.uniform([0.0, 0.0], [width, height], (n_tris, 1, 2))
    ang = (rng.uniform(0, 2 * np.pi, (n_tris, 1))
           + np.array([0.0, 2.1, 4.2]) + rng.uniform(-0.3, 0.3, (n_tris, 3)))
    rad = r * rng.uniform(0.6, 1.4, (n_tris, 3))
    pts = centers + np.stack([np.cos(ang), np.sin(ang)], -1) * rad[..., None]
    pts = pts.reshape(-1, 2)
    z = rng.uniform(0.05, 0.95, len(pts))
    clip = np.stack([pts[:, 0] / width * 2.0 - 1.0,
                     pts[:, 1] / height * 2.0 - 1.0, z,
                     np.ones(len(pts))], -1).astype(np.float32)
    tris = np.arange(len(pts), dtype=np.int32).reshape(n_tris, 3)
    return clip, tris


def tuned_capacity(clip, tris, width, height, tile_h, tile_w):
    """Bin capacity the way utils.autotune sizes it: 1.5x the measured
    per-tile maximum, in quanta of 128, at most the triangle count."""
    import jax
    import jax.numpy as jnp

    from funky_tpu.ops.binning import bin_stats

    mx = int(jax.jit(bin_stats, static_argnums=(2, 3, 4, 5, 6))(
        jnp.asarray(clip), jnp.asarray(tris), width, height, tile_h, tile_w,
        len(tris))["max"])
    return min(-(-int(mx * 1.5) // 128) * 128, len(tris)), mx


def explain_diffs(id_a, id_b, setup, y0=0):
    """Pixels where two rasters pick different triangles, split into those
    explained by rounding (an edge function, the depth or the depth
    difference of the two winners within EDGE_EPS of 0 relative to its
    terms) and the rest. Returns (n_diff, n_unexplained)."""
    ys, xs = np.nonzero(id_a != id_b)
    if len(ys) == 0:
        return 0, 0
    px = xs.astype(np.float64) + 0.5
    py = ys.astype(np.float64) + 0.5 + y0
    setup = np.asarray(setup, np.float64)

    def planes(ids):
        d = setup[np.maximum(ids, 0)]
        vals, mags = [], []
        for k in range(4):
            a, b, c = d[:, 3 * k], d[:, 3 * k + 1], d[:, 3 * k + 2]
            vals.append(a * px + b * py + c)
            mags.append(np.abs(a * px) + np.abs(b * py) + np.abs(c))
        return np.stack(vals), np.stack(mags)   # (4, n): 3 edges + z

    explained = np.zeros(len(ys), bool)
    za = zb = None
    for ids in (id_a[ys, xs], id_b[ys, xs]):
        v, m = planes(ids)
        near = (np.abs(v) <= EDGE_EPS * m).any(0)
        near |= np.abs(v[3] - 1.0) <= EDGE_EPS * m[3]      # z vs clear 1.0
        explained |= (ids >= 0) & near
        z = np.where(ids >= 0, v[3], np.nan)
        mz = m[3]
        if za is None:
            za, ma = z, mz
        else:
            zb, mb = z, mz
    explained |= np.abs(za - zb) <= EDGE_EPS * (ma + mb)
    return len(ys), int((~explained).sum())


def compare_raster(clip, tris, width, height, tile_h, tile_w, capacity,
                   interpret=False, y_offset=0, slice_height=None):
    """Kernel vs jnp raster_scene on one workload. Returns a dict of
    counts; `ok` says whether they agree within the stated tolerances."""
    import jax
    import jax.numpy as jnp

    from funky_tpu.ops.raster import RasterConfig, raster_scene

    out = {}
    for name, backend in (("jnp", "jnp"), ("kernel", "pallas_triton")):
        cfg = RasterConfig(tile_h=tile_h, tile_w=tile_w, capacity=capacity,
                           backend=backend, interpret=interpret)
        fn = jax.jit(functools.partial(
            raster_scene, width=width, height=height,
            num_triangles=len(tris), cfg=cfg, slice_height=slice_height))
        tri_id, depth, setup = fn(jnp.asarray(clip), jnp.asarray(tris),
                                  y_offset=y_offset)
        out[name] = (np.asarray(tri_id), np.asarray(depth),
                     np.asarray(setup.data))
    id_j, z_j, setup = out["jnp"]
    id_k, z_k, _ = out["kernel"]
    n_diff, n_bad = explain_diffs(id_k, id_j, setup, y_offset)
    same = id_k == id_j
    dz = float(np.abs(z_k - z_j)[same].max()) if same.any() else 0.0
    return {"pixels": int(id_j.size), "diff_pixels": n_diff,
            "unexplained": n_bad, "max_depth_diff": dz,
            "covered": int((id_j >= 0).sum()),
            "ok": n_bad == 0 and dz <= DEPTH_TOL}


def time_fn(fn, *args, iters: int = 10) -> float:
    """Median wall time (ms) of fn(*args) to block_until_ready, after a
    warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


RASTER_CASES = (
    # (label, width, height, tile_h, tile_w, triangles)
    ("1080p main tiles, 4k tris", 1920, 1080, 32, 128, 4096),
    ("1080p main tiles, 64k tris", 1920, 1080, 32, 128, 65536),
    ("2048^2 shadow tiles, 4k tris", 2048, 2048, 128, 256, 4096),
    ("2048^2 shadow tiles, 64k tris", 2048, 2048, 128, 256, 65536),
)


def phase_raster(cases=RASTER_CASES, interpret=False, timing=True):
    import jax
    import jax.numpy as jnp

    from funky_tpu.ops.raster import RasterConfig, raster_scene

    ok = True
    for label, w, h, th, tw, n in cases:
        clip, tris = random_mesh(n, w, h, seed=n + w)
        cap, mx = tuned_capacity(clip, tris, w, h, th, tw)
        r = compare_raster(clip, tris, w, h, th, tw, cap, interpret)
        ok &= r["ok"]
        line = (f"raster {label}: {w}x{h} tile {th}x{tw} capacity {cap} "
                f"(bin max {mx}); covered {r['covered']}/{r['pixels']}; "
                f"differing ids {r['diff_pixels']} "
                f"(unexplained {r['unexplained']}, eps {EDGE_EPS}); "
                f"max depth diff {r['max_depth_diff']:.3g} "
                f"(tol {DEPTH_TOL}) -> {'ok' if r['ok'] else 'FAIL'}")
        if timing:
            ms = {}
            for name, backend in (("jnp", "jnp"),
                                  ("kernel", "pallas_triton")):
                cfg = RasterConfig(tile_h=th, tile_w=tw, capacity=cap,
                                   backend=backend, interpret=interpret)
                fn = jax.jit(functools.partial(
                    raster_scene, width=w, height=h, num_triangles=n,
                    cfg=cfg))
                ms[name] = time_fn(fn, jnp.asarray(clip), jnp.asarray(tris))
            line += (f"; raster_scene median ms: jnp {ms['jnp']:.3f}, "
                     f"kernel {ms['kernel']:.3f}")
        log(line)
    return ok


# ---------------------------------------------------------------------------
# Frames through the entry points
# ---------------------------------------------------------------------------

def multimesh_scene_path(out_dir: Path) -> Path:
    from funky_tpu.models.sample_scenes import build_multimesh_glb

    d = out_dir / "scene"
    d.mkdir(parents=True, exist_ok=True)
    return build_multimesh_glb(d / "multimesh.glb", two_textures=True)


def load_scene(path: Path):
    """(DeviceScene, gltf_min_y) of the glTF at `path`; asserts it holds
    more than the ground quad, so a failed load cannot pass for a
    render."""
    from funky_tpu.models.gltf import GltfScene
    from funky_tpu.models.scene import build_device_scene

    gltf = GltfScene.load(path)
    scene = build_device_scene(gltf)
    assert int(scene.num_triangles) > 2, (
        f"scene {path} has {int(scene.num_triangles)} triangles: ground only")
    return scene, float(gltf.bounds_min[1])


def run_chain(fn, scene, params, state, frames=FRAMES):
    """Warm call, then `frames` chained calls; returns (rgba, state,
    ms per frame)."""
    import jax

    rgba, state = fn(scene, params, state)
    jax.block_until_ready(rgba)
    t0 = time.perf_counter()
    for _ in range(frames):
        rgba, state = fn(scene, params, state)
    jax.block_until_ready(rgba)
    return rgba, state, (time.perf_counter() - t0) * 1e3 / frames


def compile_frame(cfg, scene, params, state):
    """Lower + compile the glTF frame; returns (compiled, seconds, memory
    analysis text)."""
    from funky_tpu.frame import compiled_gltf_frame

    t0 = time.perf_counter()
    compiled = compiled_gltf_frame(cfg).lower(scene, params, state).compile()
    secs = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    if mem is None:
        mem_txt = "memory analysis unavailable"
    else:
        mem_txt = ", ".join(
            f"{k} {getattr(mem, k) / 2**20:.1f} MiB"
            for k in ("argument_size_in_bytes", "output_size_in_bytes",
                      "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(mem, k))
    return compiled, secs, mem_txt


def check_image(name, img, shape):
    img = np.asarray(img)
    assert img.shape == shape, f"{name}: shape {img.shape} != {shape}"
    assert np.isfinite(img).all(), f"{name}: non-finite pixels"


def phase_frame(out_dir: Path, width=1920, height=1080, shadow_map_size=2048,
                frames=FRAMES, demos=True, raster_ab=True):
    import jax.numpy as jnp

    from funky_tpu.app.driver import FrameDriver
    from funky_tpu.frame import (GltfConfig, GltfFrameFlags, init_frame_state)
    from funky_tpu.models.png_io import write_png

    path = multimesh_scene_path(out_dir)
    scene, min_y = load_scene(path)
    log(f"frame: scene {path.name}: {int(scene.num_triangles)} triangles")

    cfg = GltfConfig(width=width, height=height,
                     shadow_map_size=shadow_map_size,
                     flags=GltfFrameFlags(committed=True,
                                          synth_shadow_maps=True))
    t0 = time.perf_counter()
    drv = FrameDriver(cfg, scene_path=path, gltf_scale=1.0, autotune=True)
    setup_s = time.perf_counter() - t0
    assert int(drv.device_scene.num_triangles) > 2, "driver loaded ground only"
    t = drv.cfg
    tuned = {"raster": t.raster.capacity,
             "shadow_raster": t.shadow_raster.capacity,
             "shadow_pen": t.shadow_pen_capacity,
             "contact": t.contact_capacity,
             "contact_march": t.contact_march_capacity}
    log(f"frame: FrameDriver set-up incl. autotune {setup_s:.1f} s; "
        f"tuned capacities {tuned}")
    assert all(v is not None for v in tuned.values()), (
        f"autotune left defaults: {tuned}")

    t0 = time.perf_counter()
    drv.step()
    drv.readback()               # compiles the tuned frame + UI composite
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(frames):
        drv.step()
        img = drv.readback()
    drive_ms = (time.perf_counter() - t0) * 1e3 / frames
    assert drv.consecutive_failures == 0, drv.last_error
    assert drv.last_error == "", drv.last_error
    check_image("FrameDriver readback", img, (height, width, 3))
    write_png(out_dir / "frame_driver_ui.png", img)
    log(f"frame: FrameDriver first step + readback (compile) "
        f"{first_s:.1f} s; then {frames} x (step + readback with UI): "
        f"{drive_ms:.2f} ms/frame; 0 failures; wrote frame_driver_ui.png")

    params = drv._params()
    exact = dataclasses.replace(t, flags=dataclasses.replace(
        t.flags, committed=False, synth_shadow_maps=False))
    configs = [("committed+synth", t), ("exact", exact)]
    if raster_ab:
        jnp_raster = dataclasses.replace(
            t, raster=dataclasses.replace(t.raster, backend="jnp"),
            shadow_raster=dataclasses.replace(t.shadow_raster,
                                              backend="jnp"))
        configs.append(("committed+synth, jnp raster", jnp_raster))
    for name, c in configs:
        state = init_frame_state(c)
        compiled, secs, mem = compile_frame(c, drv.device_scene, params,
                                            state)
        rgba, state, ms = run_chain(compiled, drv.device_scene, params,
                                    state, frames)
        check_image(f"frame {name}", rgba, (height, width, 4))
        assert int(state.frame_index) == frames + 1
        log(f"frame {name}: compile (0 if the driver compiled it) "
            f"{secs:.1f} s; {mem}; "
            f"{frames} chained frames {ms:.3f} ms/frame")

    if demos:
        from funky_tpu.frame import (FrameConfig, compiled_cube_frame,
                                     default_cube_params)
        from funky_tpu.models.png_io import linear_to_srgb
        from funky_tpu.models.scene import build_cube_scene
        from funky_tpu.models.sdf import (SdfConfig, compiled_sdf_frame,
                                          default_sdf_camera)

        ccfg = FrameConfig(width=512, height=512)
        cube = compiled_cube_frame(ccfg)(build_cube_scene(),
                                         default_cube_params(0.6))
        check_image("cube", cube, (512, 512, 4))
        assert (np.asarray(cube[..., :3]).std(axis=(0, 1)) > 0).any()
        write_png(out_dir / "cube.png", np.asarray(linear_to_srgb(
            cube[..., :3])))
        scfg = SdfConfig(width=960, height=540)
        pos, yaw, pitch, fov = default_sdf_camera()
        sdf = compiled_sdf_frame(scfg)(jnp.float32(1.2), pos, yaw, pitch,
                                       fov)
        check_image("sdf", sdf, (540, 960, 4))
        write_png(out_dir / "sdf.png", np.asarray(linear_to_srgb(
            sdf[..., :3])))
        log("frame: cube 512x512 and SDF 960x540 finite; wrote cube.png, "
            "sdf.png")
    return True


# ---------------------------------------------------------------------------
# Goldens, gpu-marked tests, four cards
# ---------------------------------------------------------------------------

GPU_GOLDENS = ("cube_r06_128.png", "sdf_t1_160x96.png",
               "multimesh_pbr_256x144.png", "jpeg_quad_192x112.png")


def phase_goldens(names=GPU_GOLDENS):
    from funky_tpu.models.png_io import linear_to_srgb, read_png
    from tests import golden_utils as G

    ok = True
    for name in names:
        want = read_png(G.GOLDEN_DIR / name)[..., :3].astype(np.float32) / 255
        got = np.asarray(linear_to_srgb(G.GOLDENS[name]()))
        bad, worst = G.golden_mismatch(got, want)
        good = got.shape == want.shape and bad <= G.MAX_BAD_FRAC
        ok &= good
        log(f"golden {name}: {bad:.4%} of pixels off by > {G.TOL:.4f} "
            f"(max {worst:.4f}; limit {G.MAX_BAD_FRAC:.2%}; f32, matmul "
            f"precision highest) -> {'ok' if good else 'FAIL'}")
    return ok


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-o", "addopts=", "-p", "no:cacheprovider",
                      "-m", "gpu", str(REPO / "tests" / "test_raster_gpu.py")])
    log(f"gpu-marked tests: pytest exit code {int(rc)}")
    return int(rc) == 0


def phase_four_cards(out_dir: Path, n=4, width=1920, height=1024,
                     shadow_map_size=2048, frames=2):
    """Row-sharded frame over an n-card 'rows' mesh against the same
    config on one card (two different programs: compared under the
    goldens' tolerance, not bit for bit)."""
    import jax

    from funky_tpu.frame import (GltfConfig, compiled_gltf_frame,
                                 default_gltf_params, init_frame_state)
    from funky_tpu.models.png_io import linear_to_srgb
    from funky_tpu.parallel import make_mesh, sharded_gltf_frame
    from tests import golden_utils as G

    assert len(jax.devices()) >= n, f"need {n} devices: {jax.devices()}"
    scene, min_y = load_scene(multimesh_scene_path(out_dir))
    cfg = GltfConfig(width=width, height=height,
                     shadow_map_size=shadow_map_size)
    params = default_gltf_params(gltf_min_y=min_y, gltf_scale=1.0)
    out = {}
    for name, fn in (("sharded", sharded_gltf_frame(make_mesh(n), cfg)),
                     ("one card", compiled_gltf_frame(cfg))):
        state = init_frame_state(cfg)
        t0 = time.perf_counter()
        rgba, state = fn(scene, params, state)
        jax.block_until_ready(rgba)
        first_s = time.perf_counter() - t0
        rgba, state, ms = run_chain(fn, scene, params, state, frames)
        check_image(name, rgba, (height, width, 4))
        out[name] = np.asarray(linear_to_srgb(rgba[..., :3]))
        log(f"four-cards {name}: first frame (compile) {first_s:.1f} s; "
            f"{frames} chained frames {ms:.3f} ms/frame")
    bad, worst = G.golden_mismatch(out["sharded"], out["one card"])
    ok = bad <= G.MAX_BAD_FRAC
    log(f"four-cards: {width}x{height} over {n} cards vs one card: "
        f"{bad:.4%} of pixels off by > {G.TOL:.4f} (max {worst:.4f}; "
        f"limit {G.MAX_BAD_FRAC:.2%}) -> {'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------

def card_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "smoke"),
                    help="directory for the PNGs and the generated scene")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded frame on 4 cards")
    ap.add_argument("--phases", default="raster,frame,gpu-tests,goldens",
                    help="comma-separated subset of the one-card phases")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {devices}", file=sys.stderr)
        return 2
    log(f"device: {len(devices)} x {dev.device_kind} ({dev.platform}), "
        f"jax {jax.__version__}")
    info = card_info()
    log(f"nvidia-smi name, power.limit: {info}")

    sys.path.insert(0, str(REPO))
    from funky_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.four_cards:
        phases = {"four-cards": lambda: phase_four_cards(out_dir)}
    else:
        phases = {"raster": phase_raster,
                  "frame": lambda: phase_frame(out_dir),
                  "gpu-tests": phase_gpu_tests,
                  "goldens": phase_goldens}
        wanted = args.phases.split(",")
        unknown = set(wanted) - set(phases)
        if unknown:
            ap.error(f"unknown phases {sorted(unknown)}")
        phases = {k: v for k, v in phases.items() if k in wanted}

    failed = []
    for name, fn in phases.items():
        t0 = time.perf_counter()
        try:
            ok = fn()
        except Exception:
            traceback.print_exc()
            ok = False
        log(f"phase {name}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not ok:
            failed.append(name)
    log(info)                    # the card's name and power limit
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
