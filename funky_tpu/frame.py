"""Composed frame functions + jit compile cache.

Each frame is ONE pure jit-compiled function: scene arrays + per-frame
parameters (+ carried temporal state for the glTF path) in, linear RGBA
framebuffer (+ new state) out. This is the array-program replacement for the
reference's command-buffer recording + render passes + queue submit
(main.rs:575-913): pass ordering becomes ordinary data dependencies, and
XLA overlaps/fuses everything it can.

Swapchain recreation (renderer.rs:497-613) maps to "re-jit at the new
static (H, W)" — handled by the per-resolution compile cache.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from . import math3d as m3
from .models.scene import DeviceScene
from .ops.raster import RasterConfig, raster_corners
from .passes import deferred, geometry, shading

CUBE_CLEAR = (0.39, 0.58, 0.93)    # cornflower blue (cube.rs:277)
GLTF_CLEAR = (0.53, 0.81, 0.92)    # sky (gltf_renderer.rs:2252-2255)
NEAR, FAR = 0.1, 100.0             # both pipelines (renderer/gltf_renderer)


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    width: int = 1920
    height: int = 1080
    raster: RasterConfig = dataclasses.field(default_factory=RasterConfig)
    # Static slots for near-plane-crossing triangles (ops/clipping.py);
    # 0 disables clipping (crossing triangles cull whole, round-1 behavior).
    clip_capacity: int = 32

    @property
    def aspect(self) -> float:
        return self.width / self.height


def _main_raster_inputs(scene: DeviceScene, clip: jnp.ndarray,
                        blocks: jnp.ndarray, clip_capacity: int):
    """Near-clip expansion for the main visibility pass (the shadow pass
    is orthographic, w == 1, and never needs it). Returns
    (tri_clip, blocks, tri_flags, valid_mask)."""
    from .ops.clipping import expand_near_clipped

    if clip_capacity <= 0:
        tri_clip = clip[scene.tri_indices]
        valid = jnp.arange(scene.tri_indices.shape[0]) < scene.num_triangles
        return tri_clip, blocks, scene.tri_flags, valid
    g = expand_near_clipped(
        clip[scene.tri_indices], blocks, scene.tri_flags,
        scene.num_triangles, capacity=clip_capacity,
        # Any w_eps <= w(near plane) renders identically to the exact
        # fixed-function clip (see ops/clipping.py); NEAR/10 also keeps
        # clipped-corner projections well-conditioned.
        w_eps=NEAR * 0.1)
    return g.tri_clip, g.blocks, g.tri_flags, g.valid


@dataclasses.dataclass(frozen=True)
class CubeParams:
    """Traced per-frame inputs of the cube demo (cube.rs:166-213)."""
    rotation: jnp.ndarray      # scalar f32, radians
    position: jnp.ndarray      # (3,)
    camera_pos: jnp.ndarray    # (3,)
    yaw: jnp.ndarray           # scalar — cube.rs yaw convention!
    pitch: jnp.ndarray
    fov: jnp.ndarray
    scale: jnp.ndarray


jax.tree_util.register_pytree_node(
    CubeParams,
    lambda p: ((p.rotation, p.position, p.camera_pos, p.yaw, p.pitch,
                p.fov, p.scale), None),
    lambda _, c: CubeParams(*c))


def default_cube_params(rotation: float = 0.0) -> CubeParams:
    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    return CubeParams(
        rotation=f32(rotation),
        position=f32([0.0, 0.0, 0.0]),
        camera_pos=f32([0.0, 0.0, 3.0]),
        # cube.rs:186-190 convention: target = pos +
        #   (sin(yaw)cos(pitch), sin(pitch), cos(yaw)cos(pitch));
        # yaw=pi => looking down -Z at the origin from z=+3.
        yaw=f32(3.14159265),
        pitch=f32(0.0),
        fov=f32(0.7853981634),   # 45 deg
        scale=f32(1.0),
    )


def render_cube_frame(scene: DeviceScene, params: CubeParams,
                      cfg: FrameConfig) -> jnp.ndarray:
    """The rotating-cube demo (BASELINE config 1): linear RGBA out."""
    model = (m3.mat4_from_translation(params.position)
             @ m3.mat4_from_rotation_y(params.rotation)
             @ m3.mat4_from_rotation_x(params.rotation * 0.5)
             @ m3.mat4_from_scale(params.scale))

    front = jnp.stack([
        jnp.sin(params.yaw) * jnp.cos(params.pitch),
        jnp.sin(params.pitch),
        jnp.cos(params.yaw) * jnp.cos(params.pitch),
    ])
    view = m3.look_at_rh(params.camera_pos, params.camera_pos + front,
                         jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    proj = m3.perspective_vk(params.fov, cfg.aspect, NEAR, FAR)
    view_proj = proj @ view

    models = model[None]
    world, clip, normals = geometry.transform_vertices(scene, models, view_proj)
    blocks = geometry.build_shade_blocks(scene, world, clip, normals)
    tri_clip, blocks, tri_flags, tri_valid = _main_raster_inputs(
        scene, clip, blocks, cfg.clip_capacity)

    tri_id, depth, setup = raster_corners(
        tri_clip, tri_valid, cfg.width, cfg.height, cfg.raster)
    gbuf = deferred.interpolate(tri_id, depth, setup.data, blocks,
                                tri_flags)

    light_dir = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)  # cube.rs:202
    background = jnp.asarray(CUBE_CLEAR, jnp.float32)
    return shading.shade_cube(gbuf, params.camera_pos, light_dir, background)


# ---------------------------------------------------------------------------
# glTF scene frame (the flagship path): shadow cascades -> main visibility
# pass -> deferred PCF/PCSS shading -> shadow TAA -> contact shadows.
# ---------------------------------------------------------------------------

from typing import NamedTuple  # noqa: E402

from .passes import contact, shadow, shadow_filter, taa, uniforms  # noqa: E402


@dataclasses.dataclass(frozen=True)
class GltfFrameFlags:
    """Static pipeline switches — the analogue of the reference's shader
    branches on ubo.debugFlags (gltf.frag:509-518, 540, 621). Static =
    each combination compiles once; toggling re-jits (cached), like binding
    a different pipeline."""
    use_pcss: bool = True            # ShadowSettings.use_pcss default
    use_shadow_taa: bool = True
    debug_cascades: bool = False
    enable_shadows: bool = True
    enable_contact_shadows: bool = True
    # Sparse-exact shadow filtering (the array-program analogue of the reference's
    # fragment-shader early-outs, gltf.frag:402-423): conservative
    # LIT/UMBRA classification retires most pixels with zero taps; only
    # penumbra pixels run the exact 16+16-tap evaluation, compacted.
    # Bit-exact vs the dense path while shadow_pen_capacity holds.
    sparse_shadows: bool = True
    # Same treatment for the contact-shadow march: a min-depth pyramid
    # proves most rays miss; only candidate pixels march (passes/contact.py).
    sparse_contact: bool = True
    # Performance mode (not in the reference): evaluate the shadow filter
    # + contact march on a 1/scale-resolution grid and bilinearly upsample
    # (scale in {1, 2, 4}). Designed for a gather-row-bound shadow cost,
    # which drops ~scale^2; edges soften accordingly. half_res_shadows is kept
    # as a bool alias for scale=2. Default = exact reference rates.
    half_res_shadows: bool = False
    shadow_eval_scale: int = 1
    # Dense light-space PCSS/PCF for ground-plane receivers
    # (passes/shadow_lightspace.py): most penumbra pixels lie on the
    # ground, whose receiver depth is affine in shadow uv, so their whole
    # tap core runs densely over a light-space window with ZERO gathers
    # and each pixel fetches one precomputed row. A documented perf
    # DEVIATION (texel-center snap, spatially-constant Vogel rotation,
    # PCF radius ladder) — default off; the exact path is the parity
    # reference. Requires sparse_shadows.
    light_space_ground_shadows: bool = False
    # Skip shadow taps + contact marches for BACK-FACING pixels
    # (n_dot_l <= 0): the shadow term only ever multiplies
    # `0.65 * max(n_dot_l, 0) * shadow` (gltf.frag:611-614 /
    # passes/shading.py), so their shadow value cannot affect this
    # frame's image — the only deviation is the TAA history they carry
    # into future frames (they store "lit" instead of the real moments).
    # Perf mode, default off.
    skip_backfacing_shadows: bool = False
    # Synthesized cascade maps (passes/shadow.synthesize_shadow_maps):
    # analytic ground plane over the full map + a rasterized occluder
    # footprint window — replaces ~12 ms of 4x2048^2 depth raster with
    # dense elementwise math + a tiny window raster. ~1-ulp-class deviation
    # (plane-fit rounding, quad-rim texel rule); an occluder outgrowing
    # its window lax.cond-falls back to the full raster. Perf mode,
    # default off; requires sparse_shadows (shares the footprint
    # windows).
    synth_shadow_maps: bool = False
    # COMMITTED mode: elide every capacity-overflow lax.cond and run the
    # tuned sparse paths unconditionally. Each overflow cond is a
    # scheduling barrier — XLA cannot overlap work across it — and the
    # whole-frame A/Bs measured ~1-3 ms of lost overlap per cond
    # (PERF.md r4 rule 2). With capacities VERIFIED by autotune over the
    # app's poses (autotune_config measures the exact counts these conds
    # compare against), the fallback branch is provably never taken, so
    # the committed frame runs the SAME math on the same values as the
    # cond'd frame. It is NOT bit-exact against it: committed is a
    # different compiled program, and XLA's contextual fp codegen gives
    # the tiny uniform math ulp-level differences that cascade-depth tap
    # compares amplify into isolated penumbra flips of ~0.01 magnitude
    # (the documented cross-program divergence, compute_frame_uniforms;
    # measured r5: 34% of pixels differ by <= 0.009, bisected to the
    # frame-level sites with every pass-level elision forced off —
    # experiments/committed_bisect.py). Per compiled config it is fully
    # deterministic. An unverified view that overflows a capacity
    # produces bounded local artifacts (missing penumbra/contact entries
    # keep their closed-form values) INSTEAD of a dense-fallback frame;
    # FrameDriver's runtime occupancy poll (utils.autotune.
    # capacity_overflows — the same counts) detects it within
    # retune_check_every frames and re-tunes. The synth_ok window-fit
    # cond is elided too (r5): its geometric certificate is polled at
    # runtime via the same machinery (shadow.synth_windows_fit ->
    # capacity_overflows "synth_window_fit" — the ADVICE r4
    # alternative). Perf mode, default off; the cond'd path is the
    # parity reference.
    committed: bool = False

    @property
    def effective_shadow_scale(self) -> int:
        return max(self.shadow_eval_scale, 2 if self.half_res_shadows else 1)


@dataclasses.dataclass(frozen=True)
class GltfConfig:
    """Static glTF frame configuration."""
    width: int = 1920
    height: int = 1080
    shadow_map_size: int = uniforms.SHADOW_MAP_SIZE
    # capacity=None (auto: full triangle count) is the SAFE default —
    # an undersized bin silently drops triangles from that tile (e.g. the
    # whole model vanishing from a shadow cascade). Tighten per scene for
    # scan savings only with verified headroom.
    raster: RasterConfig = dataclasses.field(
        default_factory=lambda: RasterConfig(tile_h=32, tile_w=128))
    # Shadow tiles: 128x256 bins (the GPU kernel splits each into
    # register-sized blocks, ops/raster_pallas.py). Not yet tuned on the
    # H100.
    shadow_raster: RasterConfig = dataclasses.field(
        default_factory=lambda: RasterConfig(tile_h=128, tile_w=256))
    flags: GltfFrameFlags = dataclasses.field(default_factory=GltfFrameFlags)
    # Sparse shadow filtering knobs (flags.sparse_shadows):
    # max penumbra (pixel, cascade) pairs per frame slab — the compaction
    # capacity; None = slab_pixels // 16. Padded slots still pay gather
    # cost, so keep it tight; OVERFLOW IS SAFE (lax.cond falls back to the
    # full dense evaluation — slow frame, exact image). Size from
    # shadow_filter.classify_stats (flagship 1080p measures ~55k pairs).
    shadow_pen_capacity: int | None = None
    # per-cascade pair capacities (4-tuple) — lets each cascade's taps
    # gather from its own small table; None = shadow_pen_capacity each.
    shadow_pen_cascade_caps: tuple | None = None
    # per-cascade RADIUS-ONLY group capacities (r5): pair entries whose
    # own side is LIT-certified need only the 16-tap blocker search
    # (their m1 = m2 = 1 provably; the radius feeds the TAA variance
    # clamp) — ~70% of flagship pairs. Bit-exact; None = no split.
    shadow_lit_cascade_caps: tuple | None = None
    # per-cascade tap-window sizes (4-tuple of texels, 0 = full table):
    # penumbra taps cluster in a small uv region, so each cascade's taps
    # gather from a dynamic-sliced (Wc, Wc, 4) sub-table — under the
    # ~2.5 MB cliff (Wc <= 384) the serial gather runs ~3-4x faster
    # (PERF.md). Bit-identical values; frames whose taps don't fit fall
    # back to the full table per cascade (lax.cond). None = off.
    shadow_tap_windows: tuple | None = None
    # two-level compaction block budgets (8x8 candidate blocks); tune
    # from measured block occupancy (diagnostics) — the candidate-domain
    # size drives the second sort + mask gathers. None = plain
    # single-level compaction (an untuned block budget would only add
    # overhead).
    shadow_pen_block_capacity: int | None = None
    contact_block_capacity: int | None = None
    # Routed window tap groups (r5, passes/shadow_filter.py): entries
    # whose base texel sits inside the pre-planned occluder-footprint
    # window (minus the traced tap-reach margin) gather their 34 tap
    # rows from a dynamic-sliced sub-cliff window — EXACT containment
    # by construction (per-entry value test, no certificate), ~2x the
    # full-table gather rate. This windows cascade 1's duck-side taps,
    # whose overall extent (~1341 texels) no single measured-bbox
    # window can hold. sizes/caps derived by autotune (route only fires
    # for cascades whose plain tap window is unavailable).
    shadow_route_windows: tuple | None = None
    shadow_route_caps: tuple | None = None
    # Committed-mode contact march window (passes/contact.py): stage-3
    # survivors cluster around the occluder, so their probes read a
    # (contact_window)^2 dynamic slice of the packed prev-depth at the
    # sub-cliff gather rate. None = full-table reads (exact default);
    # derived by autotune from the measured probe-bbox extent.
    contact_window: int | None = None
    # TAA misaligned-frame history read compaction: only in-bounds
    # low-motion pixels consume their history row (passes/taa.py), so
    # moving frames gather `taa_need_capacity` rows instead of the full
    # domain. None = dense gather (exact default); size from the
    # diagnostics' `taa_need` (mismatched-state regime). Overflow is
    # SAFE (lax.cond falls back to the dense gather).
    taa_need_capacity: int | None = None
    # classification budget: frames with softness > max_softness fall back
    # to exact taps everywhere (correct, slower). Class-map coarseness in
    # fine texels per cell.
    max_softness: float = 4.0
    # coarse=16 keeps the 2048^2x4 cell table at ~2 MB (sized for a
    # gather that ran faster on small tables; not yet measured on the
    # H100).
    class_coarse: int = 16
    # sparse contact shadows (flags.sparse_contact): stage-2 refine set
    # capacity (None = slab_pixels // 4) and exact-march set capacity
    # (None = stage2 // 4); overflow = exact dense fallback.
    contact_capacity: int | None = None
    contact_march_capacity: int | None = None
    # Static slots for near-plane-crossing triangles in the main pass
    # (ops/clipping.py); 0 disables (crossing triangles cull whole).
    clip_capacity: int = 64
    # Block-sparse texture sampling: max textured 8x8 screen blocks
    # (passes/shading.py). None = auto (a quarter of the screen's blocks);
    # 0 = dense. Overflow falls back to dense sampling (exact).
    texture_block_capacity: int | None = None
    # Unified valid-block back half: ONE 8x8 block compaction of
    # `tri_id >= 0` feeds the ENTIRE per-pixel back half (deferred
    # interpolate -> classify -> shadow taps -> TAA -> contact -> shade)
    # on flat block-major arrays, with a single block scatter of
    # (rgba, history) at the end — every gather AND every elementwise
    # pass shrinks by the sky fraction (~45% in the flagship view).
    # Value = max valid 8x8 blocks; None = auto (3/4 of the screen's
    # blocks); 0 = dense back half. Overflow falls back to the dense
    # back half via lax.cond (exact either way).
    valid_block_capacity: int | None = None
    # Light-space ground-shadow windows
    # (flags.light_space_ground_shadows): per-cascade static window sizes
    # in texels (0 = that cascade keeps exact taps); None = auto 512 each.
    # The window is placed on the scene's shadow-footprint bbox in-frame;
    # ground penumbra pixels falling OUTSIDE a window simply stay on the
    # exact tap path (no cliff). Sized by autotune from the measured
    # footprint extent.
    light_window_sizes: tuple | None = None
    # per-cascade fetch-entry capacities (compaction segments); None =
    # shadow_pen_capacity each. Sized by autotune.
    light_fetch_caps: tuple | None = None
    # PCF radius-ladder rungs for the dense PCSS window (log-spaced over
    # the exact penumbra clamp range [0.5, 2*lightSize]).
    light_pcf_rungs: int = 6
    # Valid-ROW-slab back half: geometry coverage is a contiguous row band
    # [horizon, bottom] in practice, so the whole per-pixel back half can
    # run on a dynamic_slice'd row slab instead of the full frame — the
    # same sky-skipping as the valid-block compaction but with ~1 ms of
    # slicing instead of ~14 ms of sort/gather/scatter relayouts
    # (measured; see PERF.md round 3). Value = static slab height in
    # rows; None = auto (disabled — autotune measures the real span);
    # 0 = disabled. A taller-than-slab valid span falls back to the dense
    # full-height path via lax.cond (exact either way). Takes precedence
    # over valid_block_capacity.
    valid_slab_rows: int | None = None

    @property
    def effective_texture_blocks(self) -> int | None:
        if self.texture_block_capacity == 0:
            return None
        if self.texture_block_capacity is not None:
            return self.texture_block_capacity
        return max((self.height // 8) * (self.width // 8) // 4, 64)

    def effective_valid_blocks(self, h: int, w: int) -> int | None:
        """Valid-block budget for an (h, w) slab; None = blocked back half
        disabled for this shape."""
        if self.valid_block_capacity == 0:
            return None
        if h % 8 != 0 or w % 8 != 0:
            return None
        nb = (h // 8) * (w // 8)
        if self.valid_block_capacity is not None:
            return min(self.valid_block_capacity, nb)
        return min(max(-(-nb * 3 // 4 // 128) * 128, 128), nb)

    def effective_light_windows(self) -> tuple | None:
        """Per-cascade light-space window sizes, or None when the dense
        ground evaluation is off (it rides the sparse classification)."""
        if not ((self.flags.light_space_ground_shadows
                 or self.flags.synth_shadow_maps)
                and self.flags.sparse_shadows):
            return None
        sizes = (self.light_window_sizes if self.light_window_sizes
                 is not None else (512, 512, 512, 512))
        return tuple(min(s, self.shadow_map_size) for s in sizes)

    def effective_slab_rows(self, h: int) -> int | None:
        """Row-slab height for an h-row domain; None = row slab disabled
        (unset, explicit 0, or no saving at this height)."""
        if not self.valid_slab_rows:
            return None
        rows = min(-(-self.valid_slab_rows // 8) * 8, h)
        return rows if rows < h else None

    @property
    def aspect(self) -> float:
        return self.width / self.height


@dataclasses.dataclass(frozen=True)
class GltfParams:
    """Traced per-frame inputs (update_uniform_buffer's arguments,
    gltf_renderer.rs:1784-1797)."""
    camera_pos: jnp.ndarray     # (3,)
    camera_yaw: jnp.ndarray     # scalar
    camera_pitch: jnp.ndarray
    camera_fov: jnp.ndarray
    duck_position: jnp.ndarray  # (3,)
    duck_scale: jnp.ndarray
    shadow_softness: jnp.ndarray


jax.tree_util.register_pytree_node(
    GltfParams,
    lambda p: ((p.camera_pos, p.camera_yaw, p.camera_pitch, p.camera_fov,
                p.duck_position, p.duck_scale, p.shadow_softness), None),
    lambda _, c: GltfParams(*c))


def default_gltf_params(gltf_min_y: float = 0.0,
                        gltf_scale: float = 0.01,
                        shadow_softness: float = 2.5) -> GltfParams:
    """Reference defaults: camera main.rs:119-127, duck placement
    main.rs:695-696, softness main.rs:169."""
    import math

    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    position = jnp.asarray([0.0, 2.5, 10.0], jnp.float32)
    target = jnp.asarray([0.0, 0.6, 0.0], jnp.float32)
    d = target - position
    dn = d / jnp.linalg.norm(d)
    yaw = math.atan2(float(dn[2]), float(dn[0]))
    pitch = math.asin(float(dn[1]))
    duck_y = -gltf_min_y * gltf_scale + 0.001
    return GltfParams(
        camera_pos=position,
        camera_yaw=f32(yaw),
        camera_pitch=f32(pitch),
        camera_fov=f32(math.radians(45.0)),
        duck_position=f32([0.0, duck_y, 0.0]),
        duck_scale=f32(gltf_scale),
        shadow_softness=f32(shadow_softness),
    )


class FrameState(NamedTuple):
    """Carried temporal state — the pure replacement for the reference's
    persistent GPU images (TAA history ping-pong, stale depth binding) and
    prev_view_proj tracking (gltf_renderer.rs:1988-1990)."""
    shadow_history: jnp.ndarray  # (H, W, 2): shadow, ndcDepth
    prev_depth: jnp.ndarray      # (H, W) last frame's depth buffer
    prev_view_proj: jnp.ndarray  # (4, 4)
    has_prev: jnp.ndarray        # () bool
    frame_index: jnp.ndarray     # () int32


def init_frame_state(cfg: GltfConfig) -> FrameState:
    return FrameState(
        shadow_history=taa.init_history(cfg.height, cfg.width),
        prev_depth=jnp.ones((cfg.height, cfg.width), jnp.float32),
        prev_view_proj=jnp.eye(4, dtype=jnp.float32),
        has_prev=jnp.zeros((), bool),
        frame_index=jnp.zeros((), jnp.int32),
    )


def compute_frame_uniforms(params: GltfParams, state: FrameState,
                           cfg: GltfConfig):
    """Computes the per-frame UBO analogue behind an optimization barrier
    (keeps the tiny uniform math from fusing into consumers).

    Determinism note: results are deterministic PER COMPILED CONFIG, but
    not bit-identical ACROSS configs — XLA/LLVM's contextual fp codegen
    compiles this tiny kernel differently depending on the rest of the
    program (measured: light_view_proj differs by ~2e-7 ulps between the
    blocked and dense back halves, which cascade-depth compares amplify
    to ~0.016 penumbra flips at isolated pixels). Cross-path parity tests
    must therefore compare both paths inside ONE jitted program (where
    they agree to ~4e-7); goldens carry a few-ulp tolerance."""
    flags = cfg.flags
    return jax.lax.optimization_barrier(_raw_frame_uniforms(
        params, state, cfg, flags))


def _raw_frame_uniforms(params, state, cfg, flags):
    return uniforms.compute_uniforms(
        camera_pos=params.camera_pos,
        camera_yaw=params.camera_yaw,
        camera_pitch=params.camera_pitch,
        camera_fov=params.camera_fov,
        aspect_ratio=cfg.aspect,
        duck_position=params.duck_position,
        duck_scale=params.duck_scale,
        prev_view_proj=state.prev_view_proj,
        has_prev=state.has_prev,
        frame_index=state.frame_index,
        debug_cascades=flags.debug_cascades,
        use_pcss=flags.use_pcss,
        use_shadow_taa=flags.use_shadow_taa,
        shadow_softness=params.shadow_softness,
        shadow_map_size=cfg.shadow_map_size,
    )


def shade_slab(scene: DeviceScene, uni, state: FrameState,
               shadow_maps, tri_id, depth, setup_data, blocks,
               cfg: GltfConfig, y0=0, class_maps=None, tri_flags=None,
               light_maps=None, tap_routes=None):
    """Per-pixel back half of the frame for a row slab [y0, y0+h):
    deferred attributes -> cascade shadow filtering -> TAA -> contact
    shadows -> final shading (gltf.frag main). Pure; the single-chip frame
    uses one full-height slab, multi-chip shards rows over devices.

    Dispatches to the unified valid-block back half (ONE 8x8 compaction of
    `tri_id >= 0` feeding every pass on flat block-major arrays — sky
    blocks pay nothing) when cfg.valid_block_capacity allows, else the
    dense 2D path. Identical outputs either way (same elementwise ops on
    the same values; overflow lax.cond-falls back to dense).

    class_maps: ShadowClassMaps for the sparse shadow path (None = dense).
    tri_flags: per-triangle flags matching `blocks`' row count (defaults
    to scene.tri_flags; the near-clip expansion passes its extended copy).

    Returns (rgba (h, W, 4), shadow-history slab (h, W, 2)).
    """
    flags = cfg.flags
    if tri_flags is None:
        tri_flags = scene.tri_flags
    h, w = tri_id.shape
    srows = cfg.effective_slab_rows(h)
    # The row-slab back half is scale-independent: the dense slab core
    # subsamples/upsamples internally, and every coordinate it uses is
    # global (frag centers, TAA y0, contact uv) — so shadow_eval_scale > 1
    # routes through it too (round-3 fell back to the full-height dense
    # path and made the perf mode *slower* than exact; VERDICT r3 item 5).
    if srows is not None:
        return _shade_slab_rows(scene, uni, state, shadow_maps, tri_id,
                                depth, setup_data, blocks, cfg, y0,
                                class_maps, tri_flags, srows, light_maps,
                                tap_routes)
    bcap = cfg.effective_valid_blocks(h, w)
    if bcap is not None and flags.effective_shadow_scale == 1:
        return _shade_slab_blocked(scene, uni, state, shadow_maps, tri_id,
                                   depth, setup_data, blocks, cfg, y0,
                                   class_maps, tri_flags, bcap, light_maps,
                                   tap_routes)
    return _shade_slab_dense(scene, uni, state, shadow_maps, tri_id,
                             depth, setup_data, blocks, cfg, y0,
                             class_maps, tri_flags, light_maps, tap_routes)


def _shade_core(scene: DeviceScene, uni, state: FrameState, shadow_maps,
                gbuf, frag, cfg: GltfConfig, class_maps, old_history, y0,
                light_maps=None, tap_routes=None):
    """The per-pixel back half on ANY domain shape (flat block-major for
    the blocked path): shadow filter -> TAA -> contact -> final shading.
    `frag` holds pixel centers (x+0.5 convention) in GLOBAL framebuffer
    coords; `old_history` matches gbuf's shape + (2,). Returns
    (rgba, new_history)."""
    flags = cfg.flags
    normal = gbuf.normal / jnp.maximum(
        jnp.linalg.norm(gbuf.normal, axis=-1, keepdims=True), 1e-12)
    n_dot_l = jnp.maximum(
        jnp.sum(normal * uni.light_dir, axis=-1), 0.0)    # `diff`

    # fragViewDepth = -viewPos.z (gltf.vert:37-38)
    view_z = (gbuf.world @ uni.view[2, :3].T) + uni.view[2, 3]
    view_depth = -view_z

    if flags.enable_shadows:
        if class_maps is not None:
            sres, c0, c1, ct = shadow_filter.cascaded_shadow_sparse(
                uni, shadow_maps, class_maps, gbuf.world, normal, n_dot_l,
                view_depth, frag, flags.use_pcss, gbuf.valid,
                cfg.shadow_pen_capacity, cfg.shadow_pen_cascade_caps,
                cfg.shadow_pen_block_capacity, cfg.shadow_tap_windows,
                light_maps, flags.skip_backfacing_shadows,
                flags.committed, cfg.shadow_lit_cascade_caps,
                tap_routes, cfg.shadow_route_caps)
        else:
            sres, c0, c1, ct = shadow_filter.cascaded_shadow(
                uni, shadow_maps, gbuf.world, normal, n_dot_l, view_depth,
                frag, flags.use_pcss)
    else:
        one = jnp.ones(gbuf.valid.shape, jnp.float32)
        sres = shadow_filter.ShadowResult(one, one, one,
                                          jnp.zeros_like(one))
        c0 = jnp.zeros(gbuf.valid.shape, jnp.int32)
        c1 = c0
        ct = jnp.zeros(gbuf.valid.shape, jnp.float32)

    shadow_term, new_history = taa.apply_shadow_taa(
        sres, gbuf.world, uni, state.shadow_history, flags.use_shadow_taa,
        full_height=cfg.height, frag=frag, full_width=cfg.width,
        need_capacity=cfg.taa_need_capacity, committed=flags.committed)

    # Back-facing pixels can't show a contact shadow either (same
    # max(n_dot_l, 0) gate) — skip their marches in the perf mode.
    cvalid = (gbuf.valid & (n_dot_l > 0.0)
              if flags.skip_backfacing_shadows else gbuf.valid)
    if flags.enable_contact_shadows:
        if flags.sparse_contact:
            contact_term = contact.compute_contact_shadow_sparse(
                gbuf.world, normal, uni, state.prev_depth, y0,
                capacity=cfg.contact_capacity,
                march_capacity=cfg.contact_march_capacity,
                valid=cvalid,
                block_capacity=cfg.contact_block_capacity, frag=frag,
                plane=contact.reference_plane(
                    scene.positions, scene.tri_indices,
                    uni.prev_view_proj, cfg.width, cfg.height),
                committed=flags.committed,
                march_window=cfg.contact_window)
        else:
            contact_term = contact.compute_contact_shadow(
                gbuf.world, normal, uni, state.prev_depth, y0, frag=frag)
        shadow_term = jnp.minimum(shadow_term, contact_term)  # gltf.frag:619

    # History only updates where fragments actually shaded (imageStore
    # under the raster, gltf.frag:588).
    new_history = jnp.where(gbuf.valid[..., None], new_history,
                            old_history)

    background = jnp.asarray(GLTF_CLEAR, jnp.float32)
    if flags.debug_cascades:
        rgba = shading.cascade_debug_color(gbuf, c0, c1, ct, shadow_term,
                                           background)
    else:
        rgba = shading.shade_gltf(gbuf, scene.texture, scene.texture_sizes,
                                  uni.camera_pos, uni.light_dir,
                                  shadow_term, background,
                                  cfg.effective_texture_blocks,
                                  committed=flags.committed)
    return rgba, new_history


def _shade_slab_rows(scene: DeviceScene, uni, state: FrameState,
                     shadow_maps, tri_id, depth, setup_data, blocks,
                     cfg: GltfConfig, y0, class_maps, tri_flags,
                     slab_h: int, light_maps=None, tap_routes=None):
    """Valid-ROW-slab back half: geometry coverage is (in practice) one
    contiguous row band [horizon, bottom], so the whole dense back half
    runs on a dynamic_slice'd (slab_h, W) slab at the first covered row —
    the GPU-analogy is the same as the valid-block path (fragments only
    launch where the raster emitted them, gltf.frag:1-656), but the
    domain shrink costs two slices + two dynamic_update_slices instead of
    a sort + block gather/scatter relayouts (~1 ms vs ~14 ms measured at
    1080p). Rows outside the slab keep the clear color and carried
    history. A valid span taller than slab_h lax.cond-falls back to the
    full-height dense path (exact either way)."""
    h, w = tri_id.shape
    row_any = jnp.any(tri_id >= 0, axis=1)
    any_valid = jnp.any(row_any)
    y_lo = jnp.argmax(row_any).astype(jnp.int32)
    y_hi = (h - jnp.argmax(row_any[::-1])).astype(jnp.int32)
    # Snap the slab start to a multiple of 8 so the shadow_eval_scale > 1
    # subsample grid (slab[::scale]) stays on a stable global-row phase as
    # coverage drifts frame to frame (scale in {1, 2, 4}; 8 covers all).
    # Scale 1 is unaffected: slab position never changes values. For
    # scale > 1 the slab additionally keeps >= 8 rows of margin around the
    # covered band (where possible) so the subsample/upsample of covered
    # rows has full interior support — the jax.image.resize edge clamp
    # then only touches uncovered rows, and the slab output matches the
    # full-height path on every covered row.
    pad = 8 if cfg.flags.effective_shadow_scale > 1 else 0
    y0d = jnp.clip(jnp.where(any_valid, (jnp.maximum(y_lo - pad, 0) // 8)
                             * 8, 0), 0, h - slab_h)
    y_hi_eff = jnp.minimum(y_hi + pad, h)
    fits = jnp.where(any_valid, y_hi_eff - y0d, 0) <= slab_h
    y0_arr = jnp.asarray(y0, jnp.int32)

    def slab(_):
        tri_s = jax.lax.dynamic_slice(tri_id, (y0d, 0), (slab_h, w))
        dep_s = jax.lax.dynamic_slice(depth, (y0d, 0), (slab_h, w))
        rgba_s, hist_s = _shade_slab_dense(
            scene, uni, state, shadow_maps, tri_s, dep_s, setup_data,
            blocks, cfg, y0_arr + y0d, class_maps, tri_flags, light_maps,
            tap_routes)
        background = jnp.asarray(GLTF_CLEAR + (1.0,), jnp.float32)
        rgba = jax.lax.dynamic_update_slice(
            jnp.broadcast_to(background, (h, w, 4)), rgba_s, (y0d, 0, 0))
        old_slab = jax.lax.dynamic_slice(state.shadow_history,
                                         (y0_arr, 0, 0), (h, w, 2))
        hist = jax.lax.dynamic_update_slice(old_slab, hist_s, (y0d, 0, 0))
        return rgba, hist

    def dense(_):
        return _shade_slab_dense(scene, uni, state, shadow_maps, tri_id,
                                 depth, setup_data, blocks, cfg, y0,
                                 class_maps, tri_flags, light_maps,
                                 tap_routes)

    if cfg.flags.committed:
        return slab(None)
    return jax.lax.cond(fits, slab, dense, operand=None)


def _shade_slab_blocked(scene: DeviceScene, uni, state: FrameState,
                        shadow_maps, tri_id, depth, setup_data, blocks,
                        cfg: GltfConfig, y0, class_maps, tri_flags,
                        bcap: int, light_maps=None, tap_routes=None):
    """The unified valid-block back half (the array-program answer to the GPU only
    launching fragments where the raster emitted them, gltf.frag:1-656
    running once per COVERED pixel): compact 8x8 blocks with any coverage,
    run the whole back half on flat (bcap*64,) block-major arrays (every
    gather AND every dense elementwise op skips sky blocks), scatter
    (rgba, history) back in one block write. Block-capacity overflow falls
    back to the dense 2D path (exact, slower)."""
    from .ops.compact import (compact_valid_blocks, gather_blocks,
                              scatter_blocks)

    h, w = tri_id.shape
    bc = compact_valid_blocks(tri_id >= 0, 8, 8, bcap)

    old_slab = jax.lax.dynamic_slice(
        state.shadow_history, (jnp.asarray(y0, jnp.int32), 0, 0),
        (h, w, 2))

    def blocked(_):
        # One block-row gather moves all per-pixel raster outputs +
        # carried history into the compacted domain (the int32 tri ids
        # ride as bitcast f32 lanes — exact for any value).
        payload = jnp.concatenate([
            jax.lax.bitcast_convert_type(tri_id, jnp.float32)[..., None],
            depth[..., None], old_slab], axis=-1)          # (h, w, 4)
        rows = gather_blocks(payload, bc)                  # (bcap*64, 4)
        tri_e = jax.lax.bitcast_convert_type(rows[:, 0], jnp.int32)
        depth_e = rows[:, 1]
        old_hist_e = rows[:, 2:4]
        px, py, slot_valid = bc.pixel_xy()
        tri_e = jnp.where(slot_valid, tri_e, -1)
        pxf = px.astype(jnp.float32) + 0.5
        pyf = py.astype(jnp.float32) + 0.5 + jnp.asarray(y0, jnp.float32)
        frag = jnp.stack([pxf, pyf], axis=-1)

        gbuf = deferred.interpolate_at(tri_e, depth_e, setup_data, blocks,
                                       tri_flags, pxf, pyf)
        rgba_e, hist_e = _shade_core(scene, uni, state, shadow_maps, gbuf,
                                     frag, cfg, class_maps, old_hist_e, y0,
                                     light_maps, tap_routes)

        background = jnp.asarray(GLTF_CLEAR + (1.0,), jnp.float32)
        base = jnp.concatenate([
            jnp.broadcast_to(background, (h, w, 4)), old_slab], axis=-1)
        out = scatter_blocks(base, bc,
                             jnp.concatenate([rgba_e, hist_e], axis=-1))
        return out[..., 0:4], out[..., 4:6]

    def dense(_):
        return _shade_slab_dense(scene, uni, state, shadow_maps, tri_id,
                                 depth, setup_data, blocks, cfg, y0,
                                 class_maps, tri_flags, light_maps,
                                 tap_routes)

    if cfg.flags.committed:
        return blocked(None)
    return jax.lax.cond(bc.fits, blocked, dense, operand=None)


def _shade_slab_dense(scene: DeviceScene, uni, state: FrameState,
                      shadow_maps, tri_id, depth, setup_data, blocks,
                      cfg: GltfConfig, y0=0, class_maps=None,
                      tri_flags=None, light_maps=None, tap_routes=None):
    """Dense 2D back half — the blocked path's overflow fallback, the
    shadow_eval_scale > 1 perf mode, and the bit-parity reference."""
    flags = cfg.flags
    if tri_flags is None:
        tri_flags = scene.tri_flags
    gbuf = deferred.interpolate(tri_id, depth, setup_data, blocks,
                                tri_flags, y0)

    normal = gbuf.normal / jnp.maximum(
        jnp.linalg.norm(gbuf.normal, axis=-1, keepdims=True), 1e-12)
    n_dot_l = jnp.maximum(
        jnp.sum(normal * uni.light_dir, axis=-1), 0.0)    # `diff`

    # fragViewDepth = -viewPos.z (gltf.vert:37-38)
    view_z = (gbuf.world @ uni.view[2, :3].T) + uni.view[2, 3]
    view_depth = -view_z

    h, w = tri_id.shape
    frag = jnp.stack([
        jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5,
                         (h, w)),
        jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
                         + jnp.asarray(y0, jnp.float32), (h, w)),
    ], axis=-1)

    # -- shadow filtering + TAA + contact shadows --
    def _upsample(a):
        return jax.image.resize(a, (h, w) + a.shape[2:], method="linear")

    scale = flags.effective_shadow_scale

    def eval_shadow(world_s, normal_s, ndl_s, vdepth_s, frag_s, valid_s):
        if class_maps is not None:
            return shadow_filter.cascaded_shadow_sparse(
                uni, shadow_maps, class_maps, world_s, normal_s, ndl_s,
                vdepth_s, frag_s, flags.use_pcss, valid_s,
                cfg.shadow_pen_capacity, cfg.shadow_pen_cascade_caps,
                cfg.shadow_pen_block_capacity, cfg.shadow_tap_windows,
                light_maps, flags.skip_backfacing_shadows,
                flags.committed, cfg.shadow_lit_cascade_caps,
                tap_routes, cfg.shadow_route_caps)
        return shadow_filter.cascaded_shadow(
            uni, shadow_maps, world_s, normal_s, ndl_s, vdepth_s, frag_s,
            flags.use_pcss)

    if flags.enable_shadows and scale > 1:
        sub = lambda a: a[::scale, ::scale]  # noqa: E731
        sres_h, _, _, _ = eval_shadow(
            sub(gbuf.world), sub(normal), sub(n_dot_l), sub(view_depth),
            sub(frag), sub(gbuf.valid))
        sres = shadow_filter.ShadowResult(*(
            _upsample(f) for f in sres_h))
        # cascade ids for the debug view are pure dense math: full res
        c0, c1, ct = shadow_filter.select_cascade_blend(
            view_depth, uni.cascade_splits)
    elif flags.enable_shadows:
        sres, c0, c1, ct = eval_shadow(
            gbuf.world, normal, n_dot_l, view_depth, frag, gbuf.valid)
    else:
        one = jnp.ones((h, w), jnp.float32)
        sres = shadow_filter.ShadowResult(one, one, one, jnp.zeros_like(one))
        c0 = jnp.zeros((h, w), jnp.int32)
        c1 = c0
        ct = jnp.zeros((h, w), jnp.float32)

    shadow_term, new_history = taa.apply_shadow_taa(
        sres, gbuf.world, uni, state.shadow_history, flags.use_shadow_taa,
        y0, cfg.height,
        need_capacity=cfg.taa_need_capacity, committed=flags.committed)

    if flags.sparse_contact:
        def contact_fn(world_s, normal_s, uni_s, depth_s, y0_s, valid_s,
                       frag_s=None):
            return contact.compute_contact_shadow_sparse(
                world_s, normal_s, uni_s, depth_s, y0_s,
                capacity=cfg.contact_capacity,
                march_capacity=cfg.contact_march_capacity, valid=valid_s,
                block_capacity=cfg.contact_block_capacity, frag=frag_s,
                plane=contact.reference_plane(
                    scene.positions, scene.tri_indices,
                    uni_s.prev_view_proj, cfg.width, cfg.height),
                committed=flags.committed,
                march_window=cfg.contact_window)
    else:
        def contact_fn(world_s, normal_s, uni_s, depth_s, y0_s, valid_s,
                       frag_s=None):
            return contact.compute_contact_shadow(world_s, normal_s, uni_s,
                                                  depth_s, y0_s, frag=frag_s)
    # Back-facing pixels can't show a contact shadow (max(n_dot_l, 0)
    # gates every shadowed term) — skip their marches in the perf mode.
    cvalid = (gbuf.valid & (n_dot_l > 0.0)
              if flags.skip_backfacing_shadows else gbuf.valid)
    if flags.enable_contact_shadows and scale > 1:
        # Explicit frag: the subsampled grid's pixel centers are the
        # GLOBAL rows y0 + scale*k — generating them from a row offset
        # alone would phase-shift the march jitter.
        ct_half = contact_fn(sub(gbuf.world), sub(normal), uni,
                             state.prev_depth, y0, sub(cvalid),
                             sub(frag))
        shadow_term = jnp.minimum(shadow_term, _upsample(ct_half))
    elif flags.enable_contact_shadows:
        contact_term = contact_fn(gbuf.world, normal, uni,
                                  state.prev_depth, y0, cvalid)
        shadow_term = jnp.minimum(shadow_term, contact_term)  # gltf.frag:619

    # History only updates where fragments actually shaded (imageStore
    # under the raster, gltf.frag:588). The old slab is sliced from the
    # full history at y0.
    old_slab = jax.lax.dynamic_slice(
        state.shadow_history, (jnp.asarray(y0, jnp.int32), 0, 0),
        (h, w, 2))
    new_history = jnp.where(gbuf.valid[..., None], new_history, old_slab)

    # -- final shading --
    background = jnp.asarray(GLTF_CLEAR, jnp.float32)
    if flags.debug_cascades:
        rgba = shading.cascade_debug_color(gbuf, c0, c1, ct, shadow_term,
                                           background)
    else:
        rgba = shading.shade_gltf(gbuf, scene.texture, scene.texture_sizes,
                                  uni.camera_pos, uni.light_dir,
                                  shadow_term, background,
                                  cfg.effective_texture_blocks,
                                  committed=flags.committed)
    return rgba, new_history


def render_gltf_frame(scene: DeviceScene, params: GltfParams,
                      state: FrameState, cfg: GltfConfig):
    """One full frame (render loop of gltf_renderer.rs:1995-2387 as a pure
    function). Returns (linear RGBA (H, W, 4), new FrameState)."""
    flags = cfg.flags
    uni = compute_frame_uniforms(params, state, cfg)

    # -- vertex stage (shared by shadow + main passes) --
    world_v, clip, normals_v = geometry.transform_vertices(
        scene, uni.models, uni.view_proj)
    blocks = geometry.build_shade_blocks(scene, world_v, clip, normals_v)

    # -- shadow cascade depth passes --
    class_maps = None
    light_maps = None
    tap_routes = None
    if flags.enable_shadows:
        from .ops.sampling import quad_pack
        from .passes.shadow_classify import (build_class_maps,
                                             light_ground_planes)

        # Footprint windows shared by the synthesized-map raster and the
        # dense light-space ground evaluation (both perf deviation modes;
        # passes/shadow_lightspace.py): the occluder uv bbox, padded for
        # penumbra reach + classification looseness around silhouettes.
        light_sizes = cfg.effective_light_windows()
        origins = None
        if light_sizes is not None and any(light_sizes):
            from .passes import shadow_lightspace as lsm

            origins, _ = lsm.plan_windows(
                uni, world_v, scene.vert_object, light_sizes,
                cfg.shadow_map_size, cfg.max_softness, cfg.class_coarse)

        def full_raster(_):
            return shadow.render_shadow_maps(
                world_v, scene.tri_indices, scene.num_triangles,
                uni.light_view_proj, cfg.shadow_raster,
                cfg.shadow_map_size)

        if flags.synth_shadow_maps and origins is not None:
            # Analytic ground + windowed occluder raster; an occluder
            # outgrowing its window takes the full raster via lax.cond
            # (the synth math is ~1 ms — cheap enough to compute
            # unconditionally).
            maps_s, synth_ok = shadow.synthesize_shadow_maps(
                scene, world_v, uni, cfg.shadow_map_size, light_sizes,
                origins)
            if flags.committed:
                # Elided synth_ok cond — legitimate as of r5 because the
                # SAME geometric window-fit certificate is now polled at
                # runtime (shadow.synth_windows_fit -> sparse_occupancy
                # "synth_window_overflow" -> capacity_overflows
                # "synth_window_fit" — ADVICE r4's offered alternative):
                # an occluder outgrowing its window costs bounded frames
                # of dropped occluder shadow until the driver re-derives
                # the window sizes, no longer a silent permanent
                # artifact.
                raw_maps = maps_s
            else:
                raw_maps = jax.lax.cond(synth_ok, lambda _: maps_s,
                                        full_raster, operand=None)
        else:
            raw_maps = full_raster(None)
        # Materialize the raw maps once: both the class-map build and the
        # quad-pack consume them, and the barrier keeps the raster from
        # being fused (= recomputed) into each consumer.
        raw_maps = jax.lax.optimization_barrier(raw_maps)
        if flags.sparse_shadows:
            class_maps = build_class_maps(
                raw_maps, cfg.class_coarse, cfg.max_softness,
                light_ground_planes(uni.light_view_proj))
        # quad-pack once (dense shifts) so every filter tap is ONE gather.
        # The barrier forces materialization: without it XLA fuses the
        # packing rolls into every tap's gather (3x slower taps).
        shadow_maps = jax.lax.optimization_barrier(
            jax.vmap(quad_pack)(raw_maps))               # (4, S, S, 4)

        if (flags.light_space_ground_shadows and class_maps is not None
                and origins is not None):
            _, n_off, gbias = lsm.ground_constants(uni)
            planes_b = lsm.biased_ground_planes(uni.light_view_proj,
                                                lsm.GROUND_Y + n_off)
            rows_l = []
            for c in range(4):
                if light_sizes[c]:
                    rows_l.append(lsm.build_light_shadow_map(
                        raw_maps[c], origins[c], planes_b[c], uni,
                        flags.use_pcss, light_sizes[c], cfg.max_softness,
                        gbias, cfg.light_pcf_rungs))
                else:
                    rows_l.append(None)
            light_maps = (tuple(rows_l), tuple(origins),
                          tuple(light_sizes), cfg.light_fetch_caps)

        # Routed window tap groups (shadow_filter route_windows): plan
        # the footprint windows at the route sizes. Exact (containment
        # is a per-entry value test), so no flag gates it — only the
        # derived sizes/caps.
        if (flags.sparse_shadows and cfg.shadow_route_windows is not None
                and any(cfg.shadow_route_windows)
                and cfg.shadow_route_caps is not None):
            from .passes import shadow_lightspace as lsm

            r_origins, _ = lsm.plan_windows(
                uni, world_v, scene.vert_object, cfg.shadow_route_windows,
                cfg.shadow_map_size, cfg.max_softness, cfg.class_coarse)
            tap_routes = (tuple(r_origins),
                          tuple(cfg.shadow_route_windows))
    else:
        shadow_maps = None

    # -- main visibility pass --
    tri_clip, blocks_m, tri_flags_m, tri_valid = _main_raster_inputs(
        scene, clip, blocks, cfg.clip_capacity)
    tri_id, depth, setup = raster_corners(
        tri_clip, tri_valid, cfg.width, cfg.height, cfg.raster)

    rgba, new_history = shade_slab(scene, uni, state, shadow_maps,
                                   tri_id, depth, setup.data, blocks_m, cfg,
                                   class_maps=class_maps,
                                   tri_flags=tri_flags_m,
                                   light_maps=light_maps,
                                   tap_routes=tap_routes)

    new_state = FrameState(
        shadow_history=new_history,
        prev_depth=depth,
        prev_view_proj=uni.view_proj,
        has_prev=jnp.ones((), bool),
        frame_index=state.frame_index + 1,
    )
    return rgba, new_state


# ---------------------------------------------------------------------------
# Compile cache: one jitted frame fn per (static config) — the analogue of
# swapchain-recreation re-jitting at a new resolution.
# ---------------------------------------------------------------------------

_CACHE: Dict[Tuple[Any, ...], Any] = {}


def compiled_cube_frame(cfg: FrameConfig):
    key = ("cube", cfg)
    if key not in _CACHE:
        _CACHE[key] = jax.jit(
            functools.partial(render_cube_frame, cfg=cfg))
    return _CACHE[key]


def compiled_gltf_frame(cfg: GltfConfig):
    """Jitted (scene, params, state) -> (rgba, new_state). Donates the
    carried state so TAA history / prev depth update in place in HBM."""
    key = ("gltf", cfg)
    if key not in _CACHE:
        _CACHE[key] = jax.jit(
            functools.partial(render_gltf_frame, cfg=cfg),
            donate_argnums=(2,))
    return _CACHE[key]
