"""Automatic capacity tuning: first-frame diagnostics -> tightened config.

Every sparse-evaluation capacity in GltfConfig (raster bins, penumbra
pairs, contact stages, texture/valid blocks) trades padded-slot gather
cost against an exact-but-slow overflow fallback. The right values are
scene- and view-dependent, so they are MEASURED: render a couple of
frames, read the occupancy diagnostics, and re-derive the config with
headroom. Undersizing is never a correctness risk (every consumer
lax.cond-falls back to its dense path) except raster bin capacity, which
is therefore given a larger margin and verified against the true per-tile
max.

This replaces the hand-tuning ritual that used to live in bench.py: call
`autotune_config(scene, params, cfg)` once at startup (FrameDriver does
it with autotune=True), then re-jit with the returned config.
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp


def _round_up(value: int, quantum: int) -> int:
    return -(-int(value) // quantum) * quantum


def tune_raster_capacities(scene, params, cfg):
    """Per-tile bin occupancy for the main + shadow rasters -> tightened
    RasterConfig capacities (the jnp raster scans the whole capacity in
    every tile, so a loose bound is pure overhead; 1.5x headroom +
    verification against the measured max keeps it safe)."""
    from ..frame import compute_frame_uniforms, init_frame_state
    from ..ops.binning import bin_stats
    from ..passes.geometry import transform_vertices

    @jax.jit
    def occupancy(scene, params, st0):
        uni = compute_frame_uniforms(params, st0, cfg)
        world, clip, _ = transform_vertices(scene, uni.models,
                                            uni.view_proj)
        main = bin_stats(clip, scene.tri_indices, cfg.width, cfg.height,
                         cfg.raster.tile_h, cfg.raster.tile_w,
                         scene.num_triangles)["max"]
        ones = jnp.ones((world.shape[0], 1), jnp.float32)
        world_h = jnp.concatenate([world, ones], axis=-1)
        sm = jnp.zeros((), jnp.int32)
        for c in range(4):
            clip_c = world_h @ uni.light_view_proj[c].T
            sm = jnp.maximum(sm, bin_stats(
                clip_c, scene.tri_indices, cfg.shadow_map_size,
                cfg.shadow_map_size, cfg.shadow_raster.tile_h,
                cfg.shadow_raster.tile_w, scene.num_triangles)["max"])
        return main, sm

    poses = params if isinstance(params, (list, tuple)) else [params]
    st0 = init_frame_state(cfg)
    main_max = sm_max = 0
    for p in poses:
        m, s = map(int, occupancy(scene, p, st0))
        main_max = max(main_max, m)
        sm_max = max(sm_max, s)

    def cap(max_count):
        if max_count <= 0:
            return None  # fall back to always-correct auto sizing
        return min(_round_up(max_count * 1.5, 128),
                   scene.tri_indices.shape[0])

    return dataclasses.replace(
        cfg,
        raster=dataclasses.replace(cfg.raster, capacity=cap(main_max)),
        shadow_raster=dataclasses.replace(cfg.shadow_raster,
                                          capacity=cap(sm_max)))


def tune_sparse_capacities(scene, params, cfg, frames: int = 2):
    """Measured compaction occupancy -> tightened sparse capacities.
    Padded slots pay real gather cost; occupancy drifts only a few %
    frame-to-frame (IGN jitter), and overflow is an exact dense-fallback
    frame, not an error."""
    from .diagnostics import measure_sparse_occupancy

    occ = measure_sparse_occupancy(scene, params, cfg, frames=frames)
    return derive_sparse_config(cfg, occ), occ


def derive_sparse_config(cfg, occ):
    """Occupancy counts -> tightened sparse capacities (shared by the
    startup tune and FrameDriver's runtime re-tune)."""

    def blocks128(count, headroom=1.3):
        return max(_round_up(count * headroom, 128), 128)

    def cap1k(count, headroom=1.3):
        return max(_round_up(count * headroom, 1024), 1024)

    # Row-slab vs valid-block back half: the slab wins whenever the
    # covered rows are one contiguous band (measured span ~= the true
    # cover) — ~1 ms of slicing vs ~14 ms of compaction relayouts. Keep
    # the block path only when the row band is much looser than the
    # block cover (sparse mid-screen geometry).
    # Routed window tap groups (r5) come FIRST: a per-entry containment
    # test against the pre-planned footprint window — EXACT (no fit
    # certificate, conded or committed), sub-cliff gather rate. Adopt a
    # cascade's route when the candidate exists and enough entries
    # would route to beat the group overhead.
    route_counts = occ.get("pairs_route_per_cascade", (0, 0, 0, 0))
    route_sizes_meas = occ.get("route_window_sizes")
    route_w = [0, 0, 0, 0]
    route_c = [0, 0, 0, 0]
    if route_sizes_meas:
        for c in range(4):
            if route_sizes_meas[c] and route_counts[c] >= 4096:
                route_w[c] = route_sizes_meas[c]
                route_c[c] = cap1k(route_counts[c], 1.15)
    route_on = any(route_w)

    # Plain measured-bbox tap windows: committed-mode only (the elided
    # fit certificate makes extent overflow a bounded edge-clamp
    # artifact, polled via tap_extent_per_cascade), and only for
    # cascades WITHOUT an adopted route (the route covers their hot
    # entries exactly; the full-group remainder is small).
    tap_windows = None
    if getattr(cfg.flags, "committed", False) \
            and "tap_extent_per_cascade" in occ:
        import math
        pad_max = math.ceil(4.0 * cfg.max_softness) + 2
        wins = []
        for c in range(4):
            ext = int(occ["tap_extent_per_cascade"][c])
            if ext <= 0 or route_w[c]:
                wins.append(0)
                continue
            need = _round_up(ext + 2 * pad_max + 6, 64)
            wins.append(need if need <= 384
                        and need < cfg.shadow_map_size // 2 else 0)
        tap_windows = tuple(wins) if any(wins) else None

    span_rows = _round_up(min(occ["valid_row_span"] * 1.1 + 8,
                              cfg.height), 8)
    slab_px = span_rows * cfg.width
    block_px = blocks128(occ["valid_blocks"], 1.2) * 64
    use_slab = span_rows < cfg.height and slab_px <= 2 * block_px

    # Light-space ground windows: keep a cascade's window only when
    # enough pairs actually fetch from it (a dropped window's fetch
    # entries return to that cascade's TAP pool — fold them into its tap
    # cap so the measurement stays valid).
    light_sizes = cfg.light_window_sizes
    light_caps = cfg.light_fetch_caps
    extra_taps = (0, 0, 0, 0)
    if "light_window_sizes" in occ:
        fetches = occ.get("light_fetch_per_cascade", (0,) * 4)
        sizes = list(occ["light_window_sizes"])
        extra = [0, 0, 0, 0]
        for c in range(4):
            if sizes[c] and fetches[c] < 128:
                extra[c] = fetches[c]
                sizes[c] = 0
        light_sizes = tuple(sizes)
        extra_taps = tuple(extra)
        light_caps = tuple(cap1k(f, 1.25) if s else 0
                           for f, s in zip(fetches, sizes))

    # Headroom sizing: occupancy drift between autotune and steady state
    # is a few % (IGN jitter; measured across chained frames), and every
    # padded slot costs ~34 real gather rows in the tap core — 1.5x
    # headroom was ~5 ms of pure padding at flagship occupancy. Overflow
    # stays SAFE (exact dense-fallback frame), so keep margins tight and
    # let FrameDriver re-autotune if a view change overflows repeatedly.
    # Radius-only groups (r5): LIT-certified pair sides run the 16-row
    # blocker search instead of the 34-row full core — bit-exact. Only
    # split when enough entries qualify to beat the extra group
    # machinery (measured: a (2154, 1705, 61, 0) split cost ~0.2 fps at
    # the flagship — min-cap padding + 4 more compaction segments
    # outweigh ~4k x 18 saved rows; break-even ~16k total). Without the
    # split, the full groups absorb the lit entries. The split is also
    # disabled when a route candidate was dropped: the measured lit
    # counts exclude route candidates, so they would be undersized.
    lit_counts = occ.get("pairs_lit_per_cascade", (0, 0, 0, 0))
    routes_consistent = all(
        route_w[c] or not route_counts[c] for c in range(4))
    lit_split = sum(lit_counts) >= 16384 and routes_consistent

    return dataclasses.replace(
        cfg,
        shadow_pen_capacity=cap1k(occ["pairs"], 1.25),
        shadow_pen_cascade_caps=tuple(
            cap1k(c + e + (0 if lit_split else l)
                  + (0 if route_w[i] else r), 1.15)
            for i, (c, e, l, r) in enumerate(zip(
                occ["pairs_per_cascade"], extra_taps, lit_counts,
                route_counts))),
        shadow_lit_cascade_caps=(tuple(
            cap1k(c, 1.15) if c else 0 for c in lit_counts)
            if lit_split else None),
        shadow_route_windows=tuple(route_w) if route_on else None,
        shadow_route_caps=tuple(route_c) if route_on else None,
        light_window_sizes=light_sizes,
        light_fetch_caps=light_caps,
        shadow_tap_windows=tap_windows,
        contact_capacity=cap1k(occ["contact_stage2"], 1.15),
        contact_march_capacity=cap1k(occ["contact_march"], 1.15),
        # Committed-mode march window: adopt when the measured stage-3
        # probe bbox fits a sub-cliff slice (<= 384^2 quad ~= 2.4 MB).
        contact_window=(
            _round_up(int(occ["contact_march_extent"] * 1.15) + 16, 64)
            if getattr(cfg.flags, "committed", False)
            and 0 < occ.get("contact_march_extent", 0)
            and _round_up(int(occ["contact_march_extent"] * 1.15) + 16,
                          64) <= 384
            else None),
        # Sparse TAA history read (passes/taa.py): only sized when the
        # measured mismatched-regime need is well below the domain (a
        # near-full cap just adds compaction overhead to the dense
        # gather it replaces). 0 = no moving pose measured -> stay dense.
        taa_need_capacity=(
            cap1k(occ["taa_need"], 1.3)
            if occ.get("taa_need")
            and cap1k(occ["taa_need"], 1.3) <= occ["pixels"] // 2
            else None),
        texture_block_capacity=blocks128(occ["texture_blocks"]),
        shadow_pen_block_capacity=blocks128(occ["pair_blocks"]),
        contact_block_capacity=blocks128(occ["contact_blocks"]),
        valid_slab_rows=span_rows if use_slab else 0,
        valid_block_capacity=(0 if use_slab else
                              blocks128(occ["valid_blocks"], 1.2)))


def capacity_overflows(cfg, occ) -> list:
    """Names of sparse capacities the measured occupancy exceeds — the
    same conditions whose in-frame lax.cond takes the exact-but-dense
    fallback. FrameDriver polls this every few hundred frames and
    re-derives the config when a view change pins frames to the fallback
    (autotune.py's runtime half; see FrameDriver._maybe_retune)."""
    over = []

    def chk(name, count, cap):
        if cap is not None and count > cap:
            over.append(name)

    chk("shadow_pen_capacity", occ["pairs"], cfg.shadow_pen_capacity)
    if cfg.shadow_pen_cascade_caps is not None:
        for c, (n, cap) in enumerate(zip(occ["pairs_per_cascade"],
                                         cfg.shadow_pen_cascade_caps)):
            # With no radius split configured, the frame's full groups
            # absorb the lit-side entries too.
            if cfg.shadow_lit_cascade_caps is None \
                    and "pairs_lit_per_cascade" in occ:
                n = n + occ["pairs_lit_per_cascade"][c]
            chk(f"shadow_pen_cascade_caps[{c}]", n, cap)
    if cfg.shadow_lit_cascade_caps is not None \
            and "pairs_lit_per_cascade" in occ:
        for c, (n, cap) in enumerate(zip(occ["pairs_lit_per_cascade"],
                                         cfg.shadow_lit_cascade_caps)):
            if cap:
                chk(f"shadow_lit_cascade_caps[{c}]", n, cap)
            elif n:
                over.append(f"shadow_lit_cascade_caps[{c}]")
    chk("shadow_pen_block_capacity", occ["pair_blocks"],
        cfg.shadow_pen_block_capacity)
    if cfg.shadow_route_caps is not None \
            and "pairs_route_per_cascade" in occ:
        for c, (n2, cap2) in enumerate(zip(occ["pairs_route_per_cascade"],
                                           cfg.shadow_route_caps)):
            if cap2:
                chk(f"shadow_route_caps[{c}]", n2, cap2)
    # Synthesized-map window fit (committed mode elides the synth_ok
    # cond; the poll carries the same geometric certificate instead —
    # ADVICE r4 alternative).
    if occ.get("synth_window_overflow", 0) > 0:
        over.append("synth_window_fit")
    # Committed-mode tap windows: an extent outgrowing its window means
    # edge-clamped (wrong) taps — poll it like a capacity (r5).
    if (cfg.shadow_tap_windows is not None
            and "tap_extent_per_cascade" in occ):
        import math
        pad_max = math.ceil(4.0 * cfg.max_softness) + 2
        for c, wc in enumerate(cfg.shadow_tap_windows):
            if wc:
                chk(f"shadow_tap_windows[{c}]",
                    occ["tap_extent_per_cascade"][c] + 2 * pad_max + 2, wc)
    if cfg.light_fetch_caps is not None \
            and "light_fetch_per_cascade" in occ:
        sizes = cfg.effective_light_windows() or (0,) * 4
        for c, (n, cap) in enumerate(zip(occ["light_fetch_per_cascade"],
                                         cfg.light_fetch_caps)):
            if sizes[c]:
                chk(f"light_fetch_caps[{c}]", n, cap)
    # Band-classify block budget (static in _pair_classification): a
    # committed-mode band overflow drops blocks into the pair set —
    # surface it so the runtime poll can trigger a retune (ADVICE r4).
    if "band_blocks" in occ and "band_bcap" in occ:
        chk("band_block_capacity", occ["band_blocks"], occ["band_bcap"])
    chk("contact_capacity", occ["contact_stage2"], cfg.contact_capacity)
    chk("contact_march_capacity", occ["contact_march"],
        cfg.contact_march_capacity)
    chk("contact_block_capacity", occ["contact_blocks"],
        cfg.contact_block_capacity)
    if "contact_march_extent" in occ:
        chk("contact_window", occ["contact_march_extent"],
            cfg.contact_window)
    if "taa_need" in occ:
        chk("taa_need_capacity", occ["taa_need"], cfg.taa_need_capacity)
    chk("texture_block_capacity", occ["texture_blocks"],
        cfg.effective_texture_blocks)
    if cfg.valid_slab_rows:
        chk("valid_slab_rows", occ["valid_row_span"], cfg.valid_slab_rows)
    elif cfg.valid_block_capacity:
        chk("valid_block_capacity", occ["valid_blocks"],
            cfg.valid_block_capacity)
    return over


def capacity_slack(cfg, occ) -> list:
    """Names of major sparse capacities sized >= 2x what re-deriving from
    the measured occupancy would give — the tighten direction of the
    driver's runtime retune (a motion phase inflates caps; a parked view
    afterwards pays the padded-slot gather cost forever unless the caps
    shrink back). Compares against the DERIVED cap (headroom + quantum
    included) so a capacity already at its quantum floor is never
    flagged."""
    new = derive_sparse_config(cfg, occ)
    slack = []

    def chk(name, cur, derived):
        if cur is not None and derived is not None and cur >= 2 * derived:
            slack.append(name)

    chk("shadow_pen_capacity", cfg.shadow_pen_capacity,
        new.shadow_pen_capacity)
    if (cfg.shadow_pen_cascade_caps is not None
            and new.shadow_pen_cascade_caps is not None):
        for c, (cur, der) in enumerate(zip(cfg.shadow_pen_cascade_caps,
                                           new.shadow_pen_cascade_caps)):
            chk(f"shadow_pen_cascade_caps[{c}]", cur, der)
    chk("contact_capacity", cfg.contact_capacity, new.contact_capacity)
    chk("contact_march_capacity", cfg.contact_march_capacity,
        new.contact_march_capacity)
    return slack


def autotune_config(scene, params, cfg, frames: int = 2, verbose=False):
    """Full tuning pass: raster bins, then sparse/block capacities
    (measured with the bin-tuned config). A failure raises: a run must
    never pass off the untuned defaults as a tuned config."""
    cfg = tune_raster_capacities(scene, params, cfg)
    if verbose:
        print(f"# autotune: raster capacity {cfg.raster.capacity}, "
              f"shadow {cfg.shadow_raster.capacity}", file=sys.stderr)
    cfg, occ = tune_sparse_capacities(scene, params, cfg, frames=frames)
    if verbose:
        print(f"# autotune: occupancy {occ} -> pen "
              f"{cfg.shadow_pen_capacity}, contact "
              f"{cfg.contact_capacity}/{cfg.contact_march_capacity}, "
              f"slab rows {cfg.valid_slab_rows}, "
              f"valid blocks {cfg.valid_block_capacity}, "
              f"tap windows {cfg.shadow_tap_windows}",
              file=sys.stderr)
    return cfg
