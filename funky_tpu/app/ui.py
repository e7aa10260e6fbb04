"""Debug UI: immediate-mode panel with font atlas + tessellation.

Re-creation of the reference's egui integration (egui_integration.rs):
the same debug window — FPS/frame time, duck-scale log slider, shadow
toggles (debug cascades / PCSS / shadow TAA), softness slider, ECS counts,
device info (egui_integration.rs:97-211) — built from scratch:

- a font atlas committed as font_atlas.png (the analogue of egui's
  init-time font atlas upload, egui_vulkan.rs:204-218; like the
  reference, the atlas is the only texture the backend supports).
- widgets tessellate into (pos, uv, premultiplied-RGBA) triangles, rendered
  by passes/overlay.py into a fixed panel rect, composited with
  ONE/ONE_MINUS_SRC_ALPHA.
- interaction is programmatic: `hit(x, y)` and `set_*` return UiChanges
  that the driver applies back to ECS resources (main.rs:779-790).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..passes.overlay import composite_overlay, rasterize_overlay

# Panel geometry (static: the overlay raster shape)
PANEL_X, PANEL_Y = 10, 10
PANEL_W, PANEL_H = 384, 256
MAX_VERTS = 4096
MAX_TRIS = 2048

_GLYPHS = [chr(c) for c in range(32, 127)]


@dataclasses.dataclass
class UiData:
    """egui_integration.rs:63-80."""
    fps: float = 0.0
    frame_time_ms: float = 0.0
    gltf_scale: float = 0.01
    debug_cascades: bool = False
    shadow_softness: float = 2.5
    use_pcss: bool = True
    use_shadow_taa: bool = True
    entity_count: int = 0
    component_count: int = 0
    gpu_info: str = ""
    last_error: str = ""   # most recent frame failure ("" = healthy)


@dataclasses.dataclass
class UiChanges:
    """egui_integration.rs:83-95."""
    gltf_scale: Optional[float] = None
    debug_cascades: Optional[bool] = None
    shadow_softness: Optional[float] = None
    use_pcss: Optional[bool] = None
    use_shadow_taa: Optional[bool] = None


FONT_ATLAS = Path(__file__).with_name("font_atlas.png")


@functools.lru_cache(maxsize=1)
def build_font_atlas() -> Tuple[np.ndarray, dict, int, int]:
    """The ASCII 32..126 coverage atlas, read from the committed
    font_atlas.png (8x13 glyph cells, rendered once from a bitmap font).

    Returns (atlas (Ah, Aw, 4) f32 with rgb=1 a=coverage, glyph uv map
    {char: (u0, v0, u1, v1)}, glyph_w, glyph_h). Texel (0, 0) region is
    solid white (the egui white-texel convention for untextured shapes).
    """
    from ..models.png_io import _decode_png_pure

    gw, gh = 8, 13   # glyph cell
    pad = 2          # inter-cell padding: stops bilinear bleed
    cw, chh = gw + pad, gh + pad
    cols = 16
    pad_top = 2      # row 0..1 reserved: white texels
    cov = _decode_png_pure(FONT_ATLAS.read_bytes())[..., 0]
    ah, aw = cov.shape
    uvmap = {}
    for i, ch in enumerate(_GLYPHS):
        cx = (i % cols) * cw
        cy = (i // cols) * chh + pad_top
        uvmap[ch] = (cx / aw, cy / ah, (cx + gw) / aw, (cy + gh) / ah)
    atlas = np.ones((ah, aw, 4), np.float32)
    atlas[..., 3] = cov.astype(np.float32) / 255.0
    return atlas, uvmap, gw, gh

WHITE_UV = None  # computed lazily from atlas shape


class Tessellator:
    """Accumulates premultiplied-alpha triangles (panel-relative px)."""

    def __init__(self) -> None:
        self.verts: List[Tuple[float, float]] = []
        self.uvs: List[Tuple[float, float]] = []
        self.colors: List[Tuple[float, float, float, float]] = []
        self.tris: List[Tuple[int, int, int]] = []
        # Widget hit boxes (panel-relative px), filled by build_panel.
        # Instance state so concurrent panels/drivers don't clobber each
        # other's layouts.
        self.checkboxes: dict = {}
        self.sliders: dict = {}
        atlas, self.uvmap, self.gw, self.gh = build_font_atlas()
        self.atlas = atlas
        ah, aw = atlas.shape[:2]
        self.white_uv = (1.0 / aw, 1.0 / ah)

    def rect(self, x, y, w, h, rgba) -> None:
        r, g, b, a = rgba
        col = (r * a, g * a, b * a, a)  # premultiply
        base = len(self.verts)
        u, v = self.white_uv
        for px, py in ((x, y), (x + w, y), (x + w, y + h), (x, y + h)):
            self.verts.append((px, py))
            self.uvs.append((u, v))
            self.colors.append(col)
        self.tris.append((base, base + 1, base + 2))
        self.tris.append((base + 2, base + 3, base))

    def rect_outline(self, x, y, w, h, rgba, t=1.0) -> None:
        self.rect(x, y, w, t, rgba)
        self.rect(x, y + h - t, w, t, rgba)
        self.rect(x, y, t, h, rgba)
        self.rect(x + w - t, y, t, h, rgba)

    def text(self, x, y, s, rgba) -> float:
        r, g, b, a = rgba
        col = (r * a, g * a, b * a, a)
        cx = x
        for ch in s:
            if ch not in self.uvmap:
                ch = "?"
            u0, v0, u1, v1 = self.uvmap[ch]
            base = len(self.verts)
            for px, py, uu, vv in ((cx, y, u0, v0),
                                   (cx + self.gw, y, u1, v0),
                                   (cx + self.gw, y + self.gh, u1, v1),
                                   (cx, y + self.gh, u0, v1)):
                self.verts.append((px, py))
                self.uvs.append((uu, vv))
                self.colors.append(col)
            self.tris.append((base, base + 1, base + 2))
            self.tris.append((base + 2, base + 3, base))
            cx += self.gw
        return cx

    def arrays(self):
        nv, nt = len(self.verts), len(self.tris)
        if nv > MAX_VERTS or nt > MAX_TRIS:
            raise ValueError("UI exceeds tessellation capacity")
        verts = np.zeros((MAX_VERTS, 2), np.float32)
        uvs = np.zeros((MAX_VERTS, 2), np.float32)
        cols = np.zeros((MAX_VERTS, 4), np.float32)
        tris = np.full((MAX_TRIS, 3), -1, np.int32)
        verts[:nv] = self.verts
        uvs[:nv] = self.uvs
        cols[:nv] = self.colors
        tris[:nt] = self.tris
        return verts, uvs, cols, tris, np.int32(nt)


_BG = (0.1, 0.1, 0.12, 0.9)
_TITLE = (0.25, 0.3, 0.5, 1.0)
_TEXT = (0.92, 0.92, 0.92, 1.0)
_ACCENT = (0.4, 0.7, 1.0, 1.0)
_TRACK = (0.3, 0.3, 0.35, 1.0)


def build_panel(data: UiData) -> Tessellator:
    """The debug window layout (egui_integration.rs:97-211)."""
    t = Tessellator()

    t.rect(0, 0, PANEL_W, PANEL_H, _BG)
    t.rect(0, 0, PANEL_W, 18, _TITLE)
    t.text(6, 3, "Debug Panel (F3)", _TEXT)

    y = 24
    t.text(6, y, f"FPS: {data.fps:.1f}", _TEXT)
    t.text(150, y, f"Frame: {data.frame_time_ms:.2f} ms", _TEXT)
    y += 18

    # Duck scale log slider 0.001..0.5 (egui_integration.rs:132-143)
    t.text(6, y, f"Duck scale: {data.gltf_scale:.4f}", _TEXT)
    sy = y + 15
    t.rect(6, sy + 3, 200, 4, _TRACK)
    import math
    lo, hi = math.log(0.001), math.log(0.5)
    frac = (math.log(max(data.gltf_scale, 1e-4)) - lo) / (hi - lo)
    frac = min(max(frac, 0.0), 1.0)
    t.rect(6 + frac * 196, sy, 8, 10, _ACCENT)
    t.sliders["gltf_scale"] = (6, sy, 200, 10, "log", 0.001, 0.5)
    y = sy + 16

    def checkbox(label, value, key, yy):
        t.rect_outline(6, yy, 12, 12, _TEXT)
        if value:
            t.rect(8, yy + 2, 8, 8, _ACCENT)
        t.text(24, yy, label, _TEXT)
        t.checkboxes[key] = (6, yy, 12 + 8 * len(label) + 24, 13)
        return yy + 17

    y = checkbox("Debug cascades", data.debug_cascades, "debug_cascades", y)
    y = checkbox("PCSS (contact hardening)", data.use_pcss, "use_pcss", y)
    y = checkbox("Shadow TAA", data.use_shadow_taa, "use_shadow_taa", y)

    # Softness slider 0.5..8 texels (egui_integration.rs:158-164)
    t.text(6, y, f"Shadow softness: {data.shadow_softness:.2f} texels",
           _TEXT)
    sy = y + 15
    t.rect(6, sy + 3, 200, 4, _TRACK)
    frac = (data.shadow_softness - 0.5) / (8.0 - 0.5)
    frac = min(max(frac, 0.0), 1.0)
    t.rect(6 + frac * 196, sy, 8, 10, _ACCENT)
    t.sliders["shadow_softness"] = (6, sy, 200, 10, "lin", 0.5, 8.0)
    y = sy + 16

    t.text(6, y, f"Entities: {data.entity_count}  "
                 f"Components: {data.component_count}", _TEXT)
    y += 16
    t.text(6, y, data.gpu_info[:44], _TEXT)
    if data.last_error:
        y += 16
        t.text(6, y, ("ERR: " + data.last_error)[:44],
               (1.0, 0.35, 0.3, 1.0))
    return t


class DebugPanel:
    """Owns the atlas + composites the panel over frames."""

    def __init__(self, frame_width: int, frame_height: int) -> None:
        self.frame_width = frame_width
        self.frame_height = frame_height
        atlas, _, _, _ = build_font_atlas()
        self.atlas = jnp.asarray(atlas)
        # Last built layout's hit boxes (instance state; valid after the
        # first render_over — hit() before any build is a documented no-op,
        # matching egui consuming no events before its first frame).
        self._checkboxes: dict = {}
        self._sliders: dict = {}

    def render_over(self, image, data: UiData):
        tess = build_panel(data)
        self._checkboxes = tess.checkboxes
        self._sliders = tess.sliders
        verts, uvs, cols, tris, n = tess.arrays()
        overlay = rasterize_overlay(
            jnp.asarray(verts), jnp.asarray(uvs), jnp.asarray(cols),
            jnp.asarray(tris), jnp.asarray(n), self.atlas,
            (PANEL_H, PANEL_W))
        # scissor the panel to the frame (egui clip rects,
        # egui_vulkan.rs:387-397)
        vis_h = min(PANEL_H, self.frame_height - PANEL_Y)
        vis_w = min(PANEL_W, self.frame_width - PANEL_X)
        if vis_h <= 0 or vis_w <= 0:
            return image
        overlay = overlay[:vis_h, :vis_w]
        return composite_overlay(image, overlay,
                                 jnp.int32(PANEL_X), jnp.int32(PANEL_Y))

    def hit(self, x: float, y: float, data: UiData) -> UiChanges:
        """Click at frame coords -> widget interaction -> UiChanges."""
        lx, ly = x - PANEL_X, y - PANEL_Y
        changes = UiChanges()
        for key, (cx, cy, cw, ch) in self._checkboxes.items():
            if cx <= lx <= cx + cw and cy <= ly <= cy + ch:
                setattr(changes, key, not getattr(data, key))
                return changes
        import math
        for key, (sx, sy, sw, sh, mode, lo, hi) in self._sliders.items():
            if sx <= lx <= sx + sw and sy - 2 <= ly <= sy + sh + 2:
                frac = min(max((lx - sx) / sw, 0.0), 1.0)
                if mode == "log":
                    val = math.exp(math.log(lo)
                                   + frac * (math.log(hi) - math.log(lo)))
                else:
                    val = lo + frac * (hi - lo)
                setattr(changes, key, val)
                return changes
        return changes
