"""Tracing / profiling utilities.

The reference's observability is FPS in the window title + egui panel
(main.rs:203-215, egui_integration.rs:115-123) and ROADMAP's per-pass
budget table. Here:

- FpsCounter: 500 ms-window FPS/frame-time (port of
  update_performance_stats, main.rs:203-215).
- PassTimer: wall timings via block_until_ready deltas (per-pass budget
  table equivalent).
- trace(): context manager around jax.profiler for device traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List

import jax


@dataclasses.dataclass
class FpsCounter:
    window_s: float = 0.5          # 500 ms window (main.rs:212)
    fps: float = 0.0
    frame_time_ms: float = 0.0
    _count: int = 0
    _last: float | None = None

    def tick(self) -> None:
        self._count += 1
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return
        elapsed = now - self._last
        if elapsed >= self.window_s:
            self.fps = self._count / elapsed
            self.frame_time_ms = 1000.0 / self.fps if self.fps else 0.0
            self._count = 0
            self._last = now


class PassTimer:
    """Measure named passes with device sync, keeping running stats."""

    def __init__(self) -> None:
        self.timings: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            jax.block_until_ready(result)
        self.timings.setdefault(name, []).append(time.perf_counter() - t0)

    def time_fn(self, name: str, fn: Callable, *args, iters: int = 1):
        out = jax.block_until_ready(fn(*args))  # warm/compile
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        self.timings.setdefault(name, []).append(
            (time.perf_counter() - t0) / iters)
        return out

    def summary(self) -> Dict[str, float]:
        return {k: min(v) for k, v in self.timings.items()}

    def report(self) -> str:
        lines = [f"{k:30s} {min(v)*1000:8.3f} ms (best of {len(v)})"
                 for k, v in sorted(self.timings.items())]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """jax.profiler trace around a block (view with tensorboard/xprof);
    log_dir defaults to funky_tpu_trace/ under the temp directory."""
    if log_dir is None:
        import tempfile

        log_dir = f"{tempfile.gettempdir()}/funky_tpu_trace"
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_info() -> str:
    """GPU-info equivalent for the debug panel (egui_integration.rs:188-207
    shows GPU name + Vulkan version)."""
    d = jax.devices()[0]
    return f"{d.device_kind} ({d.platform}), jax {jax.__version__}"
