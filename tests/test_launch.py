"""Launch plumbing: compile cache location, matmul precision, and
chip_smoke.py's pieces rehearsed on the CPU at tiny sizes."""

import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from funky_tpu.utils import compile_cache


def _in_fresh_python(code, env):
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(chip_smoke.REPO))
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


CACHE_PROBE = ("import jax; from funky_tpu.utils.compile_cache import "
               "enable_compile_cache as e; p = e(); "
               "print(p, jax.config.jax_compilation_cache_dir)")


def _probe_env(extra):
    import os

    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV_VAR}
    env.update(extra)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_compile_cache_honours_env_var(tmp_path):
    line = _in_fresh_python(CACHE_PROBE, _probe_env(
        {compile_cache.ENV_VAR: str(tmp_path)}))
    assert line.split() == [str(tmp_path), str(tmp_path)]


def test_compile_cache_defaults_inside_checkout():
    line = _in_fresh_python(CACHE_PROBE, _probe_env({}))
    want = str(compile_cache.DEFAULT_DIR)
    assert line.split() == [want, want]
    assert compile_cache.DEFAULT_DIR.parent == chip_smoke.REPO
    ignored = (chip_smoke.REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_import_sets_highest_matmul_precision():
    line = _in_fresh_python(
        "import jax, funky_tpu; "
        "print(jax.config.jax_default_matmul_precision)",
        _probe_env({}))
    assert line == "highest"


def test_chip_smoke_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert "no GPU" in out.err
    assert '"ok"' not in out.out


def test_random_mesh_covers_screen_with_overdraw():
    clip, tris = chip_smoke.random_mesh(4096, 192, 108, overdraw=2.5,
                                        seed=1)
    assert clip.shape == (3 * 4096, 4) and tris.shape == (4096, 3)
    sx = (clip[:, 0] + 1) * 96
    sy = (clip[:, 1] + 1) * 54
    x0, x1, x2 = sx.reshape(-1, 3).T
    y0, y1, y2 = sy.reshape(-1, 3).T
    area = 0.5 * np.abs((x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0))
    assert 2.0 < area.sum() / (192 * 108) < 3.2


def test_explain_diffs_flags_only_edge_pixels():
    # one triangle plane set: b0 = x - 10 (edge at x = 10), b1 = b2 = 1,
    # z = 0.5; a second triangle with z = 0.25 everywhere.
    setup = np.zeros((2, 16), np.float32)
    setup[0, :12] = [1, 0, -10, 0, 0, 1, 0, 0, 1, 0, 0, 0.5]
    setup[1, :12] = [0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0.25]
    a = np.full((1, 20), -1, np.int32)
    b = a.copy()
    b[0, 9] = 0          # pixel center x = 9.5: b0 = -0.5, not an edge
    assert chip_smoke.explain_diffs(a, b, setup) == (1, 1)
    setup[0, 2] = -9.5   # now pixel 9's center sits on the edge
    assert chip_smoke.explain_diffs(a, b, setup) == (1, 0)
    b[0, 3] = 1          # robust cover, robust depth: unexplained
    assert chip_smoke.explain_diffs(a, b, setup) == (2, 1)


@pytest.mark.parametrize("case", [
    ("main tiles", 256, 96, 32, 128, 300),
    ("shadow tiles", 256, 256, 128, 256, 600),
], ids=["main-tiles", "shadow-tiles"])
def test_raster_phase_rehearsal(case):
    """The smoke's raster comparison at a tiny size, kernel interpreted."""
    assert chip_smoke.phase_raster([case], interpret=True, timing=False)
