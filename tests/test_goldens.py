"""Golden-image regression: renders must match the committed PNGs.

Regenerate with `python tests/golden_utils.py` after INTENTIONAL visual
changes (and eyeball the diff before committing). Only the Duck goldens
need the external Duck asset; the rest render from in-repo scenes.
"""

import numpy as np
import pytest

from funky_tpu.models.png_io import linear_to_srgb, read_png

from . import golden_utils as G

TOL = G.TOL
MAX_BAD_FRAC = G.MAX_BAD_FRAC


@pytest.mark.parametrize("name", sorted(G.GOLDENS))
def test_golden(name, request):
    if name.startswith("duck"):
        request.getfixturevalue("duck_gltf_path")
    path = G.GOLDEN_DIR / name
    if not path.exists():
        pytest.skip(f"golden {name} not generated")
    want = read_png(path)[..., :3].astype(np.float32) / 255.0
    got = np.asarray(linear_to_srgb(G.GOLDENS[name]()))
    assert got.shape == want.shape
    bad, worst = G.golden_mismatch(got, want)
    assert bad <= MAX_BAD_FRAC, (
        f"{name}: {bad:.4%} pixels differ > {TOL:.4f} "
        f"(max diff {worst:.4f})")
