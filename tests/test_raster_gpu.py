"""The GPU raster kernel compiled for the card (marker `gpu`).

These tests need a GPU: the `gpu_backend` fixture decides at run time
and skips them elsewhere. chip_smoke.py runs them on the card
(`pytest -m gpu`); the same comparisons run on the CPU in Pallas
interpret mode in test_raster_pallas.py.
"""

import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_backend():
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (backend is {jax.default_backend()!r})")
    return jax.devices()[0]


@pytest.mark.parametrize("tile,n_tris", [((32, 128), 512),
                                         ((128, 256), 2048)],
                         ids=["main-tiles", "shadow-tiles"])
def test_compiled_kernel_matches_jnp(gpu_backend, tile, n_tris):
    th, tw = tile
    clip, tris = chip_smoke.random_mesh(n_tris, 384, 256, seed=7)
    cap, _ = chip_smoke.tuned_capacity(clip, tris, 384, 256, th, tw)
    r = chip_smoke.compare_raster(clip, tris, 384, 256, th, tw, cap)
    assert r["ok"], r


def test_compiled_kernel_row_slab(gpu_backend):
    clip, tris = chip_smoke.random_mesh(1024, 256, 256, seed=3)
    r = chip_smoke.compare_raster(clip, tris, 256, 256, 32, 128, 1024,
                                  y_offset=64, slice_height=128)
    assert r["ok"], r
    assert r["pixels"] == 128 * 256


def test_auto_backend_is_the_kernel_on_gpu(gpu_backend):
    from funky_tpu.ops.raster import RasterConfig, _backend

    assert _backend(RasterConfig()) == "pallas_triton"
