#!/usr/bin/env python
"""Tune the GPU raster kernel's launch parameters on the card.

    python experiments/raster_tune.py              # on a GPU
    python experiments/raster_tune.py --interpret  # tiny CPU rehearsal

For each of chip_smoke.RASTER_CASES (seeded ~4k / ~64k triangle meshes at
1080p main tiles and 2048^2 shadow tiles, autotune-sized bin capacity),
times the kernel alone (setup and bins precomputed) for every block size
x warps x pipeline-stages combination, checks each against the jnp raster, and
prints the jnp raster's time beside it. One JSON line per case goes to
chiprun_out/raster_tune.jsonl.
"""

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--interpret", action="store_true",
                    help="tiny sizes, kernel in the Pallas interpreter")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke
    from funky_tpu.ops import raster_pallas as rp
    from funky_tpu.ops.binning import (bin_triangles, gather_bin_data,
                                       triangle_setup)
    from funky_tpu.ops.raster import RasterConfig, rasterize
    from funky_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.interpret:
        cases = [("tiny main", 256, 64, 32, 128, 200)]
        grid = list(itertools.product([1024, 2048], [4], [1]))
        iters = 1
    else:
        if jax.default_backend() != "gpu":
            sys.exit("no GPU; use --interpret for a CPU rehearsal")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        cases = chip_smoke.RASTER_CASES
        grid = list(itertools.product([1024, 2048, 4096], [4, 8], [1, 2]))
        iters = 10

    out_path = REPO / "chiprun_out" / "raster_tune.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    with out_path.open("w") as log:
        for label, w, h, th, tw, n in cases:
            clip, tris = chip_smoke.random_mesh(n, w, h, seed=n + w)
            cap, mx = chip_smoke.tuned_capacity(clip, tris, w, h, th, tw)
            setup = jax.jit(triangle_setup, static_argnums=(2, 3, 4))(
                jnp.asarray(clip), jnp.asarray(tris), w, h, n)
            bins, counts = jax.jit(bin_triangles, static_argnums=(
                1, 2, 3, 4, 5))(setup, w, h, th, tw, cap)
            jcfg = RasterConfig(tile_h=th, tile_w=tw, capacity=cap,
                                backend="jnp")

            def jnp_raster(setup, bins, counts):
                return rasterize(gather_bin_data(setup, bins), bins, counts,
                                 w, h, jcfg)

            jfn = jax.jit(jnp_raster)
            id_j = np.asarray(jfn(setup, bins, counts)[0])
            jms = chip_smoke.time_fn(jfn, setup, bins, counts, iters=iters)
            kcfg = RasterConfig(tile_h=th, tile_w=tw, capacity=cap,
                                backend="pallas_triton",
                                interpret=args.interpret)
            rows = []
            for bp, nw, ns in grid:
                fn = jax.jit(lambda d, b, c, bp=bp, nw=nw, ns=ns:
                             rp.rasterize_pallas(d, b, c, w, h, kcfg,
                                                 block_pixels=bp,
                                                 num_warps=nw,
                                                 num_stages=ns))
                try:
                    id_k = np.asarray(fn(setup.data, bins, counts)[0])
                    nd, bad = chip_smoke.explain_diffs(
                        id_k, id_j, np.asarray(setup.data))
                    ms = chip_smoke.time_fn(fn, setup.data, bins, counts,
                                            iters=iters)
                    rows.append({"block_pixels": bp, "num_warps": nw,
                                 "num_stages": ns, "ms": ms, "diff": nd,
                                 "unexplained": bad})
                except Exception as e:  # report and go on with the sweep
                    rows.append({"block_pixels": bp, "num_warps": nw,
                                 "num_stages": ns, "error": str(e)[:300]})
            best = min((r for r in rows if "ms" in r),
                       key=lambda r: r["ms"], default=None)
            rec = {"case": label, "capacity": cap, "bin_max": mx,
                   "jnp_ms": jms, "best": best, "sweep": rows}
            log.write(json.dumps(rec) + "\n")
            print(f"{label}: cap {cap} (max {mx}); jnp raster {jms:.3f} ms; "
                  f"best kernel {best}", flush=True)
            for r in rows:
                print("   ", r, flush=True)


if __name__ == "__main__":
    main()
