"""Numeric sanitizers — the array-program analogue of Vulkan validation
layers (README.md:292-295 names them as the reference's debugging tool;
SURVEY.md §5 plans checkify/NaN guards for this framework).

JAX frames are pure, so the two failure classes a GPU validation layer
catches (races, bad descriptors) cannot exist; what CAN go wrong
numerically is NaN/Inf creep (bad assets, divide-by-zero in new pass
code). Two tools:

- `checked(fn)`: jax.experimental.checkify wrapper with float checks —
  every div/sqrt/etc inside the frame is instrumented; errors carry the
  originating source line. Heavy (disables some fusion) — debug only.
- `assert_finite(tree)`: cheap post-hoc scan of a frame's outputs —
  cheap enough for a debug driver mode (one extra reduce per buffer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def checked(fn):
    """Wrap a jittable frame fn with checkify float/NaN instrumentation.

    Returns wrapped(*args) -> result; raises ValueError (with the
    failing op's source location) if any instrumented op produced
    NaN/Inf. Usage:
        frame = sanitize.checked(functools.partial(render_gltf_frame,
                                                   cfg=cfg))
        rgba, state = frame(scene, params, state)
    """
    from jax.experimental import checkify

    cfn = checkify.checkify(fn, errors=checkify.float_checks)

    def wrapped(*args, **kwargs):
        err, out = jax.jit(cfn)(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapped


def assert_finite(tree, label: str = "frame output") -> None:
    """Host-side finiteness check over a pytree of arrays (blocks)."""
    bad = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if not jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating):
            continue
        n = int(jnp.sum(~jnp.isfinite(leaf)))
        if n:
            bad.append(f"{jax.tree_util.keystr(path)}: {n} non-finite")
    if bad:
        raise FloatingPointError(f"{label}: " + "; ".join(bad))
