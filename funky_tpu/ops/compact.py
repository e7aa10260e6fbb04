"""Sparse compaction: evaluate an expensive per-element function on only
the elements that need it.

Rationale: designed for a machine where every per-pixel data-dependent
fetch costs a serial-loop gather row, so a pass
that only a few % of pixels need (penumbra shadow taps, contact-shadow
marches) should run on a compacted list of those pixels, not the full
framebuffer. Masking alone saves nothing: gather cost is data-independent.

This is the array-program stand-in for the GPU's divergence handling (early
`return`s in gltf.frag, e.g. the lit/out-of-bounds early-outs at
gltf.frag:402-423) — a fragment shader retires cheap pixels for free; we
compact instead.

Pipeline:   mask -> compact_indices (one argsort; ~4 ms for 2M keys)
         -> gather payload rows for the selected elements
         -> evaluate on the (capacity,)-shaped batch
         -> scatter_back into the dense result.

Capacity is STATIC (jit shapes): `count` may exceed it, in which case the
overflow elements keep the caller's dense fallback values. Callers pick
capacity from measured occupancy (see `CompactDiagnostics` in callers'
stats) exactly like RasterConfig.capacity, and the padded entries still pay
gather cost — capacity is the knob that sets the pass's cost.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .sampling import take_rows


class Compacted(NamedTuple):
    idx: jnp.ndarray     # (capacity,) int32 flat indices into the mask,
    #                      -1 for padding slots
    slot_valid: jnp.ndarray  # (capacity,) bool
    count: jnp.ndarray   # () int32 — TRUE number of masked elements
    #                      (may exceed capacity; compare to detect overflow)


def compact_indices(mask: jnp.ndarray, capacity: int,
                    group_key: jnp.ndarray | None = None) -> Compacted:
    """Indices of True elements of `mask` (flattened), first-N by raster
    order (or grouped by `group_key` then raster order), padded to
    `capacity` with -1.

    Args:
      mask: bool array, any shape.
      capacity: static output length.
      group_key: optional int32 array (same shape) — selected elements are
        ordered by key first (e.g. cascade layer, for gather locality),
        raster order within a key.
    """
    flat = mask.ravel()
    n = flat.shape[0]
    capacity = min(capacity, n)
    count = jnp.sum(flat, dtype=jnp.int32)
    if group_key is None:
        # Stable argsort of (not mask): True (0) sorts first, stable keeps
        # raster order.
        order = jnp.argsort(~flat, stable=True)
    else:
        # Stable argsort on the key alone keeps raster order within a key
        # with no composite-key range limit — EXCEPT the padding key
        # itself: a selected element whose key is INT32_MAX would
        # interleave with padding and silently select wrong elements, so
        # that case forces `count` past any capacity and every caller's
        # overflow lax.cond takes its exact dense fallback instead
        # (tests/test_sparse_shadow.py::test_group_key_collision_overflows).
        pad_key = jnp.int32(jnp.iinfo(jnp.int32).max)
        gk = group_key.ravel()
        key = jnp.where(flat, gk, pad_key)
        order = jnp.argsort(key, stable=True)
        count = jnp.where(jnp.any(flat & (gk == pad_key)), pad_key, count)
    order = order[:capacity].astype(jnp.int32)
    slot_valid = jnp.arange(capacity, dtype=jnp.int32) < jnp.minimum(
        count, capacity)
    return Compacted(idx=jnp.where(slot_valid, order, -1),
                     slot_valid=slot_valid, count=count)


def compact_blocks(mask: jnp.ndarray, bh: int, bw: int,
                   capacity_blocks: int) -> Compacted:
    """Whole-block compaction of a 2D mask: every (bh, bw) block with ANY
    True pixel expands to all its pixel indices. The argsort runs over
    the tiny block grid instead of the pixel grid (a 2M-pixel mask costs
    a ~4 ms sort; its 32k-block grid costs ~0.1 ms) — the right tool
    when the masked pixels cluster spatially (e.g. textured model
    pixels). Returns a pixel-level Compacted whose `count` is the TRUE
    BLOCK count (compare against capacity_blocks for overflow)."""
    h, w = mask.shape
    assert h % bh == 0 and w % bw == 0
    gh, gw = h // bh, w // bw
    bm = mask.reshape(gh, bh, gw, bw).any(axis=(1, 3))
    comp_b = compact_indices(bm, capacity_blocks)
    safe = jnp.maximum(comp_b.idx, 0)
    by = safe // gw
    bx = safe % gw
    py = by[:, None, None] * bh + jnp.arange(bh, dtype=jnp.int32)[None, :,
                                                                  None]
    px = bx[:, None, None] * bw + jnp.arange(bw, dtype=jnp.int32)[None,
                                                                  None, :]
    idx = (py * w + px).reshape(-1)
    slot_valid = jnp.repeat(comp_b.slot_valid, bh * bw)
    return Compacted(idx=jnp.where(slot_valid, idx, -1),
                     slot_valid=slot_valid, count=comp_b.count)


class BlockedCompacted(NamedTuple):
    comp: Compacted          # element-level result (original flat domain)
    block_count: jnp.ndarray  # () int32 TRUE candidate-block count —
    #                           include `block_count <= block_capacity`
    #                           in the caller's overflow check


def compact_indices_blocked(mask: jnp.ndarray, capacity: int,
                            bh: int, bw: int, block_capacity: int,
                            group_key: jnp.ndarray | None = None
                            ) -> BlockedCompacted:
    """Two-level compaction for spatially-clustered masks: argsort the
    (bh, bw)-block-any grid first (e.g. 65k keys instead of 4M — the
    full-domain sort is the expensive part), then compact elements
    within the candidate blocks only. Selects the SAME element set as
    compact_indices (order differs: block-major instead of raster — fine
    for independent-entry evaluation); `count` is still the true element
    count. Blocks beyond block_capacity are DROPPED — callers must treat
    `block_count > block_capacity` as overflow."""
    *lead, h, w = mask.shape
    assert h % bh == 0 and w % bw == 0
    gh, gw = h // bh, w // bw
    bm = mask.reshape(*lead, gh, bh, gw, bw).any(axis=(-3, -1))
    comp_b = compact_indices(bm, block_capacity)

    safe = jnp.maximum(comp_b.idx, 0)
    li = safe // (gh * gw)
    bi = safe % (gh * gw)
    by = bi // gw
    bx = bi % gw
    base = (li * h + by * bh) * w + bx * bw
    within = (jnp.arange(bh, dtype=jnp.int32)[:, None] * w
              + jnp.arange(bw, dtype=jnp.int32)[None, :])
    cand = (base[:, None, None] + within[None]).reshape(-1)
    cand_valid = jnp.repeat(comp_b.slot_valid, bh * bw)
    cand_safe = jnp.maximum(cand, 0)

    flat = mask.ravel()
    m = take_rows(flat, cand_safe) & cand_valid
    n_cand = cand.shape[0]
    capacity = min(capacity, n_cand)
    count = jnp.sum(flat, dtype=jnp.int32)
    if group_key is None:
        order = jnp.argsort(~m, stable=True)
    else:
        # INT32_MAX group keys collide with the padding key — force the
        # callers' overflow fallback (see compact_indices).
        pad_key = jnp.int32(jnp.iinfo(jnp.int32).max)
        gk = group_key.ravel()[cand_safe]
        key = jnp.where(m, gk, pad_key)
        order = jnp.argsort(key, stable=True)
        count = jnp.where(jnp.any(m & (gk == pad_key)), pad_key, count)
    order = order[:capacity]
    slot_valid = jnp.arange(capacity, dtype=jnp.int32) < jnp.minimum(
        count, capacity)
    comp = Compacted(idx=jnp.where(slot_valid, cand[order], -1),
                     slot_valid=slot_valid, count=count)
    return BlockedCompacted(comp=comp, block_count=comp_b.count)


class BlockCompaction(NamedTuple):
    """Block-level compaction of a 2D domain into contiguous block-major
    runs: the payload moves at BLOCK granularity (one gathered row per
    8x8 block instead of per pixel — ~64x fewer gather-loop iterations;
    the block-major relayout itself is a dense HBM stream). The flat
    compacted domain has shape (capacity_blocks * bh * bw,) with each
    block's bh*bw pixels contiguous."""
    comp_b: Compacted        # block-level indices into the (gh*gw) grid
    gh: int
    gw: int
    bh: int
    bw: int

    @property
    def block_len(self) -> int:
        return self.bh * self.bw

    @property
    def capacity_blocks(self) -> int:
        return self.comp_b.idx.shape[0]

    @property
    def fits(self) -> jnp.ndarray:
        return self.comp_b.count <= self.capacity_blocks

    def pixel_xy(self):
        """Per-slot pixel coords (x, y) in the source 2D domain, plus the
        slot-valid mask — all shaped (capacity_blocks * bh * bw,)."""
        safe = jnp.maximum(self.comp_b.idx, 0)
        by = safe // self.gw
        bx = safe % self.gw
        j = jnp.arange(self.block_len, dtype=jnp.int32)
        px = (bx[:, None] * self.bw + j[None] % self.bw).reshape(-1)
        py = (by[:, None] * self.bh + j[None] // self.bw).reshape(-1)
        valid = jnp.repeat(self.comp_b.slot_valid, self.block_len)
        return px, py, valid


def compact_valid_blocks(mask: jnp.ndarray, bh: int, bw: int,
                         capacity_blocks: int) -> BlockCompaction:
    """Block-level compaction: every (bh, bw) block of the 2D `mask` with
    ANY True pixel gets a slot (block-raster order). `comp_b.count` is the
    TRUE block count; `fits` is False on overflow."""
    h, w = mask.shape
    assert h % bh == 0 and w % bw == 0
    gh, gw = h // bh, w // bw
    bm = mask.reshape(gh, bh, gw, bw).any(axis=(1, 3))
    comp_b = compact_indices(bm, capacity_blocks)
    return BlockCompaction(comp_b=comp_b, gh=gh, gw=gw, bh=bh, bw=bw)


def _to_block_rows(a: jnp.ndarray, bc: BlockCompaction) -> jnp.ndarray:
    """(h, w, ...) -> (gh*gw, bh*bw*C) block-major row table."""
    cc = int(np.prod(a.shape[2:])) if a.ndim > 2 else 1
    t = a.reshape(bc.gh, bc.bh, bc.gw, bc.bw, cc)
    return t.transpose(0, 2, 1, 3, 4).reshape(bc.gh * bc.gw,
                                              bc.block_len * cc)


def gather_blocks(a: jnp.ndarray, bc: BlockCompaction) -> jnp.ndarray:
    """Gather the compacted blocks of a (h, w, ...) array as a flat
    block-major (capacity_blocks * bh * bw, ...) array: ONE gathered row
    per block."""
    rows = take_rows(_to_block_rows(a, bc), jnp.maximum(bc.comp_b.idx, 0))
    out = rows.reshape((bc.capacity_blocks * bc.block_len,) + a.shape[2:])
    return out


def scatter_blocks(base: jnp.ndarray, bc: BlockCompaction,
                   values: jnp.ndarray) -> jnp.ndarray:
    """Scatter flat block-major `values` (capacity_blocks * bh * bw, ...)
    into the dense (h, w, ...) `base` at the compacted blocks (one row per
    block; padding slots dropped)."""
    t = _to_block_rows(base, bc)
    vals = values.reshape(bc.capacity_blocks, -1)
    nb = bc.gh * bc.gw
    idx = jnp.where(bc.comp_b.slot_valid, bc.comp_b.idx, nb)
    t = t.at[idx].set(vals, mode="drop")
    cc = int(np.prod(base.shape[2:])) if base.ndim > 2 else 1
    out = t.reshape(bc.gh, bc.gw, bc.bh, bc.bw, cc).transpose(0, 2, 1, 3, 4)
    return out.reshape(base.shape)


def compact_flat_blocks(mask: jnp.ndarray, block: int,
                        capacity_blocks: int) -> Compacted:
    """1D analogue of compact_blocks for block-major flat domains: every
    contiguous `block`-element run of `mask` with ANY True element expands
    to all its element indices. `count` is the TRUE block count."""
    n = mask.shape[0]
    assert n % block == 0
    bm = mask.reshape(n // block, block).any(axis=1)
    comp_b = compact_indices(bm, capacity_blocks)
    safe = jnp.maximum(comp_b.idx, 0)
    idx = (safe[:, None] * block
           + jnp.arange(block, dtype=jnp.int32)[None]).reshape(-1)
    slot_valid = jnp.repeat(comp_b.slot_valid, block)
    return Compacted(idx=jnp.where(slot_valid, idx, -1),
                     slot_valid=slot_valid, count=comp_b.count)


def compact_blocks_any(mask: jnp.ndarray,
                       capacity_blocks: int) -> Compacted | None:
    """Whole-block compaction on either domain layout: 2D masks use 8x8
    spatial blocks, flat block-major masks (the blocked back half's
    compacted domain) use contiguous 64-runs. None when the shape has no
    block structure (callers fall back to dense/plain compaction)."""
    if (mask.ndim == 2 and mask.shape[0] % 8 == 0
            and mask.shape[1] % 8 == 0):
        return compact_blocks(mask, 8, 8, capacity_blocks)
    if mask.ndim == 1 and mask.shape[0] % 64 == 0:
        return compact_flat_blocks(mask, 64, capacity_blocks)
    return None


def gather_rows(table: jnp.ndarray, comp: Compacted) -> jnp.ndarray:
    """Gather payload rows (flat-first-dim `table`) for compacted elements;
    padding slots fetch row 0 (callers mask with comp.slot_valid)."""
    safe = jnp.maximum(comp.idx, 0)
    return take_rows(table, safe)


def scatter_back(dense: jnp.ndarray, comp: Compacted,
                 values: jnp.ndarray) -> jnp.ndarray:
    """Write per-slot `values` (capacity, ...) into flat-first-dim `dense`
    at the compacted indices; padding slots are dropped. Returns updated
    dense array (same shape as input)."""
    flat = dense.reshape((-1,) + values.shape[1:])
    # Padding idx = -1 -> redirect to an out-of-range row and drop.
    n = flat.shape[0]
    idx = jnp.where(comp.slot_valid, comp.idx, n)
    out = flat.at[idx].set(values, mode="drop")
    return out.reshape(dense.shape)
