"""Search-window math and argmax with cv::minMaxLoc-compatible tie-breaking.

Implements component C5 of the reference (SURVEY.md §2a): the clamped local
search window around the current bbox center, argmax inside it, and the
global-argmax fallback when the window collapses
(tracker_ghc/src/main.cpp:193-218, 421-446).

Two evaluation styles exist:
  * full-map style (reference parity): mask a window of a full NCC map.
  * fused style (the fast path): the NCC is only ever computed on a
    fixed-size (2R+1)^2 candidate region sliced around the bbox; a mask keeps
    the argmax identical to the reference's variable-size clamped window.

All argmaxes use row-major first-occurrence tie-breaking, matching
cv::minMaxLoc's scan order, so trajectories are bit-identical.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# Plain Python scalar: a jnp constant here would initialize the JAX backend
# at import time.
NEG_INF = float("-inf")


class WindowBounds(NamedTuple):
    """Inclusive NCC-map coordinates of the reference's clamped local window
    (tracker_ghc/src/main.cpp:195-198)."""

    min_tx: jax.Array
    max_tx: jax.Array
    min_ty: jax.Array
    max_ty: jax.Array

    @property
    def valid(self) -> jax.Array:
        """searchW > 0 && searchH > 0 (tracker_ghc/src/main.cpp:203)."""
        return (self.max_tx >= self.min_tx) & (self.max_ty >= self.min_ty)


def local_window_bounds(
    cx: jax.Array,
    cy: jax.Array,
    templ_w: int,
    templ_h: int,
    out_w: int,
    out_h: int,
    radius_x: int,
    radius_y: int,
) -> WindowBounds:
    """Clamped window around bbox center (cx, cy), in NCC-map coordinates.

    Mirrors the C++ integer math exactly: templ/2 truncates (all operands are
    non-negative in practice), bounds clamp independently to [0, out-1].
    """
    half_w = templ_w // 2
    half_h = templ_h // 2
    min_tx = jnp.maximum(0, cx - radius_x - half_w)
    max_tx = jnp.minimum(out_w - 1, cx + radius_x - half_w)
    min_ty = jnp.maximum(0, cy - radius_y - half_h)
    max_ty = jnp.minimum(out_h - 1, cy + radius_y - half_h)
    return WindowBounds(min_tx, max_tx, min_ty, max_ty)


def argmax2d(score_map: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(best_val, x, y) with row-major first-occurrence tie-break.

    jnp.argmax over the C-order flattening scans rows first, exactly like
    cv::minMaxLoc (tracker_ghc/src/main.cpp:418).
    """
    h, w = score_map.shape
    flat = score_map.reshape(-1)
    idx = jnp.argmax(flat)
    return flat[idx], (idx % w).astype(jnp.int32), (idx // w).astype(jnp.int32)


def masked_window_argmax(
    ncc_map: jax.Array, bounds: WindowBounds
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Argmax of a full NCC map restricted to `bounds` (full-map parity style).

    Positions outside the window score -inf; tie-break order inside the
    window is unchanged (row-major), so the result matches cv::minMaxLoc on
    the cropped ROI plus the (minTx, minTy) offset
    (tracker_ghc/src/main.cpp:204-210).
    """
    h, w = ncc_map.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    mask = (
        (xs >= bounds.min_tx)
        & (xs <= bounds.max_tx)
        & (ys >= bounds.min_ty)
        & (ys <= bounds.max_ty)
    )
    return argmax2d(jnp.where(mask, ncc_map, NEG_INF))


def region_origin(
    bounds: WindowBounds, out_w: int, out_h: int, span_x: int, span_y: int
) -> Tuple[jax.Array, jax.Array]:
    """Top-left NCC-map coordinate of the fixed-size candidate region.

    The fused fast path always evaluates a static (span_y, span_x) region
    (span = 2R+1).  The origin is the unclamped window start clipped so the
    region stays inside the map; the true clamped window is always a subset,
    recovered by masking.  Requires out_w >= span_x and out_h >= span_y
    (checked statically by the caller).
    """
    # min_tx is already clamped >= 0; additionally clamp the right edge.
    x0 = jnp.minimum(bounds.min_tx, out_w - span_x)
    y0 = jnp.minimum(bounds.min_ty, out_h - span_y)
    return x0.astype(jnp.int32), y0.astype(jnp.int32)


def masked_region_argmax(
    region_scores: jax.Array,
    x0: jax.Array,
    y0: jax.Array,
    bounds: WindowBounds,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Argmax over a fixed-size candidate region, masked to the true window.

    region_scores (span_y, span_x) are NCC scores at map coordinates
    (y0 + dy, x0 + dx).  Returns (best_val, x, y) in map coordinates,
    identical to masked_window_argmax on the full map.
    """
    sy, sx = region_scores.shape
    ys = y0 + jax.lax.broadcasted_iota(jnp.int32, (sy, sx), 0)
    xs = x0 + jax.lax.broadcasted_iota(jnp.int32, (sy, sx), 1)
    mask = (
        (xs >= bounds.min_tx)
        & (xs <= bounds.max_tx)
        & (ys >= bounds.min_ty)
        & (ys <= bounds.max_ty)
    )
    val, rx, ry = argmax2d(jnp.where(mask, region_scores, NEG_INF))
    return val, x0 + rx, y0 + ry
