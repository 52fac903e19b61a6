"""Tracker state pytree.

The reference carries this state across frames as C++ locals in the tracking
loop (tracker_ghc/src/main.cpp:135, 125, 142-143): {curr_bbox, templ_gray,
lost_frame_count, use_global_search}.  Here it is an immutable pytree — the
`lax.scan` carry of the device tracking loop — extended with cached template
stats so mean/std are recomputed only when the template changes (the
reference recomputes them on the host every frame,
tracker_ghc/src/baseline_kernel.cu:263-266; caching is exact because stats are
a pure function of the template).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pvot.ops.ncc_reference import template_stats


class TrackerState(NamedTuple):
    """Carry of the sequential tracking scan.

    bbox_x, bbox_y, bbox_w, bbox_h : int32 scalars — current box (full-frame
        coordinates; w/h equal the template size after the first update,
        tracker_ghc/src/main.cpp:451-454).
    template : float32 (th, tw) — adaptive template (EMA-updated).
    t_mean, t_std : float32 scalars — cached template stats; t_std includes
        the host-side +1e-6 (see pvot.ops.ncc_reference.template_stats).
    lost_count : int32 — consecutive low-confidence frames
        (tracker_ghc/src/main.cpp:142, 238).
    use_global : bool — sticky global-search flag
        (tracker_ghc/src/main.cpp:143, 183-185, 457-459).
    """

    bbox_x: jax.Array
    bbox_y: jax.Array
    bbox_w: jax.Array
    bbox_h: jax.Array
    template: jax.Array
    t_mean: jax.Array
    t_std: jax.Array
    lost_count: jax.Array
    use_global: jax.Array

    @property
    def bbox(self) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
        return (self.bbox_x, self.bbox_y, self.bbox_w, self.bbox_h)


class StepOutput(NamedTuple):
    """Per-frame outputs stacked by the scan."""

    bbox: jax.Array  # int32 (4,) = (x, y, w, h) after this frame's update
    score: jax.Array  # float32 best NCC value considered this frame
    used_global: jax.Array  # bool: did this frame search globally?
    updated: jax.Array  # bool: did the bbox move this frame?


def init_state(template: jax.Array, roi: Tuple[int, int, int, int]) -> TrackerState:
    """Initial state from the user-selected ROI and its template patch
    (tracker_ghc/src/main.cpp:322-325: template = gray(roi), curr_bbox = roi)."""
    x, y, w, h = roi
    template = jnp.asarray(template, jnp.float32)
    if template.shape != (h, w):
        raise ValueError(f"template shape {template.shape} != roi (h={h}, w={w})")
    t_mean, t_std = template_stats(template)
    return TrackerState(
        bbox_x=jnp.int32(x),
        bbox_y=jnp.int32(y),
        bbox_w=jnp.int32(w),
        bbox_h=jnp.int32(h),
        template=template,
        t_mean=t_mean,
        t_std=t_std,
        lost_count=jnp.int32(0),
        use_global=jnp.bool_(False),
    )


def is_bbox_outside_frame(
    bx: jax.Array, by: jax.Array, bw: jax.Array, bh: jax.Array, frame_w: int, frame_h: int
) -> jax.Array:
    """Port of isBboxOutsideFrame (tracker_ghc/src/main.cpp:49-55): center out
    of frame OR box entirely out of frame."""
    cx = bx + bw // 2
    cy = by + bh // 2
    center_out = (cx < 0) | (cx >= frame_w) | (cy < 0) | (cy >= frame_h)
    box_out = (bx + bw < 0) | (bx >= frame_w) | (by + bh < 0) | (by >= frame_h)
    return center_out | box_out
