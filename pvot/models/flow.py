"""JAX dense optical-flow tracker (baseline B2, SURVEY.md §2c).

The reference's second standalone baseline (baseline_cuda/cudab.cpp) tracks a
box with OpenCV's CUDA Farneback dense flow: per frame it computes full-frame
flow, reads the (fx, fy) vectors inside the bbox, keeps those with magnitude
in (0.5, 25), and if more than 15% of the box area survives, shifts the box
by the MEDIAN (dx, dy) (upper median via nth_element, cudab.cpp:23-27,
84-103) truncated toward zero, clamped to the frame (cudab.cpp:18-22).

This rebuild keeps that exact box-update contract but computes the dense flow
in JAX: coarse-to-fine Lucas-Kanade with integral-image window sums
(pvot.ops.ncc_matmul.sliding_box_sums — no large-kernel convs) and bilinear
warping.  The whole per-frame update is one
jittable function, scanned over the video like the NCC tracker.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pvot.ops.ncc_matmul import sliding_box_sums


def _box_mean(img: jax.Array, k: int) -> jax.Array:
    """Same-size k x k box mean via integral images (edge-padded)."""
    pad = k // 2
    padded = jnp.pad(img, ((pad, k - 1 - pad), (pad, k - 1 - pad)), mode="edge")
    sums, _ = sliding_box_sums(padded, k, k)
    return sums / (k * k)


def _downsample2(img: jax.Array) -> jax.Array:
    h, w = img.shape
    return img[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2).mean((1, 3))


def _upsample2_flow(flow: jax.Array, shape: Tuple[int, int]) -> jax.Array:
    """(2, h, w) -> (2, H, W), values doubled (flow scales with resolution)."""
    up = jnp.repeat(jnp.repeat(flow, 2, axis=1), 2, axis=2) * 2.0
    return up[:, : shape[0], : shape[1]]


def _warp(img: jax.Array, flow: jax.Array) -> jax.Array:
    """Bilinear backward warp: sample img at (y + fy, x + fx)."""
    h, w = img.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + flow[1]
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + flow[0]
    return jax.scipy.ndimage.map_coordinates(img, [ys, xs], order=1, mode="nearest")


def _lk_refine(prev: jax.Array, curr: jax.Array, flow: jax.Array, win: int) -> jax.Array:
    """One Lucas-Kanade iteration at this scale."""
    warped = _warp(curr, flow)
    ix = (jnp.roll(prev, -1, axis=1) - jnp.roll(prev, 1, axis=1)) * 0.5
    iy = (jnp.roll(prev, -1, axis=0) - jnp.roll(prev, 1, axis=0)) * 0.5
    it = warped - prev
    # Windowed structure tensor via box means (VPU-friendly).
    ixx = _box_mean(ix * ix, win)
    iyy = _box_mean(iy * iy, win)
    ixy = _box_mean(ix * iy, win)
    ixt = _box_mean(ix * it, win)
    iyt = _box_mean(iy * it, win)
    det = ixx * iyy - ixy * ixy
    inv_det = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)
    du = -(iyy * ixt - ixy * iyt) * inv_det
    dv = -(ixx * iyt - ixy * ixt) * inv_det
    # Reject wild updates (ill-conditioned windows).
    du = jnp.clip(du, -win, win)
    dv = jnp.clip(dv, -win, win)
    return flow + jnp.stack([du, dv])


def dense_flow(
    prev: jax.Array, curr: jax.Array, levels: int = 3, iters: int = 2, win: int = 7
) -> jax.Array:
    """Coarse-to-fine dense LK flow.  prev/curr (H, W) f32 -> (2, H, W) with
    channel 0 = fx, channel 1 = fy (matching cudab.cpp's split order)."""
    pyr_prev = [prev]
    pyr_curr = [curr]
    for _ in range(levels - 1):
        pyr_prev.append(_downsample2(pyr_prev[-1]))
        pyr_curr.append(_downsample2(pyr_curr[-1]))
    flow = jnp.zeros((2, *pyr_prev[-1].shape), jnp.float32)
    for lvl in range(levels - 1, -1, -1):
        if lvl != levels - 1:
            flow = _upsample2_flow(flow, pyr_prev[lvl].shape)
        for _ in range(iters):
            flow = _lk_refine(pyr_prev[lvl], pyr_curr[lvl], flow, win)
    return flow


def masked_upper_median(values: jax.Array, mask: jax.Array) -> jax.Array:
    """C++ nth_element(v.begin()+v.size()/2) median of masked values: sort
    with invalid entries pushed to +inf, take index count//2."""
    flat = jnp.where(mask.reshape(-1), values.reshape(-1), jnp.inf)
    srt = jnp.sort(flat)
    count = jnp.sum(mask).astype(jnp.int32)
    idx = jnp.clip(count // 2, 0, flat.shape[0] - 1)
    return jnp.where(count > 0, srt[idx], 0.0)


class FlowState(NamedTuple):
    bbox_x: jax.Array
    bbox_y: jax.Array
    prev_gray: jax.Array


def make_flow_step(
    frame_shape: Tuple[int, int],
    bbox_size: Tuple[int, int],
    mag_lo: float = 0.5,
    mag_hi: float = 25.0,
    min_valid_frac: float = 0.15,
):
    """Per-frame median-flow box update (cudab.cpp:63-115 semantics).

    bbox size is fixed for the run (the reference never resizes it)."""
    frame_h, frame_w = frame_shape
    bw, bh = bbox_size

    def step(state: FlowState, frame: jax.Array):
        frame = (
            frame.astype(jnp.float32) * (1.0 / 255.0)
            if frame.dtype == jnp.uint8
            else frame.astype(jnp.float32)
        )
        flow = dense_flow(state.prev_gray, frame)
        fx = lax.dynamic_slice(flow[0], (state.bbox_y, state.bbox_x), (bh, bw))
        fy = lax.dynamic_slice(flow[1], (state.bbox_y, state.bbox_x), (bh, bw))
        mag = jnp.sqrt(fx * fx + fy * fy)
        mask = (mag > mag_lo) & (mag < mag_hi)
        count = jnp.sum(mask)
        dx = masked_upper_median(fx, mask)
        dy = masked_upper_median(fy, mask)
        move = count > min_valid_frac * (bw * bh)
        # int(dx): C++ truncation toward zero.
        new_x = state.bbox_x + jnp.where(move, dx.astype(jnp.int32), 0)
        new_y = state.bbox_y + jnp.where(move, dy.astype(jnp.int32), 0)
        new_x = jnp.clip(new_x, 0, frame_w - bw)
        new_y = jnp.clip(new_y, 0, frame_h - bh)
        new_state = FlowState(new_x, new_y, frame)
        return new_state, jnp.stack([new_x, new_y, jnp.int32(bw), jnp.int32(bh)])

    return step


def track_video_flow(
    frames: np.ndarray, bbox: Tuple[int, int, int, int], chunk_size: int = 16
):
    """Track a gray video (F, H, W) with the flow baseline; frame 0 seeds
    prev_gray (cudab.cpp:55-57).  Returns (final_state, bboxes (F-1, 4))."""
    frames = np.asarray(frames)
    f, h, w = frames.shape
    x, y, bw, bh = bbox
    first = frames[0]
    first_f32 = (
        first.astype(np.float32) / 255.0 if first.dtype == np.uint8 else first
    )
    state = FlowState(jnp.int32(x), jnp.int32(y), jnp.asarray(first_f32))
    step = make_flow_step((h, w), (bw, bh))
    scan = jax.jit(lambda s, fr: lax.scan(step, s, fr))
    outs = []
    for start in range(1, f, chunk_size):
        chunk = jnp.asarray(frames[start : start + chunk_size])
        state, boxes = scan(state, chunk)
        outs.append(np.asarray(boxes))
    return state, np.concatenate(outs) if outs else np.zeros((0, 4), np.int32)
