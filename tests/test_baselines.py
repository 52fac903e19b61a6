"""Baseline model tests (B1 CSRT wrap, B2 JAX median-flow tracker)
plus utils (timing, checkpoint)."""

import numpy as np
import pytest

import jax.numpy as jnp

from pvot.io.synthetic import SyntheticSpec, generate_bgr_frames, generate_gray_video, target_bbox
from pvot.models.flow import (
    dense_flow,
    make_flow_step,
    masked_upper_median,
    track_video_flow,
)

cv2 = pytest.importorskip("cv2")


def test_masked_upper_median_matches_cpp():
    """nth_element(v.size()/2) semantics (cudab.cpp:23-27): upper median."""
    vals = np.array([5.0, 1.0, 3.0, 2.0], np.float32)  # sorted: 1 2 3 5
    mask = np.ones(4, bool)
    # v.size()/2 == 2 -> element 3.0
    assert float(masked_upper_median(jnp.asarray(vals), jnp.asarray(mask))) == 3.0
    mask = np.array([True, False, True, False])  # values 5,3 -> sorted 3,5 -> idx1=5
    assert float(masked_upper_median(jnp.asarray(vals), jnp.asarray(mask))) == 5.0
    assert float(masked_upper_median(jnp.asarray(vals), jnp.zeros(4, bool))) == 0.0


def test_dense_flow_recovers_translation(rng):
    """A globally shifted noise image must produce flow ~= the shift."""
    base = rng.random((96, 128)).astype(np.float32)
    base = np.asarray(dense_flow.__globals__["_box_mean"](jnp.asarray(base), 5))  # smooth
    shift = (3, 2)  # (dx, dy)
    curr = np.roll(np.roll(base, shift[1], axis=0), shift[0], axis=1)
    flow = np.asarray(dense_flow(jnp.asarray(base), jnp.asarray(curr)))
    # Farneback convention (what the reference's bbox update assumes,
    # cudab.cpp:100-101): prev(p) ~= curr(p + flow), so flow == +shift.
    inner = flow[:, 20:-20, 20:-20]
    med = np.median(inner, axis=(1, 2))
    np.testing.assert_allclose(med, [shift[0], shift[1]], atol=0.75)


def test_flow_tracker_follows_target():
    # Gentle motion (~3 px/frame): median-flow trackers drift on fast motion
    # (the reference's flow baseline is equally weak — it exists only as a
    # comparison point, Milestone PDF §3).
    spec = SyntheticSpec(
        width=256, height=192, num_frames=20, target_w=32, target_h=32,
        seed=3, amplitude=0.08, noise_std=0.0,
    )
    video = generate_gray_video(spec)
    x, y, w, h = target_bbox(spec, 0)
    _, boxes = track_video_flow(video, (x, y, w, h), chunk_size=8)
    for i, b in enumerate(boxes):
        gx, gy, _, _ = target_bbox(spec, i + 1)
        assert abs(int(b[0]) - gx) <= 8 and abs(int(b[1]) - gy) <= 8, (
            f"frame {i+1}: flow box {b[:2]} vs gt ({gx},{gy})"
        )


def test_csrt_baseline_tracks():
    """B1 runs with CSRT when available, else the documented MIL fallback."""
    from pvot.models.csrt import track_video_csrt

    spec = SyntheticSpec(
        width=256, height=192, num_frames=12, target_w=32, target_h=32,
        seed=3, amplitude=0.2,
    )
    frames = np.stack(list(generate_bgr_frames(spec)))
    roi = target_bbox(spec, 0)
    boxes, timer = track_video_csrt(frames, roi)
    assert boxes.shape == (11, 4)
    gx, gy, _, _ = target_bbox(spec, 11)
    assert abs(int(boxes[-1][0]) - gx) <= 8 and abs(int(boxes[-1][1]) - gy) <= 8
    assert timer.totals["track"] > 0


def test_checkpoint_roundtrip_resumes_identically(small_video, small_spec):
    from pvot.io.gray import gray_u8_to_f32
    from pvot.tracker.scan import track_video
    from pvot.tracker.state import init_state
    from pvot.utils.checkpoint import load_state, save_state
    import tempfile, os

    x, y, w, h = target_bbox(small_spec, 0)
    templ = gray_u8_to_f32(small_video[0])[y : y + h, x : x + w]
    state = init_state(jnp.asarray(templ), (x, y, w, h))
    full_final, full_out = track_video(small_video[1:], state, chunk_size=8)

    state2 = init_state(jnp.asarray(templ), (x, y, w, h))
    mid, out_a = track_video(small_video[1:20], state2, chunk_size=8)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        save_state(path, mid)
        resumed = load_state(path)
    _, out_b = track_video(small_video[20:], resumed, chunk_size=8)
    combined = np.concatenate([np.asarray(out_a.bbox), np.asarray(out_b.bbox)])
    np.testing.assert_array_equal(combined, np.asarray(full_out.bbox))
