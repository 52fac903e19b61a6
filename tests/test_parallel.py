"""Multi-object vmap and multi-chip sharding tests (8 virtual CPU devices,
see conftest.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pvot.config import TrackerConfig
from pvot.io.gray import gray_u8_to_f32
from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot.parallel.multi import init_multi_state, track_video_multi
from pvot.parallel.sharded import (
    make_data_parallel_multi_step,
    make_search_sharded_step,
    shard_states,
)
from pvot.tracker.scan import track_video
from pvot.tracker.state import init_state
from pvot.tracker.step import make_step

CFG = TrackerConfig(search_radius_x=20, search_radius_y=20)


def _spec(seed):
    return SyntheticSpec(
        width=256, height=192, num_frames=16, target_w=24, target_h=24,
        seed=seed, amplitude=0.25,
    )


def _setup(seed):
    spec = _spec(seed)
    video = generate_gray_video(spec)
    x, y, w, h = target_bbox(spec, 0)
    templ = gray_u8_to_f32(video[0])[y : y + h, x : x + w]
    return spec, video, (x, y, w, h), templ


def test_multi_object_matches_single():
    """K vmapped trackers == K independent single trackers."""
    spec, video, roi, templ = _setup(5)
    # Two objects: the true target and a fixed background patch.
    roi2 = (40, 40, 24, 24)
    templ2 = gray_u8_to_f32(video[0])[40:64, 40:64]
    states = init_multi_state([templ, templ2], [roi, roi2])
    _, multi_out = track_video_multi(video[1:], states, CFG, chunk_size=8)

    for i, (t, r) in enumerate([(templ, roi), (templ2, roi2)]):
        st = init_state(jnp.asarray(t), r)
        _, single = track_video(video[1:], st, CFG, chunk_size=8)
        np.testing.assert_array_equal(
            np.asarray(multi_out.bbox)[:, i, :], np.asarray(single.bbox)
        )


@pytest.mark.usefixtures("eight_devices")
def test_search_sharded_step_matches_unsharded():
    """TP-style search sharding: (data=2, search=4) mesh reproduces the
    single-device step exactly, collectives and all."""
    spec, video, roi, templ = _setup(9)
    h, w = video.shape[1:]
    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, ("data", "search"))

    # Two streams = same clip twice with different seeds.
    spec_b, video_b, roi_b, templ_b = _setup(11)
    states = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        init_state(jnp.asarray(templ), roi),
        init_state(jnp.asarray(templ_b), roi_b),
    )
    states = shard_states(mesh, states, P("data"))
    sharded = make_search_sharded_step(mesh, (h, w), (24, 24), CFG)
    step = make_step((h, w), (24, 24), CFG, strategy="fused")

    ref_states = [init_state(jnp.asarray(templ), roi), init_state(jnp.asarray(templ_b), roi_b)]
    videos = [video, video_b]
    jstep = jax.jit(sharded)
    for t in range(1, 8):
        frames = jnp.stack(
            [jnp.asarray(gray_u8_to_f32(videos[s][t])) for s in range(2)]
        )
        states, out = jstep(states, frames)
        for s in range(2):
            ref_states[s], ref_out = step(ref_states[s], jnp.asarray(gray_u8_to_f32(videos[s][t])))
            np.testing.assert_array_equal(
                np.asarray(out.bbox)[s], np.asarray(ref_out.bbox)
            )
            np.testing.assert_allclose(
                float(out.score[s]), float(ref_out.score), atol=5e-5
            )


@pytest.mark.usefixtures("eight_devices")
def test_data_parallel_multi_step_runs():
    """(streams x objects) sharding compiles and preserves trajectories."""
    spec, video, roi, templ = _setup(5)
    h, w = video.shape[1:]
    devices = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devices, ("data", "obj"))

    # 4 streams x 2 objects, all same geometry.
    roi2 = (40, 40, 24, 24)
    templ2 = gray_u8_to_f32(video[0])[40:64, 40:64]
    one = init_multi_state([templ, templ2], [roi, roi2])
    states = jax.tree.map(lambda a: jnp.stack([a] * 4), one)
    states = shard_states(mesh, states, P("data", "obj"))
    step = make_data_parallel_multi_step(mesh, (h, w), (24, 24), CFG)
    jstep = jax.jit(step)
    frames = jnp.stack([jnp.asarray(gray_u8_to_f32(video[1]))] * 4)
    new_states, out = jstep(states, frames)
    assert np.asarray(out.bbox).shape == (4, 2, 4)
    # All four streams saw identical data -> identical results.
    b = np.asarray(out.bbox)
    assert (b == b[0]).all()
    gx, gy, _, _ = target_bbox(spec, 1)
    assert abs(int(b[0, 0, 0]) - gx) <= 2 and abs(int(b[0, 0, 1]) - gy) <= 2


def test_multi_object_global_reacquisition():
    """Multi-object step must re-acquire a lost object via the scalar-cond
    global pass (the cheap path skips it when no object is lost)."""
    from pvot.config import TrackerConfig
    from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
    from pvot.parallel.multi import init_multi_state, track_video_multi
    from pvot.io.gray import gray_u8_to_f32

    cfg = TrackerConfig(
        search_radius_x=20, search_radius_y=20, lost_frame_threshold=6
    )
    spec = SyntheticSpec(
        width=320, height=240, num_frames=60, target_w=32, target_h=32,
        seed=3, exit_and_reenter=True,
    )
    video = generate_gray_video(spec)
    x, y, w, h = target_bbox(spec, 0)
    g0 = gray_u8_to_f32(video[0])
    rois = [(x, y, w, h), (16, 16, 32, 32)]
    templates = [g0[ry : ry + hh, rx : rx + ww] for rx, ry, ww, hh in rois]
    states = init_multi_state(templates, rois)
    final, out = track_video_multi(video[1:], states, cfg, chunk_size=10)
    used_global = np.asarray(out.used_global)
    assert used_global[:, 0].any(), "lost object never searched globally"
    gx, gy, _, _ = target_bbox(spec, spec.num_frames - 1)
    last = np.asarray(out.bbox)[-1, 0]
    assert abs(int(last[0]) - gx) <= 3 and abs(int(last[1]) - gy) <= 3


def test_multi_stream_matches_single():
    """S lockstep streams == S independent single trackers."""
    from pvot.parallel.multi import make_multi_stream_step
    from pvot.tracker.scan import make_masked_scan_fn

    specs = [_spec(5), _spec(9)]
    videos = [generate_gray_video(s) for s in specs]
    states, singles = [], []
    for spec, video in zip(specs, videos):
        x, y, w, h = target_bbox(spec, 0)
        templ = gray_u8_to_f32(video[0])[y : y + h, x : x + w]
        states.append(init_state(jnp.asarray(templ), (x, y, w, h)))
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    h_, w_ = videos[0].shape[1:]
    step = make_multi_stream_step((h_, w_), (24, 24), CFG)
    jstep = jax.jit(step)
    for t in range(1, 10):
        frames = jnp.stack([jnp.asarray(v[t]) for v in videos])
        batched, out = jstep(batched, frames)
        for s, (spec, video) in enumerate(zip(specs, videos)):
            st = states[s]
            from pvot.tracker.step import make_step

            single_step = make_step((h_, w_), (24, 24), CFG)
            states[s], ref_out = jax.jit(single_step)(st, jnp.asarray(video[t]))
            np.testing.assert_array_equal(
                np.asarray(out.bbox)[s], np.asarray(ref_out.bbox)
            )


def test_bucketed_multi_object_heterogeneous_sizes():
    """K objects with DIFFERENT template sizes == K independent single
    trackers (bucketed traced-extent path)."""
    from pvot.parallel.multi import init_multi_state_bucketed, make_multi_step_bucketed
    from pvot.tracker.scan import make_masked_scan_fn
    from pvot.tracker.step import make_step

    spec = SyntheticSpec(
        width=256, height=192, num_frames=14, target_w=24, target_h=24,
        seed=5, amplitude=0.25,
    )
    video = generate_gray_video(spec)
    g0 = gray_u8_to_f32(video[0])
    x, y, w, h = target_bbox(spec, 0)
    rois = [(x, y, w, h), (40, 40, 16, 32), (120, 30, 36, 20)]
    templates = [g0[ry : ry + hh, rx : rx + ww] for rx, ry, ww, hh in rois]
    states = init_multi_state_bucketed(templates, rois)
    assert states.template.shape == (3, 32, 36)

    h_, w_ = video.shape[1:]
    mstep = jax.jit(make_multi_step_bucketed((h_, w_), (32, 36), CFG))
    singles = [init_state(jnp.asarray(t), r) for t, r in zip(templates, rois)]
    ssteps = [
        jax.jit(make_step((h_, w_), t.shape, CFG, strategy="fused"))
        for t in templates
    ]
    for t in range(1, 14):
        frame = jnp.asarray(video[t])
        states, out = mstep(states, frame)
        for k in range(3):
            singles[k], ref = ssteps[k](singles[k], frame)
            np.testing.assert_array_equal(
                np.asarray(out.bbox)[k], np.asarray(ref.bbox),
                err_msg=f"frame {t} object {k}",
            )
            # Bucketed box sums integrate over the (bigger) bucket extent, so
            # f32 integral-image rounding grows; trajectories stay exact.
            np.testing.assert_allclose(
                float(out.score[k]), float(ref.score), atol=2e-3
            )


def test_bucketed_global_reacquisition():
    """Bucketed path: lost object re-acquires via the traced-extent
    full-frame pass."""
    from pvot.parallel.multi import init_multi_state_bucketed, make_multi_step_bucketed
    from pvot.config import TrackerConfig

    cfg = TrackerConfig(
        search_radius_x=20, search_radius_y=20, lost_frame_threshold=6
    )
    spec = SyntheticSpec(
        width=320, height=240, num_frames=60, target_w=32, target_h=32,
        seed=3, exit_and_reenter=True,
    )
    video = generate_gray_video(spec)
    g0 = gray_u8_to_f32(video[0])
    x, y, w, h = target_bbox(spec, 0)
    rois = [(x, y, w, h), (16, 16, 24, 20)]
    templates = [g0[ry : ry + hh, rx : rx + ww] for rx, ry, ww, hh in rois]
    states = init_multi_state_bucketed(templates, rois)
    h_, w_ = video.shape[1:]
    mstep = jax.jit(make_multi_step_bucketed((h_, w_), (32, 32), cfg))
    globals_seen = False
    for t in range(1, 60):
        states, out = mstep(states, jnp.asarray(video[t]))
        globals_seen = globals_seen or bool(np.asarray(out.used_global)[0])
    assert globals_seen
    gx, gy, _, _ = target_bbox(spec, 59)
    b = np.asarray(out.bbox)[0]
    assert abs(int(b[0]) - gx) <= 3 and abs(int(b[1]) - gy) <= 3


@pytest.mark.usefixtures("eight_devices")
def test_track_video_sharded_matches_unsharded():
    """The scanned multi-chip driver (chunked masked scan of the
    (data x search)-sharded step) reproduces per-stream unsharded
    trajectories EXACTLY, across chunk boundaries and the masked tail."""
    from pvot.parallel.sharded import track_video_sharded

    spec_a, video_a, roi_a, templ_a = _setup(9)
    spec_b, video_b, roi_b, templ_b = _setup(11)
    h, w = video_a.shape[1:]
    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, ("data", "search"))

    states = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        init_state(jnp.asarray(templ_a), roi_a),
        init_state(jnp.asarray(templ_b), roi_b),
    )
    videos = np.stack([video_a[1:], video_b[1:]])  # (S=2, F=15, H, W)
    # chunk 6 -> chunks of 6, 6, 3 (masked tail)
    final, out = track_video_sharded(videos, states, mesh, CFG, chunk_size=6)
    assert out.bbox.shape == (15, 2, 4)

    for s, (t, r, v) in enumerate(
        [(templ_a, roi_a, video_a), (templ_b, roi_b, video_b)]
    ):
        st = init_state(jnp.asarray(t), r)
        _, single = track_video(v[1:], st, CFG, chunk_size=8)
        np.testing.assert_array_equal(
            np.asarray(out.bbox)[:, s, :], np.asarray(single.bbox)
        )
        np.testing.assert_array_equal(
            np.asarray(out.updated)[:, s], np.asarray(single.updated)
        )
    # Final carried state survives the chunk boundaries identically.
    np.testing.assert_array_equal(
        np.asarray(final.bbox_x), np.asarray(out.bbox)[-1, :, 0]
    )


@pytest.mark.usefixtures("eight_devices")
def test_search_sharded_global_reacquisition_matches_unsharded():
    """Round-5 VERDICT item: the sharded GLOBAL-SEARCH branch (full-map
    strip-per-device scorer + share mask + _lex_combine) was never
    exercised by any test.  Drive an exit-and-reenter clip with a small
    lost_frame_threshold through the (2x4)-mesh scanned driver and assert
    exact bbox/flag parity with the unsharded scan through the whole
    lost -> global -> re-acquire arc (tracker_ghc/src/main.cpp:399-446)."""
    from pvot.parallel.sharded import track_video_sharded

    cfg = TrackerConfig(
        search_radius_x=20, search_radius_y=20, lost_frame_threshold=6
    )
    specs = [
        SyntheticSpec(
            width=320, height=240, num_frames=40, target_w=32, target_h=32,
            seed=seed, exit_and_reenter=True,
        )
        for seed in (3, 7)
    ]
    videos = [generate_gray_video(s) for s in specs]
    states_l = []
    for spec, video in zip(specs, videos):
        x, y, w, h = target_bbox(spec, 0)
        templ = gray_u8_to_f32(video[0])[y : y + h, x : x + w]
        states_l.append(init_state(jnp.asarray(templ), (x, y, w, h)))
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *states_l)

    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, ("data", "search"))
    stacked = np.stack([v[1:] for v in videos])  # (S=2, F=39, H, W)
    final, out = track_video_sharded(stacked, states, mesh, cfg, chunk_size=8)

    any_global = False
    for s, video in enumerate(videos):
        _, single = track_video(video[1:], states_l[s], cfg, chunk_size=8)
        np.testing.assert_array_equal(
            np.asarray(out.bbox)[:, s, :], np.asarray(single.bbox)
        )
        np.testing.assert_array_equal(
            np.asarray(out.used_global)[:, s], np.asarray(single.used_global)
        )
        np.testing.assert_array_equal(
            np.asarray(out.updated)[:, s], np.asarray(single.updated)
        )
        # Global-frame scores integrate integral images over per-device
        # strips instead of the full map — f32 rounding grows to ~5e-4
        # (trajectories/flags above stay EXACT, which is the contract).
        np.testing.assert_allclose(
            np.asarray(out.score)[:, s], np.asarray(single.score), atol=2e-3
        )
        any_global = any_global or bool(np.asarray(single.used_global).any())
    assert any_global, "fixture never entered global search — test is vacuous"
    # The arc must complete: re-acquired near ground truth at the end.
    for s, spec in enumerate(specs):
        gx, gy, _, _ = target_bbox(spec, spec.num_frames - 1)
        last = np.asarray(out.bbox)[-1, s]
        assert abs(int(last[0]) - gx) <= 3 and abs(int(last[1]) - gy) <= 3


@pytest.mark.usefixtures("eight_devices")
def test_search_sharded_global_tie_row_major_across_shards():
    """A full-map EXACT score tie spanning two different search shards must
    land on the row-major first occurrence (cv::minMaxLoc semantics carried
    through _lex_combine's all_gather fold).  The frame is built from
    dyadic f32 values (multiples of 2^-2) so every integral-image sum, dot
    product, and mean is exact in f32 — the two planted template copies
    score bit-identically and the tie is real, not a rounding accident."""
    h_f, w_f, ts = 192, 256, 32
    rng = np.random.default_rng(42)
    pattern = rng.integers(0, 4, (ts, ts)).astype(np.float32) * 0.25
    frame = np.zeros((h_f, w_f), np.float32)
    # out_h = 161, full_slab = 41 on a 4-way search axis: y=30 lives in
    # search shard 0, y=130 in shard 3.
    y1, x1 = 30, 40
    y2, x2 = 130, 200
    frame[y1 : y1 + ts, x1 : x1 + ts] = pattern
    frame[y2 : y2 + ts, x2 : x2 + ts] = pattern

    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, ("data", "search"))
    one = init_state(jnp.asarray(pattern), (x2, y2, ts, ts))._replace(
        use_global=jnp.bool_(True)  # force the full-map branch this frame
    )
    states = jax.tree.map(lambda *xs: jnp.stack(xs), one, one)
    states = shard_states(mesh, states, P("data"))
    sharded = jax.jit(make_search_sharded_step(mesh, (h_f, w_f), (ts, ts), CFG))
    frames = jnp.stack([jnp.asarray(frame)] * 2)
    _, out = sharded(states, frames)

    # Unsharded oracle: same frame, same forced-global state.
    step = make_step((h_f, w_f), (ts, ts), CFG, strategy="fused")
    _, ref = jax.jit(step)(one, jnp.asarray(frame))
    assert bool(ref.used_global), "oracle did not search globally"
    np.testing.assert_array_equal(
        np.asarray(ref.bbox), np.asarray([x1, y1, ts, ts])
    )
    for s in range(2):
        assert bool(np.asarray(out.used_global)[s])
        np.testing.assert_array_equal(
            np.asarray(out.bbox)[s], np.asarray(ref.bbox)
        )
        np.testing.assert_allclose(
            float(np.asarray(out.score)[s]), float(ref.score), atol=1e-6
        )


def test_track_video_sharded_backend_arg():
    """The sharded step's per-slab engine is selectable by mode name: the
    "cuda" alias resolves through pvot.ops.backends to the "xla" engine's
    full-map scorer, whose trajectories equal the default path's."""
    from pvot.parallel.sharded import track_video_sharded

    spec_a, video_a, roi_a, templ_a = _setup(9)
    h, w = video_a.shape[1:]
    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, ("data", "search"))
    states = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        init_state(jnp.asarray(templ_a), roi_a),
        init_state(jnp.asarray(templ_a), roi_a),
    )
    videos = np.stack([video_a[1:], video_a[1:]])
    _, want = track_video_sharded(videos, states, mesh, CFG, chunk_size=6)
    _, got = track_video_sharded(
        videos, states, mesh, CFG, chunk_size=6, backend="cuda"
    )
    np.testing.assert_array_equal(np.asarray(want.bbox), np.asarray(got.bbox))
    np.testing.assert_array_equal(
        np.asarray(want.score), np.asarray(got.score)
    )
