"""Serving scenarios on the vmapped XLA path, each against per-stream or
per-object track_video: unequal lengths, per-stream loss and
re-acquisition, tail-chunk masking, batch cadence with a leftover tail,
candidate spans over 128 columns, large templates, K objects, bucketed
template sizes and grouped geometries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pvot.config import TrackerConfig
from pvot.io.gray import gray_u8_to_f32
from pvot.io.serving import serve_objects, serve_streams, serve_streams_grouped
from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot.parallel.multi import init_multi_state_bucketed, track_video_multi
from pvot.tracker.scan import track_video, track_video_batched
from pvot.tracker.state import init_state

CONFIG = TrackerConfig(search_radius_x=8, search_radius_y=8)
SHAPE = (94, 250)


def _stream(n, seed, height=94, width=250, templ=16, spec_len=None, **kw):
    """(frames (n+1, H, W) uint8, initial state) of one synthetic stream.
    The target's path spans spec_len frames (default n+1): a short clip cut
    from a long path moves slowly enough to track."""
    spec = SyntheticSpec(width=width, height=height,
                         num_frames=spec_len or n + 1, target_w=templ,
                         target_h=templ, seed=seed, noise_std=1.0, **kw)
    frames = generate_gray_video(spec)[: n + 1]
    x, y, w, h = target_bbox(spec, 0)
    templ_img = jnp.asarray(gray_u8_to_f32(frames[0])[y : y + h, x : x + w])
    return frames, init_state(templ_img, (x, y, w, h))


def _stack(states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _assert_same(want, got, score_tol=1e-4):
    """Boxes and flags equal; scores within score_tol.  The default covers
    the vmapped step's other float32 summation order, which the NCC
    normalisation amplifies to ~5e-5 on low-contrast (lost-target)
    windows."""
    np.testing.assert_array_equal(np.asarray(want.bbox), np.asarray(got.bbox))
    np.testing.assert_array_equal(np.asarray(want.used_global),
                                  np.asarray(got.used_global))
    np.testing.assert_array_equal(np.asarray(want.updated),
                                  np.asarray(got.updated))
    np.testing.assert_allclose(np.asarray(want.score), np.asarray(got.score),
                               atol=score_tol)


def _serve_and_check(clips, config=CONFIG, shape=SHAPE, chunk_size=4):
    stacked = _stack([s for _, s in clips])
    timings = []
    final, outs = serve_streams(
        [iter(f[1:]) for f, _ in clips], stacked, shape, config,
        chunk_size=chunk_size, timings=timings,
    )
    assert sum(n for n, _ in timings) == sum(len(f) - 1 for f, _ in clips)
    for s, (frames, state) in enumerate(clips):
        want_state, want = track_video(frames[1:], state, config,
                                       chunk_size=chunk_size)
        assert len(outs[s].bbox) == len(frames) - 1
        _assert_same(want, outs[s])
        assert int(final.bbox_x[s]) == int(want_state.bbox_x)
        assert int(final.lost_count[s]) == int(want_state.lost_count)
    return outs


@pytest.mark.parametrize("lengths", [(5, 9), (13, 6, 17), (1, 8), (4, 4, 4, 4)])
@pytest.mark.parametrize("chunk_size", [3, 4])
def test_serve_streams_unequal_lengths(lengths, chunk_size):
    """Streams ending at different ticks: each ended stream's lanes carry
    invalid padding (state frozen) while the others finish."""
    clips = [_stream(n, seed=3 + i) for i, n in enumerate(lengths)]
    _serve_and_check(clips, chunk_size=chunk_size)


@pytest.mark.parametrize("lost", [0, 1, 2])
def test_serve_streams_per_stream_loss(lost):
    """One of three streams loses its target and re-acquires it by global
    search; the vmapped step runs the global branch for all lanes on those
    frames, and only the lost stream's records change."""
    config = TrackerConfig(search_radius_x=8, search_radius_y=8,
                           lost_frame_threshold=2)
    clips = [
        _stream(17, seed=5, exit_and_reenter=True) if s == lost
        else _stream(17, seed=3 + s, spec_len=120)
        for s in range(3)
    ]
    outs = _serve_and_check(clips, config=config)
    for s in range(3):
        assert bool(np.asarray(outs[s].used_global).any()) == (s == lost)


@pytest.mark.parametrize("chunk_size", [1, 2, 3, 5, 8, 13])
def test_track_video_tail_chunk_masking(chunk_size):
    """Any chunk size (tail chunk padded and masked) gives the trajectory of
    one unpadded chunk covering the whole clip."""
    frames, state = _stream(13, seed=7)
    want_state, want = track_video(frames[1:], state, CONFIG, chunk_size=13)
    got_state, got = track_video(frames[1:], state, CONFIG,
                                 chunk_size=chunk_size)
    _assert_same(want, got, score_tol=1e-6)
    np.testing.assert_allclose(np.asarray(got_state.template),
                               np.asarray(want_state.template), atol=1e-6)


@pytest.mark.parametrize("n_frames,batch", [(10, 3), (9, 4), (7, 2), (11, 5)])
def test_batch_cadence_leftover_tail(n_frames, batch):
    """Batch cadence: one update per full batch on its last frame; the
    leftover frames re-emit the previous bbox with no update, through both
    the array driver and the streaming driver."""
    from pvot.io.pipeline import track_stream_batched

    frames, state = _stream(n_frames, seed=9)
    config = TrackerConfig(search_radius_x=8, search_radius_y=8,
                           batch_size=batch)
    _, want = track_video_batched(frames[1:], state, config, batch_size=batch,
                                  chunks_per_dispatch=2)
    _, got = track_stream_batched(iter(frames[1:]), state, SHAPE, config,
                                  batch_size=batch, chunks_per_dispatch=2)
    _assert_same(want, got, score_tol=0.0)
    upd = np.asarray(want.updated)
    assert upd.sum() <= n_frames // batch
    assert not upd[: batch - 1].any()
    leftover = n_frames % batch
    if leftover:
        tail = np.asarray(want.bbox)[-leftover:]
        assert (tail == np.asarray(want.bbox)[-leftover - 1]).all()
        assert not upd[-leftover:].any()


@pytest.mark.parametrize("rx,ry", [(70, 8), (8, 40), (66, 30)])
def test_serve_streams_wide_spans(rx, ry):
    """Candidate windows wider than 128 columns (or taller than 80 rows)
    serve exactly like the single-stream path."""
    config = TrackerConfig(search_radius_x=rx, search_radius_y=ry)
    clips = [_stream(7, seed=11 + s, height=180, width=320)
             for s in range(2)]
    _serve_and_check(clips, config=config, shape=(180, 320))


@pytest.mark.parametrize("templ", [48, 96, 128])
def test_serve_streams_large_templates(templ):
    """Large templates (up to 128 px a side) on a small frame."""
    clips = [_stream(6, seed=13 + s, height=240, width=320, templ=templ)
             for s in range(2)]
    _serve_and_check(clips, shape=(240, 320))


def _objects_clip(n_frames, k):
    """One stream and k decisive trackables: the moving target plus static
    textured patches stamped into every frame."""
    frames, target = _stream(n_frames, seed=3)
    rng = np.random.default_rng(23)
    rois = [tuple(int(v) for v in (target.bbox_x, target.bbox_y, 16, 16))]
    for i in range(k - 1):
        x, y = 8 + 40 * i, 4 + (i % 2) * 60
        frames[:, y : y + 16, x : x + 16] = rng.integers(0, 256, (16, 16),
                                                         np.uint8)
        rois.append((x, y, 16, 16))
    g0 = gray_u8_to_f32(frames[0])
    templs = [g0[y : y + h, x : x + w] for x, y, w, h in rois]
    return frames, rois, templs


@pytest.mark.parametrize("k", [1, 2, 4])
def test_serve_objects_k(k):
    """K objects over one stream: the (F, K) output, each lane equal to a
    lone tracker over the same clip."""
    frames, rois, templs = _objects_clip(11, k)
    states = [init_state(jnp.asarray(t), r) for t, r in zip(templs, rois)]
    final, out = serve_objects(iter(frames[1:]), _stack(states), SHAPE,
                               CONFIG, chunk_size=4)
    assert out.bbox.shape == (11, k, 4)
    for i, st in enumerate(states):
        want_state, want = track_video(frames[1:], st, CONFIG, chunk_size=4)
        np.testing.assert_array_equal(np.asarray(want.bbox), out.bbox[:, i])
        np.testing.assert_array_equal(np.asarray(want.updated),
                                      out.updated[:, i])
        np.testing.assert_allclose(np.asarray(want.score), out.score[:, i],
                                   atol=2e-5)
        assert int(final.bbox_x[i]) == int(want_state.bbox_x)


@pytest.mark.parametrize("sizes", [(16, 12), (16, 8, 12), (20, 16)])
def test_serve_objects_bucketed_sizes(sizes):
    """Mixed template sizes over one stream (the bucketed layout): every
    object's boxes equal a lone tracker at its true geometry; scores within
    the bucketed NCC's reassociation bound."""
    frames, target = _stream(11, seed=3)
    tx, ty = int(target.bbox_x), int(target.bbox_y)
    g0 = gray_u8_to_f32(frames[0])
    rois = [(tx + (16 - t) // 2, ty + (16 - t) // 2, t, t) for t in sizes]
    templs = [g0[y : y + h, x : x + w] for x, y, w, h in rois]
    stacked = init_multi_state_bucketed([np.asarray(t) for t in templs], rois)
    _, out = serve_objects(iter(frames[1:]), stacked, SHAPE, CONFIG,
                           chunk_size=4)
    assert out.bbox.shape[:2] == (11, len(sizes))
    for i, (t, roi) in enumerate(zip(templs, rois)):
        _, want = track_video(frames[1:], init_state(jnp.asarray(t), roi),
                              CONFIG, chunk_size=4)
        np.testing.assert_array_equal(np.asarray(want.bbox), out.bbox[:, i])
        np.testing.assert_allclose(np.asarray(want.score), out.score[:, i],
                                   atol=2e-3)


@pytest.mark.parametrize("geoms", [
    ((9, 94, 250, 16), (5, 94, 230, 16)),
    ((6, 94, 250, 16), (8, 120, 200, 24), (4, 94, 250, 16)),
    ((7, 100, 180, 12), (7, 100, 180, 20)),
])
def test_serve_streams_grouped_geometries(geoms):
    """Streams grouped by (frame size, template size), groups served
    concurrently; every stream equals its own track_video, in input order."""
    clips = [_stream(n, seed=30 + i, height=h, width=w, templ=t)
             for i, (n, h, w, t) in enumerate(geoms)]
    finals, outs = serve_streams_grouped(
        [iter(f[1:]) for f, _ in clips], [s for _, s in clips],
        [(h, w) for _, h, w, _ in geoms], CONFIG, chunk_size=4,
    )
    for s, (frames, state) in enumerate(clips):
        want_state, want = track_video(frames[1:], state, CONFIG, chunk_size=4)
        _assert_same(want, outs[s])
        assert int(finals[s].bbox_x) == int(want_state.bbox_x)


@pytest.mark.parametrize("chunk_size", [4, 7])
def test_device_resident_frames_match_host(chunk_size):
    """track_video accepts device-resident frames (sliced and tail-padded
    on device) with records and final state equal to host frames, through
    a clip that goes global."""
    config = TrackerConfig(search_radius_x=8, search_radius_y=8,
                           lost_frame_threshold=2)
    frames, state = _stream(17, seed=5, exit_and_reenter=True)
    want_state, want = track_video(frames[1:], state, config,
                                   chunk_size=chunk_size)
    got_state, got = track_video(jax.device_put(frames[1:]), state, config,
                                 chunk_size=chunk_size)
    assert np.asarray(want.used_global).any()
    _assert_same(want, got, score_tol=0.0)
    assert bool(got_state.use_global) == bool(want_state.use_global)


def test_track_video_multi_routes_bucketed():
    """track_video_multi detects bucketed states (bbox extents differ from
    the template bucket) and runs them on the traced-extent step."""
    frames, target = _stream(9, seed=3)
    tx, ty = int(target.bbox_x), int(target.bbox_y)
    g0 = gray_u8_to_f32(frames[0])
    rois = [(tx, ty, 16, 16), (tx + 2, ty + 2, 12, 12)]
    templs = [g0[y : y + h, x : x + w] for x, y, w, h in rois]
    stacked = init_multi_state_bucketed([np.asarray(t) for t in templs], rois)
    _, got = track_video_multi(frames[1:], stacked, CONFIG, chunk_size=4)
    for i, (t, roi) in enumerate(zip(templs, rois)):
        _, want = track_video(frames[1:], init_state(jnp.asarray(t), roi),
                              CONFIG, chunk_size=4)
        np.testing.assert_array_equal(np.asarray(want.bbox), got.bbox[:, i])
        np.testing.assert_allclose(np.asarray(want.score), got.score[:, i],
                                   atol=2e-3)
