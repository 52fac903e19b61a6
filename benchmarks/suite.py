"""Benchmark suite: the BASELINE.json configs and pvot's serving extensions,
timed on one NVIDIA GPU.

  1     720p --cpu parity path (full-map TM_CCOEFF_NORMED + windowed argmax)
  2     720p fused NCC with adaptive template update (the bench.py geometry)
  3     batch mode N in {4, 8, 16, 32} (look-ahead cadence, parity semantics)
  4/4f  1080p and 4K with a 160 px search radius (xla / xla_fast engine)
  4t    1080p with a 160 px template at radius 160 (xla / xla_fast)
  5     multi-object: 8 templates per 720p frame via vmap
  6     multi-stream: 8 independent 720p streams in lockstep
  7a-d  stream sweep S in {8, 16, 32, 64}
  7h    mixed geometries (8 x 720p/t80 + 4 x 1080p/t64) through
        pvot.serve_streams_grouped, end to end
  7me   end-to-end live serving through pvot.serve_streams (decode feeds,
        upload, tracking and record fetch all timed)
  8     streams x batch (32 streams, batch 4)
  10    one row per reference mode flag at one geometry (README.md:128-137)
  12    occlusion sweep: periodic exits drive lost -> global -> re-acquire
  12m*  occlusion-heavy multi-stream serving, staggered vs simultaneous
  13    median of fresh bench.py processes

Every row is tracked on the staged clip through the chunked scan, warmed
once (compilation is set-up, not timed), then timed best-of-two with the
outputs fetched to the host (which waits for the device).  Each row checks
its trajectory against the synthetic ground truth where one exists.

Run:  python benchmarks/suite.py [--configs 1,2,3] [--frames N] [--out PATH]
Prints one JSON line per row and merges them into --out.  It refuses to run
without a GPU; every row names the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_FPS = 12.15  # README.md:101-117 example session, --shared mode

# Published dense peaks per device_kind, in FLOP/s and bytes/s.  Source:
# NVIDIA H100 SXM data sheet (dense, no sparsity, at the 700 W limit).
# "f32" is float32 on the CUDA cores (the engines' Precision.HIGHEST),
# "tf32" the tensor cores at TF32 (what XLA runs Precision.HIGH as).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32": 67e12, "tf32": 495e12, "bf16": 989e12, "hbm": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet, dense",
    },
}
ENGINE_PEAK = {"xla": "f32", "cpu": "f32", "xla_fast": "tf32"}


def device_info() -> dict:
    """platform, device_kind and count of the devices JAX sees, and their
    published peaks.  A device missing from PEAKS is an error."""
    from pvot.utils.device import device_fields

    dev = device_fields()
    if dev["kind"] not in PEAKS:
        raise KeyError(f"no published peaks for device {dev['kind']!r}")
    return {
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "device_count": dev["count"],
        "peaks": PEAKS[dev["kind"]],
    }


def fused_region_flops(templ: int, radius: int) -> float:
    """FLOPs per frame per stream of the fused local-search path.

    Dominated by the im2col-x matmul over the (span + t - 1)^2 region; the
    shifted adds, two integral images, and the normalization are noise.
    """
    span = 2 * radius + 1
    rows = span + templ - 1
    mm = 2.0 * rows * span * templ * templ  # dot_general MACs
    adds = float(templ) * span * span  # shifted-add reduction
    integrals = 2.0 * 2.0 * rows * (span + templ - 1)  # 2 cumsums x 2 images
    norm = 10.0 * span * span
    return mm + adds + integrals + norm


def _peak_share(flops_per_s: float, backend: str) -> float:
    """Achieved FLOP/s as a percentage of the engine's published peak."""
    from pvot.ops.backends import resolve

    peaks = device_info()["peaks"]
    return round(100.0 * flops_per_s / peaks[ENGINE_PEAK[resolve(backend)]], 3)


def _time_run(run, trials: int = 2):
    """Warm once (compiles), then best-of-`trials` wall time of run(), which
    returns host arrays (so the device has finished)."""
    run()
    best, result = float("inf"), None
    for _ in range(trials):
        t0 = time.perf_counter()
        result = run()
        best = min(best, time.perf_counter() - t0)
    return result, best


def _clip(width, height, templ, num_frames, seed=1, **spec_kw):
    """(spec, frames uint8 (F+1, H, W), initial state) of a synthetic clip."""
    import jax.numpy as jnp

    from pvot.io.gray import gray_u8_to_f32
    from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
    from pvot.tracker.state import init_state

    spec = SyntheticSpec(
        width=width, height=height, num_frames=num_frames + 1,
        target_w=templ, target_h=templ, seed=seed, **spec_kw,
    )
    frames = generate_gray_video(spec)
    x, y, w, h = target_bbox(spec, 0)
    state = init_state(
        jnp.asarray(gray_u8_to_f32(frames[0])[y : y + h, x : x + w]),
        (x, y, w, h),
    )
    return spec, frames, state


def _max_err(spec, bboxes, every: int = 1) -> int:
    """Max L1 bbox-origin error vs ground truth over (F, 4) or (F, S, 4)
    records; `every` > 1 checks only the frames a batch cadence scores."""
    from pvot.io.synthetic import target_bbox

    b = np.asarray(bboxes).reshape(len(bboxes), -1, 4)
    err = 0
    for i in range(every - 1, len(b), every):
        tx, ty = target_bbox(spec, i + 1)[:2]
        err = max(err, int(np.max(np.abs(b[i, :, 0] - tx) + np.abs(b[i, :, 1] - ty))))
    return err


def _row(name, backend, frames_per_s, elapsed, frames, **extra):
    return {
        "config": name,
        "backend": backend,
        "value": round(frames_per_s, 2),
        "unit": "frames/s",
        "vs_baseline": round(frames_per_s / REFERENCE_FPS, 2),
        "frames": frames,
        "elapsed_s": round(elapsed, 4),
        **extra,
    }


def bench_tracking(name, *, width, height, templ=80, num_frames=512,
                   chunk_size=128, backend="xla", strategy="fused",
                   radius=None, batch=None):
    """One stream through track_video (or track_video_batched)."""
    import jax

    from pvot.config import TrackerConfig
    from pvot.tracker.scan import track_video, track_video_batched

    config = TrackerConfig()
    if radius:
        config = TrackerConfig(search_radius_x=radius, search_radius_y=radius)
    spec, frames, state = _clip(width, height, templ, num_frames)
    if batch:
        clip = frames[1:]

        def run():
            return track_video_batched(
                clip, state, config, batch_size=batch, strategy=strategy,
                backend=backend,
                chunks_per_dispatch=max(1, chunk_size // batch),
            )[1]
    else:
        clip = jax.device_put(frames[1:])

        def run():
            return track_video(
                clip, state, config, strategy=strategy, backend=backend,
                chunk_size=chunk_size,
            )[1]

    out, elapsed = _time_run(run)
    fps = num_frames / elapsed
    r = radius or config.search_radius_x
    return _row(
        name, backend, fps, elapsed, num_frames,
        max_l1_err_px=_max_err(spec, out.bbox, batch or 1),
        peak_share_pct=_peak_share(fused_region_flops(templ, r) * fps, backend)
        if strategy == "fused" and not batch else None,
    )


def bench_multi_object(num_objects=8, width=1280, height=720, templ=80,
                       num_frames=256, chunk_size=64, backend="xla"):
    """K trackers over one stream: the true target plus fixed background
    patches, through track_video_multi."""
    from pvot.config import TrackerConfig
    from pvot.io.gray import gray_u8_to_f32
    from pvot.parallel.multi import init_multi_state, track_video_multi

    spec, frames, one = _clip(width, height, templ, num_frames)
    x, y, w, h = (int(v) for v in (one.bbox_x, one.bbox_y, one.bbox_w, one.bbox_h))
    g0 = gray_u8_to_f32(frames[0])
    rois = [(x, y, w, h)] + [
        (64 + 96 * i, 128 + 32 * (i % 3), w, h) for i in range(num_objects - 1)
    ]
    states = init_multi_state(
        [g0[ry : ry + h, rx : rx + w] for rx, ry, _, _ in rois], rois
    )
    config = TrackerConfig()

    def run():
        return track_video_multi(
            frames[1:], states, config, backend=backend, chunk_size=chunk_size
        )[1]

    out, elapsed = _time_run(run)
    fps = num_frames / elapsed
    return _row(
        f"multi_object_{num_objects}x_720p", backend, fps, elapsed,
        num_frames, unit="frames/s (all objects per frame)",
        object_rate=round(fps * num_objects, 1),
        max_l1_err_px=_max_err(spec, np.asarray(out.bbox)[:, :1]),
    )


def bench_multi_stream(num_streams=8, width=1280, height=720, templ=80,
                       num_frames=256, chunk_size=64, frames_per_step=1,
                       backend="xla"):
    """S independent streams in lockstep through the masked multi-stream
    scan (the serving step), staged on device.  frames_per_step > 1 runs
    the C10 batch cadence per stream (one update per N frames)."""
    import jax
    import jax.numpy as jnp

    from pvot.config import TrackerConfig
    from pvot.ops.backends import get_backend
    from pvot.parallel.multi import make_multi_stream_step
    from pvot.tracker.scan import (
        fetch_outputs,
        make_batch_step,
        make_masked_scan_fn,
    )
    from pvot.tracker.step import make_step

    config = TrackerConfig()
    n = frames_per_step
    total = num_frames * n
    spec, frames, one = _clip(width, height, templ, total)
    states = jax.tree.map(lambda a: jnp.stack([a] * num_streams), one)
    if n > 1:
        # (S, n, H, W) per scanned element: the C10 batch step, vmapped
        # over streams.
        full_fn, region_fn = get_backend(
            backend, (height, width), (templ, templ), config
        )
        one_step = make_step(
            (height, width), (templ, templ), config,
            ncc_full_fn=full_fn, ncc_region_fn=region_fn,
        )
        step = jax.vmap(make_batch_step(one_step, n))
        clip = frames[1 : 1 + total].reshape(num_frames, n, height, width)
    else:
        step = make_multi_stream_step(
            (height, width), (templ, templ), config, backend=backend
        )
        clip = frames[1 : 1 + total]
    scan_fn = make_masked_scan_fn(step)
    # Streams share pixel content (synthetic); layout (C, S, ...).
    staged = [
        jax.device_put(np.broadcast_to(
            clip[i : i + chunk_size, None],
            (chunk_size, num_streams, *clip.shape[1:]),
        ).copy())
        for i in range(0, num_frames, chunk_size)
    ]
    valid = jax.device_put(np.ones(chunk_size, bool))

    def run():
        st, outs = states, []
        for c in staged:
            st, out = scan_fn(st, c, valid)
            outs.append(out)
        dev = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
        return fetch_outputs(dev)

    out, elapsed = _time_run(run)
    fps = total / elapsed
    bbox = np.asarray(out.bbox)
    if n > 1:
        bbox = bbox.reshape(num_frames, num_streams, n, 4)
        bbox = bbox.transpose(0, 2, 1, 3).reshape(total, num_streams, 4)
    name = f"multi_stream_{num_streams}x_720p"
    if n > 1:
        name = f"multi_stream_{num_streams}x_batch{n}_720p"
    scored = num_frames / elapsed * num_streams
    return _row(
        name, backend, fps, elapsed, total,
        unit="frames/s per stream (lockstep)",
        aggregate_fps=round(fps * num_streams, 1),
        peak_share_pct=_peak_share(
            fused_region_flops(templ, 60) * scored, backend
        ),
        max_l1_err_px=_max_err(spec, bbox, n),
    )


def bench_stream_sweep(sizes=(8, 16, 32, 64), backend="xla"):
    """Aggregate FPS and peak share as the lockstep stream count grows;
    frame counts shrink with S to bound the staged clip."""
    plans = {8: (256, 64), 16: (128, 32), 32: (128, 16), 64: (64, 8)}
    return [
        bench_multi_stream(
            s, num_frames=plans.get(s, (64, 8))[0],
            chunk_size=plans.get(s, (64, 8))[1], backend=backend,
        )
        for s in sizes
    ]


def _serving_feeds(plans):
    """Per-stream host clips for live-path rows: plans of (streams, width,
    height, templ, frames)."""
    import itertools

    import jax.numpy as jnp

    from pvot.io.gray import gray_u8_to_f32
    from pvot.io.synthetic import SyntheticSpec, generate_gray_frames, target_bbox
    from pvot.tracker.state import init_state

    streams = []
    for (S, wd, ht, tp, nf) in plans:
        # The sinusoid spans 257 frames however few are served, so
        # per-frame motion stays inside the search radius.
        spec = SyntheticSpec(
            width=wd, height=ht, num_frames=max(257, nf + 1),
            target_w=tp, target_h=tp, seed=1,
        )
        base = np.stack(list(itertools.islice(generate_gray_frames(spec), nf + 1)))
        x, y, w, h = target_bbox(spec, 0)
        state = init_state(
            jnp.asarray(gray_u8_to_f32(base[0])[y : y + h, x : x + w]),
            (x, y, w, h),
        )
        streams += [(spec, base, state)] * S
    return streams


def bench_serving_e2e(num_streams=16, width=1280, height=720, templ=80,
                      num_frames=256, chunk_size=32, backend="xla"):
    """END-TO-END serving on pvot.serve_streams: per-stream decode feeds,
    chunk upload, the multi-stream scan and the per-chunk record fetches
    are all inside the timed region."""
    import jax
    import jax.numpy as jnp

    from pvot.config import TrackerConfig
    from pvot.io.serving import serve_streams

    config = TrackerConfig()
    streams = _serving_feeds([(num_streams, width, height, templ, num_frames)])
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *[s[2] for s in streams])

    def run():
        return serve_streams(
            [iter(b[1:]) for _, b, _ in streams], states, (height, width),
            config, backend=backend, chunk_size=chunk_size,
        )[1]

    outs, elapsed = _time_run(run)
    spec = streams[0][0]
    total = num_streams * num_frames
    return _row(
        f"serving_e2e_{num_streams}x_720p", backend, num_frames / elapsed,
        elapsed, num_frames,
        unit="frames/s per stream (end-to-end: decode+upload+track+fetch)",
        aggregate_fps=round(total / elapsed, 1),
        max_l1_err_px=max(_max_err(spec, o.bbox) for o in outs),
    )


def bench_hetero_serving(backend="xla"):
    """Mixed-geometry serving: 8 x 720p/t80 and 4 x 1080p/t64 streams
    through pvot.serve_streams_grouped end to end (one scan per geometry
    group per chunk, groups in concurrent host threads)."""
    from pvot.config import TrackerConfig
    from pvot.io.serving import serve_streams_grouped

    config = TrackerConfig()
    streams = _serving_feeds([(8, 1280, 720, 80, 96), (4, 1920, 1080, 64, 96)])
    shapes = [b.shape[1:] for _, b, _ in streams]

    def run():
        return serve_streams_grouped(
            [iter(b[1:]) for _, b, _ in streams], [s for _, _, s in streams],
            shapes, config, backend=backend, chunk_size=32,
        )[1]

    outs, elapsed = _time_run(run)
    total = sum(len(o.bbox) for o in outs)
    agg = total / elapsed
    return _row(
        "hetero_serving_720p_1080p", backend, agg / len(streams), elapsed,
        total, unit=f"frames/s per stream ({len(streams)} mixed streams)",
        aggregate_fps=round(agg, 1),
        max_l1_err_px=max(
            _max_err(spec, o.bbox) for (spec, _, _), o in zip(streams, outs)
        ),
    )


def bench_mode_comparison(frames=512):
    """One row per reference mode flag at one geometry — the analog of the
    reference README's kernel comparison table (README.md:128-137).
    --shared/--const/--const_tiled alias the cuda row's engine
    (pvot.ops.backends), so they add no row."""
    return [
        bench_tracking(
            "mode_cpu_720p", width=1280, height=720, backend="cpu",
            strategy="full", num_frames=min(frames, 256), chunk_size=64,
        ),
        bench_tracking(
            "mode_cuda_720p", width=1280, height=720, backend="xla",
            num_frames=frames, chunk_size=min(frames, 128),
        ),
        bench_tracking(
            "mode_fast_720p", width=1280, height=720, backend="fast",
            num_frames=frames, chunk_size=min(frames, 128),
        ),
    ]


def bench_occlusion(periods=(0, 256, 128, 64), *, width=1280, height=720,
                    templ=80, num_frames=1024, chunk_size=64,
                    occlusion_len=24, lost_threshold=10, backend="xla"):
    """The target leaves the frame for `occlusion_len` frames at the end of
    every `period`-frame window, driving lost -> global search ->
    re-acquire repeatedly; period 0 is the clean clip.  During an occlusion
    there is no ground truth, so rows report global-search frames."""
    import jax

    from pvot.config import TrackerConfig
    from pvot.tracker.scan import track_video

    config = TrackerConfig(lost_frame_threshold=lost_threshold)
    out = []
    for period in periods:
        spec, frames, state = _clip(
            width, height, templ, num_frames, occlusion_period=period,
            occlusion_len=occlusion_len if period else 0,
        )
        clip = jax.device_put(frames[1:])

        def run():
            return track_video(
                clip, state, config, backend=backend, chunk_size=chunk_size
            )[1]

        res, elapsed = _time_run(run)
        out.append(_row(
            f"occl_p{period}_720p" if period else "occl_clean_720p",
            backend, num_frames / elapsed, elapsed, num_frames,
            global_frames=int(np.asarray(res.used_global).sum()),
            occlusion_period=period,
        ))
        print(json.dumps(out[-1]), flush=True)
    return out


def bench_occlusion_serving(num_streams=8, stagger=True, *, width=1280,
                            height=720, templ=80, num_frames=192,
                            chunk_size=32, period=64, occ_len=12,
                            lost_threshold=10, backend="xla"):
    """Occlusion-heavy multi-stream serving: per-stream occlusion cycles of
    `period` frames with `occ_len` occluded frames; stagger=True offsets each
    stream's phase, stagger=False occludes all streams at once (under vmap
    the global branch runs for every stream once any stream needs it)."""
    import jax
    import jax.numpy as jnp

    from pvot.config import TrackerConfig
    from pvot.parallel.multi import make_multi_stream_step
    from pvot.tracker.scan import fetch_outputs, make_masked_scan_fn

    config = TrackerConfig(lost_frame_threshold=lost_threshold)
    clips = [
        _clip(
            width, height, templ, num_frames, seed=1 + s,
            occlusion_period=period, occlusion_len=occ_len,
            occlusion_phase=(
                (s * (period - occ_len)) // num_streams if stagger else 0
            ),
        )
        for s in range(num_streams)
    ]
    videos = np.stack([f for _, f, _ in clips], axis=1)  # (F+1, S, H, W)
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *[c[2] for c in clips])
    step = make_multi_stream_step(
        (height, width), (templ, templ), config, backend=backend
    )
    scan_fn = make_masked_scan_fn(step)
    staged = [
        jax.device_put(videos[1 + i : 1 + i + chunk_size])
        for i in range(0, num_frames, chunk_size)
    ]
    valid = jax.device_put(np.ones(chunk_size, bool))

    def run():
        st, outs = states, []
        for c in staged:
            st, out = scan_fn(st, c, valid)
            outs.append(out)
        return fetch_outputs(
            jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
        )

    out, elapsed = _time_run(run)
    total = num_streams * num_frames
    row = _row(
        f"occl_serving_{num_streams}x_p{period}_"
        + ("staggered" if stagger else "simultaneous"),
        backend, num_frames / elapsed, elapsed, num_frames,
        unit="frames/s per stream (lockstep)",
        aggregate_fps=round(total / elapsed, 1),
        global_frames=int(np.asarray(out.used_global).sum()),
        occlusion_period=period, stagger=stagger,
    )
    assert row["global_frames"] > 0, "fixture never searched globally"
    return row


def bench_headline_median(runs=3):
    """Run bench.py in `runs` fresh processes, one after another, and record
    the median with min and max (every run checks its own trajectory)."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    recs = []
    for i in range(runs):
        r = subprocess.run(
            [sys.executable, os.path.join(repo, "bench.py")],
            capture_output=True, text=True, cwd=repo, check=True,
        )
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        if rec["max_l1_err_px"] > 2:
            raise AssertionError(f"headline run {i} trajectory error: {rec}")
        recs.append(rec)
    vals = sorted(r["value"] for r in recs)
    return {
        "config": "headline_median_720p",
        "backend": recs[0]["backend"],
        "value": statistics.median(vals),
        "unit": "frames/s",
        "runs": vals,
        "protocol": f"median of {runs} fresh bench.py processes",
    }


CONFIGS = {
    "1": lambda frames: bench_tracking(
        "cpu_parity_720p", width=1280, height=720, backend="cpu",
        strategy="full", num_frames=min(frames, 256), chunk_size=64,
    ),
    "2": lambda frames: bench_tracking(
        "fused_720p_80px", width=1280, height=720, num_frames=frames,
    ),
    "3": lambda frames: [
        bench_tracking(
            f"batch_{n}_720p", width=1280, height=720,
            num_frames=min(frames, 512), chunk_size=min(frames, 512) // 2,
            batch=n,
        )
        for n in (4, 8, 16, 32)
    ],
    # r160 rows are pvot extensions (the reference never ran 1080p/4K).
    "4": lambda frames: [
        bench_tracking("1080p_r160", width=1920, height=1080, radius=160,
                       num_frames=min(frames, 256), chunk_size=64),
        bench_tracking("4k_r160", width=3840, height=2160, radius=160,
                       num_frames=min(frames, 128), chunk_size=32),
    ],
    "4f": lambda frames: [
        bench_tracking("1080p_r160_fast", width=1920, height=1080, radius=160,
                       num_frames=min(frames, 256), chunk_size=64,
                       backend="fast"),
        bench_tracking("4k_r160_fast", width=3840, height=2160, radius=160,
                       num_frames=min(frames, 128), chunk_size=32,
                       backend="fast"),
    ],
    "4t": lambda frames: [
        bench_tracking("1080p_t160_r160", width=1920, height=1080, templ=160,
                       radius=160, num_frames=min(frames, 256), chunk_size=64),
        bench_tracking("1080p_t160_r160_fast", width=1920, height=1080,
                       templ=160, radius=160, num_frames=min(frames, 256),
                       chunk_size=64, backend="fast"),
    ],
    "5": lambda frames: bench_multi_object(),
    "6": lambda frames: bench_multi_stream(),
    "7a": lambda frames: bench_stream_sweep(sizes=(8,)),
    "7b": lambda frames: bench_stream_sweep(sizes=(16,)),
    "7c": lambda frames: bench_stream_sweep(sizes=(32,)),
    "7d": lambda frames: bench_stream_sweep(sizes=(64,)),
    "7h": lambda frames: bench_hetero_serving(),
    "7me": lambda frames: bench_serving_e2e(),
    "8": lambda frames: bench_multi_stream(
        32, num_frames=32, chunk_size=16, frames_per_step=4
    ),
    "10": lambda frames: bench_mode_comparison(frames),
    "12": lambda frames: bench_occlusion(),
    "12m8s": lambda frames: bench_occlusion_serving(8, stagger=True),
    "12m8c": lambda frames: bench_occlusion_serving(8, stagger=False),
    "12m32s": lambda frames: bench_occlusion_serving(
        32, stagger=True, num_frames=48, chunk_size=16, period=32,
        occ_len=8, lost_threshold=6,
    ),
    "12m32c": lambda frames: bench_occlusion_serving(
        32, stagger=False, num_frames=48, chunk_size=16, period=32,
        occ_len=8, lost_threshold=6,
    ),
    "13": lambda frames: bench_headline_median(),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5,6,7a,7b,7c,7d,8,10")
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument(
        "--out",
        default=os.path.join(os.path.dirname(__file__), "results.json"),
    )
    args = ap.parse_args()
    from pvot.utils.device import card_name_and_power_limit, require_gpu
    from pvot.utils.jaxcache import enable_compilation_cache

    require_gpu("benchmarks/suite.py")

    enable_compilation_cache()
    info = device_info()
    results, succeeded, failed = [], set(), False
    for key in (k.strip() for k in args.configs.split(",")):
        try:
            got = CONFIGS[key](args.frames)
        except Exception as e:  # one config's failure must not hide the rest
            failed = True
            results.append({"config": f"<config {key}>", "error": repr(e)})
            print(json.dumps(results[-1]), flush=True)
            continue
        for rec in got if isinstance(got, list) else [got]:
            rec.update(platform=info["platform"],
                       device_kind=info["device_kind"],
                       device_count=info["device_count"])
            print(json.dumps(rec), flush=True)
            results.append(rec)
        succeeded.add(key)
    results.append({"_meta": {**info, "card": card_name_and_power_limit()}})
    results = merge_results(args.out, results, succeeded)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    if failed:
        raise SystemExit(1)


def merge_results(path: str, new: list, succeeded=()) -> list:
    """Merge a (possibly partial) run into an existing results file.

    Records are keyed by (config, backend): a re-run config replaces its
    old row IN PLACE (table order is stable), novel configs append before
    the _meta row.  A partial `--configs 7d` run therefore refreshes one
    row instead of clobbering the whole results file.

    `succeeded` is the set of config KEYS that completed this run: any
    fossil "<config K>" error row for those keys is dropped (a failed
    run's error row is keyed by the suite key, a successful re-run's
    rows by real config names, so replacement alone never cleans them)."""
    try:
        with open(path) as f:
            merged = json.load(f)
    except (OSError, ValueError):
        return new
    stale = {f"<config {k}>" for k in succeeded}
    merged = [r for r in merged if r.get("config") not in stale]
    key = lambda r: (r.get("config"), r.get("backend"))  # noqa: E731
    # Drop stale same-key duplicates first (replacement only ever hits the
    # first, so a second would fossilize).
    seen = set()
    deduped = []
    for r in merged:
        if "_meta" in r:
            deduped.append(r)
            continue
        if key(r) in seen:
            continue
        seen.add(key(r))
        deduped.append(r)
    merged = deduped
    for rec in new:
        if "_meta" in rec:
            merged = [r for r in merged if "_meta" not in r] + [rec]
            continue
        for i, old in enumerate(merged):
            if "_meta" not in old and key(old) == key(rec):
                merged[i] = rec
                break
        else:
            metas = [r for r in merged if "_meta" in r]
            rows = [r for r in merged if "_meta" not in r]
            merged = rows + [rec] + metas
    return merged


if __name__ == "__main__":
    main()
