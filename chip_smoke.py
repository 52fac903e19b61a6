"""Smoke test of pvot on one NVIDIA GPU, or on four with --four-cards.

    python chip_smoke.py               # one card: phases 0-6
    python chip_smoke.py --four-cards  # four cards: the multi-device paths

One process drives everything through the entry points a user calls
(pvot.cli.main.main, pvot.cli.serve.main, pvot.track_video,
pvot.serve_streams / serve_objects / serve_streams_grouped) at the
geometry of a camera deployment: 1280x720 uint8 video, an 80x80 template,
search radius 60.  Each phase compares what the GPU computed with a plain
reference and raises on a mismatch, so any failure exits nonzero and the
JSON result line is printed only when every phase passed.  With no GPU it
exits nonzero before printing anything but the reason.

Phases (one card):
  0  device check: platform, card name and power limit, native library
  1  the XLA engine vs the conv oracle and a float64 NumPy transcription
  2  the pvot CLI (default and --fast engines) vs ground truth and the host
     engine (pvot.models.host, independent of XLA)
  3  global re-acquisition (the 128-row strip full map) vs the host engine
  4  --batch=4 through the CLI vs track_video_batched
  5  serving: pvot-serve S=8, serve_streams with unequal lengths,
     serve_objects with two template sizes, serve_streams_grouped 720p+1080p
  6  informational per-frame time of track_video (not a claim)
Phases (--four-cards):
  7  S=8 streams fanned over 4 cards vs the one-card serve
  8  track_video_sharded on a (1, 4) mesh vs the unsharded step
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# The geometry of every phase (a camera deployment's, see the docstring).
W, H, T, R = 1280, 720, 80, 60
# |score| agreement of two float32 engines with the float32 conv oracle and
# a float64 transcription: the oracle tests' own bound (f32 accumulation
# order over 6400-term windows).
SCORE_TOL = 1e-5
# Scores of global-search frames: the full-frame float32 integral images
# lose digits on the low-contrast windows a lost target leaves, so two
# correct paths that sum over other extents (the host engine's double sums,
# the sharded search's per-device strips) differ there by up to 9e-5 on an
# H100 (measured).  bbox and flag equality is the contract on every frame.
GLOBAL_TOL = 2e-4
# A served trajectory vs its own track_video: the vmapped step batches the
# matmuls differently (f32 reassociation), plus the trajectory file's
# 6-digit scores.
SERVE_TOL = 3e-5
# Trackers must stay on the synthetic target (reference-parity tolerance).
GT_TOL_PX = 2


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _clip(num_frames, width=W, height=H, templ=T, spec_len=None, **kw):
    """(spec, gray frames (F+1, H, W) uint8, initial TrackerState).  The
    target's path spans spec_len frames (default F+1), so a short clip cut
    from a long path moves slowly."""
    import itertools

    import jax.numpy as jnp

    from pvot.io.gray import gray_u8_to_f32
    from pvot.io.synthetic import SyntheticSpec, generate_gray_frames, target_bbox
    from pvot.tracker.state import init_state

    spec = SyntheticSpec(width=width, height=height,
                         num_frames=spec_len or num_frames + 1,
                         target_w=templ, target_h=templ, **kw)
    frames = np.stack(list(itertools.islice(generate_gray_frames(spec),
                                            num_frames + 1)))
    x, y, w, h = target_bbox(spec, 0)
    state = init_state(
        jnp.asarray(gray_u8_to_f32(frames[0])[y : y + h, x : x + w]),
        (x, y, w, h),
    )
    return spec, frames, state


def _gt_err(spec, bbox, first=1) -> int:
    from pvot.io.synthetic import target_bbox

    truth = np.array([target_bbox(spec, first + i)[:2] for i in range(len(bbox))])
    return int(np.abs(np.asarray(bbox)[:, :2] - truth).sum(axis=1).max())


def _same_track(a, b, what: str, score_tol: float = SCORE_TOL):
    """bbox and flags equal; scores within score_tol on local-search frames
    and GLOBAL_TOL on global-search ones.  Returns the two max |dscore|."""
    for field in ("bbox", "used_global", "updated"):
        _check(np.array_equal(np.asarray(getattr(a, field)),
                              np.asarray(getattr(b, field))),
               f"{what}: {field} differs")
    d = np.abs(np.asarray(a.score) - np.asarray(b.score))
    g = np.asarray(a.used_global, bool)
    d_local = float(np.max(d[~g], initial=0.0))
    d_global = float(np.max(d[g], initial=0.0))
    _check(d_local <= score_tol,
           f"{what}: local-search |dscore| {d_local} > {score_tol}")
    _check(d_global <= GLOBAL_TOL,
           f"{what}: global-search |dscore| {d_global} > {GLOBAL_TOL}")
    return d_local, d_global


def _dscore(d, tol: float = SCORE_TOL) -> str:
    return (f"max|dscore| local {d[0]:.3e} (tol {tol:g}), global "
            f"{d[1]:.3e} (tol {GLOBAL_TOL:g})")


def _read_trajectory(path):
    from pvot.tracker.state import StepOutput

    recs = [json.loads(line) for line in open(path)]
    return StepOutput(
        bbox=np.array([r["bbox"] for r in recs], np.int32),
        score=np.array([r["score"] for r in recs], np.float32),
        used_global=np.array([r["used_global"] for r in recs]),
        updated=np.array([r["updated"] for r in recs]),
    )


def _host_track(frames, state, config):
    """pvot.models.host (native C++ NCC, no XLA) as a StepOutput."""
    from pvot.models.host import track_video_host
    from pvot.tracker.state import StepOutput

    roi = tuple(int(v) for v in (state.bbox_x, state.bbox_y,
                                 state.bbox_w, state.bbox_h))
    _, out = track_video_host(frames, np.asarray(state.template), roi, config)
    return StepOutput(**out)


# --------------------------------------------------------------------------
def phase_engine_vs_reference(width=W, height=H, templ=T, radius=R, seed=0):
    """The "xla" engine's full map and candidate window vs the conv oracle
    (Precision.HIGHEST) on the device, and vs float64 NumPy on a crop."""
    import jax
    import jax.numpy as jnp

    from pvot.ops import ncc_matmul
    from pvot.ops.backends import ENGINE_PRECISION, get_backend
    from pvot.ops.ncc_reference import ncc_map_reference, template_stats
    from pvot.config import TrackerConfig

    rng = np.random.default_rng(seed)
    frame = jnp.asarray(rng.random((height, width), dtype=np.float32))
    tmpl = jnp.asarray(rng.random((templ, templ), dtype=np.float32))
    t_mean, t_std = template_stats(tmpl)
    config = TrackerConfig(search_radius_x=radius, search_radius_y=radius)
    full_fn, region_fn = get_backend("xla", (height, width), (templ, templ), config)
    span = 2 * radius + 1
    x0, y0 = (width - templ - span) // 2, (height - templ - span) // 2

    got_full = np.asarray(jax.jit(full_fn)(frame, tmpl, t_mean, t_std))
    want_full = np.asarray(jax.jit(ncc_map_reference)(frame, tmpl, t_mean, t_std))
    e_full = float(np.max(np.abs(got_full - want_full)))
    got_reg = np.asarray(jax.jit(region_fn)(frame, tmpl, t_mean, t_std,
                                            jnp.int32(x0), jnp.int32(y0)))
    e_reg = float(np.max(np.abs(got_reg - want_full[y0 : y0 + span, x0 : x0 + span])))

    # float64 transcription of the reference kernel on the window's crop.
    f64 = np.asarray(frame, np.float64)[y0 : y0 + span + templ - 1,
                                        x0 : x0 + span + templ - 1]
    t64 = np.asarray(tmpl, np.float64)
    win = np.lib.stride_tricks.sliding_window_view(f64, (templ, templ))
    n = templ * templ
    mu = win.mean(axis=(2, 3))
    sd = np.sqrt(np.maximum((win * win).mean(axis=(2, 3)) - mu * mu, 1e-6))
    cov = np.einsum("yxij,ij->yx", win, t64 - t64.mean())
    t_sd = t64.std() + 1e-6
    ref64 = cov / ((sd + 1e-6) * (t_sd + 1e-6) * n)
    e_64 = float(np.max(np.abs(got_reg - ref64)))
    fast_reg = np.asarray(jax.jit(ncc_matmul.make_region_fn(
        span, span, precision=jax.lax.Precision.HIGH
    ))(frame, tmpl, t_mean, t_std, jnp.int32(x0), jnp.int32(y0)))
    e_fast = float(np.max(np.abs(fast_reg - ref64)))

    print(f"  xla engine ({ENGINE_PRECISION['xla']}) full map {got_full.shape} "
          f"vs conv oracle (HIGHEST): max|d|={e_full:.3e} tol={SCORE_TOL:g}")
    print(f"  xla engine window {got_reg.shape} vs conv oracle: "
          f"max|d|={e_reg:.3e} tol={SCORE_TOL:g}")
    print(f"  xla engine window vs float64 NumPy: max|d|={e_64:.3e} "
          f"tol={SCORE_TOL:g}")
    print(f"  xla_fast engine ({ENGINE_PRECISION['xla_fast']}) window vs "
          f"float64 NumPy: max|d|={e_fast:.3e} (informational)")
    _check(e_full <= SCORE_TOL, f"full map off the oracle by {e_full}")
    _check(e_reg <= SCORE_TOL, f"window off the oracle by {e_reg}")
    _check(e_64 <= SCORE_TOL, f"window off float64 by {e_64}")


def phase_cli(num_frames=300, width=W, height=H, workdir=None):
    """pvot CLI, default engine and --fast, vs ground truth; the default
    engine also bbox- and flag-exact vs the host engine."""
    from pvot.cli.main import main as pvot_main
    from pvot.config import TrackerConfig
    from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox

    spec = SyntheticSpec(width=width, height=height, num_frames=num_frames + 1)
    x, y, w, h = target_bbox(spec, 0)
    outs = {}
    for flag in ("", "--fast"):
        path = os.path.join(workdir, f"traj{flag or '_default'}.jsonl")
        argv = ["--synthetic", f"{width}x{height}x{num_frames + 1}", "--first",
                "--roi", f"{x},{y},{w},{h}", "--no-display",
                "--trajectory-out", path] + ([flag] if flag else [])
        _check(pvot_main(argv) == 0, f"pvot {' '.join(argv)} failed")
        outs[flag] = _read_trajectory(path)
        err = _gt_err(spec, outs[flag].bbox)
        print(f"  pvot {flag or '(default)'}: {len(outs[flag].bbox)} frames, "
              f"max L1 error vs ground truth {err} px (tol {GT_TOL_PX})")
        _check(err <= GT_TOL_PX, f"pvot {flag}: off the target by {err} px")
    frames = generate_gray_video(spec)
    state = _clip_state(frames, (x, y, w, h))
    host = _host_track(frames[1:], state, TrackerConfig())
    d = _same_track(outs[""], host, "pvot vs host engine")
    print(f"  pvot (default) vs host engine: bbox/flags equal, "
          + _dscore(d))


def _clip_state(frames, roi):
    import jax.numpy as jnp

    from pvot.io.gray import gray_u8_to_f32
    from pvot.tracker.state import init_state

    x, y, w, h = roi
    return init_state(
        jnp.asarray(gray_u8_to_f32(frames[0])[y : y + h, x : x + w]), roi
    )


def phase_global(num_frames=48, width=W, height=H):
    """Exit-and-reenter clip, lost threshold 2: the full-map strips run on
    the device; trajectory equal to the host engine's."""
    from pvot.config import TrackerConfig
    from pvot.tracker.scan import track_video

    config = TrackerConfig(lost_frame_threshold=2)
    spec, frames, state = _clip(num_frames, width, height,
                                exit_and_reenter=True, seed=3)
    _, dev = track_video(frames[1:], state, config)
    host = _host_track(frames[1:], state, config)
    n_global = int(np.asarray(dev.used_global).sum())
    _check(n_global > 0, "the clip never searched globally")
    d = _same_track(dev, host, "global re-acquisition vs host engine")
    print(f"  {n_global} global-search frames of {num_frames}; bbox/flags "
          f"equal to the host engine, " + _dscore(d))


def phase_batch(num_frames=300, width=W, height=H, workdir=None):
    """--batch=4 through the CLI vs track_video_batched."""
    from pvot.cli.main import main as pvot_main
    from pvot.config import TrackerConfig
    from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
    from pvot.tracker.scan import track_video_batched

    spec = SyntheticSpec(width=width, height=height, num_frames=num_frames + 1)
    x, y, w, h = target_bbox(spec, 0)
    path = os.path.join(workdir, "traj_batch.jsonl")
    _check(pvot_main(["--synthetic", f"{width}x{height}x{num_frames + 1}",
                      "--first", "--roi", f"{x},{y},{w},{h}", "--batch=4",
                      "--no-display", "--trajectory-out", path]) == 0,
           "pvot --batch=4 failed")
    got = _read_trajectory(path)
    frames = generate_gray_video(spec)
    state = _clip_state(frames, (x, y, w, h))
    _, want = track_video_batched(frames[1:], state, TrackerConfig(batch_size=4),
                                  batch_size=4)
    # Same engine and program: scores differ only by the file's rounding.
    d = _same_track(got, want, "pvot --batch=4 vs track_video_batched",
                    score_tol=1e-6)
    print(f"  pvot --batch=4: {len(got.bbox)} frames equal to "
          f"track_video_batched, " + _dscore(d, 1e-6))


def phase_serving(num_frames=150, width=W, height=H, templ=T, workdir=None):
    """pvot-serve S=8, serve_streams (unequal lengths), serve_objects (two
    template sizes) and serve_streams_grouped (720p + 1080p), each stream or
    object bbox-equal to its own track_video."""
    import jax
    import jax.numpy as jnp

    from pvot.cli.serve import main as serve_main
    from pvot.config import TrackerConfig
    from pvot.io.gray import gray_u8_to_f32
    from pvot.io.serving import serve_objects, serve_streams, serve_streams_grouped
    from pvot.parallel.multi import init_multi_state_bucketed
    from pvot.tracker.scan import track_video
    from pvot.tracker.state import init_state

    config = TrackerConfig()
    # pvot-serve: 8 synthetic streams (seeds 1..8), per-stream trajectories.
    prefix = os.path.join(workdir, "serve")
    _check(serve_main(["--synthetic", f"{width}x{height}x{num_frames + 1}",
                       "--streams", "8", "--trajectory-out", prefix]) == 0,
           "pvot-serve failed")
    for s in range(8):  # pvot-serve's synthetic streams: 80x80 targets
        spec, frames, state = _clip(num_frames, width, height, 80, seed=1 + s)
        _, want = track_video(frames[1:], state, config)
        _same_track(_read_trajectory(f"{prefix}.s{s}.jsonl"), want,
                    f"pvot-serve stream {s}", score_tol=SERVE_TOL)
        _check(_gt_err(spec, want.bbox) <= GT_TOL_PX, f"stream {s} lost")
    print(f"  pvot-serve: 8 x {width}x{height} streams equal to track_video")

    # serve_streams with unequal lengths.
    lengths = [num_frames - s * num_frames // 10 for s in range(8)]
    clips = [_clip(n, width, height, templ, spec_len=num_frames + 1,
                   seed=20 + s) for s, n in enumerate(lengths)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[c[2] for c in clips])
    _, outs = serve_streams([iter(c[1][1:]) for c in clips], stacked,
                            (height, width), config)
    for s, (spec, frames, state) in enumerate(clips):
        _check(len(outs[s].bbox) == lengths[s], f"stream {s} length")
        _, want = track_video(frames[1:], state, config)
        _same_track(outs[s], want, f"serve_streams stream {s}",
                    score_tol=SERVE_TOL)
    print(f"  serve_streams: 8 streams of lengths {lengths} equal to "
          "track_video")

    # serve_objects: the moving target plus 7 static textured patches above
    # its path, 48x48 and 80x80 (mixed sizes: the bucketed layout).
    spec, frames, target = _clip(num_frames, width, height, templ, seed=40)
    rng = np.random.default_rng(41)
    rois = [tuple(int(v) for v in (target.bbox_x, target.bbox_y, templ, templ))]
    for k in range(7):
        t = 48 if k % 2 else templ
        x, y = 8 + k * (width - templ - 16) // 7, 8
        frames[:, y : y + t, x : x + t] = rng.integers(0, 256, (t, t), np.uint8)
        rois.append((x, y, t, t))
    g0 = gray_u8_to_f32(frames[0])
    templs = [g0[y : y + h, x : x + w] for x, y, w, h in rois]
    states = init_multi_state_bucketed(templs, rois)
    _, out = serve_objects(iter(frames[1:]), states, (height, width), config)
    for k, roi in enumerate(rois):
        _, want = track_video(frames[1:], init_state(jnp.asarray(templs[k]), roi),
                              config)
        np.testing.assert_array_equal(out.bbox[:, k], want.bbox,
                                      err_msg=f"serve_objects object {k}")
    print("  serve_objects: 8 objects (48x48 and 80x80 templates) bbox-equal "
          "to track_video")

    # serve_streams_grouped: a 720p group and a 1080p group.
    geoms = [(width, height, templ)] * 2 + [(1920, 1080, 64)] * 2
    clips = [_clip(num_frames // 2, w_, h_, t_, seed=60 + s)
             for s, (w_, h_, t_) in enumerate(geoms)]
    _, outs = serve_streams_grouped(
        [iter(c[1][1:]) for c in clips], [c[2] for c in clips],
        [(h_, w_) for w_, h_, _ in geoms], config,
    )
    for s, (spec, frames, state) in enumerate(clips):
        _, want = track_video(frames[1:], state, config)
        np.testing.assert_array_equal(outs[s].bbox, want.bbox,
                                      err_msg=f"grouped stream {s}")
    print("  serve_streams_grouped: 2 x 720p/t80 + 2 x 1080p/t64 bbox-equal "
          "to track_video")


def phase_timing(num_frames=1024, width=W, height=H):
    """Per-frame wall time of track_video on a staged clip after warm-up,
    each pass ended by block_until_ready.  Informational, not a claim."""
    import jax

    from pvot.config import TrackerConfig
    from pvot.tracker.scan import track_video

    spec, frames, state = _clip(num_frames, width, height, seed=1)
    clip = jax.block_until_ready(jax.device_put(frames[1:]))
    config = TrackerConfig()
    times = []
    for i in range(4):
        t0 = time.perf_counter()
        final, out = track_video(clip, state, config, chunk_size=256)
        jax.block_until_ready(final)
        times.append(time.perf_counter() - t0)
    _check(_gt_err(spec, out.bbox) <= GT_TOL_PX, "timed clip lost the target")
    us = sorted(t / num_frames * 1e6 for t in times[1:])
    print(f"  track_video {width}x{height}/t{T}/r{R}, {num_frames} frames, "
          f"chunk 256: first pass (compile) {times[0]:.2f} s; per-frame "
          f"us over 3 warm passes: {', '.join(f'{u:.2f}' for u in us)}")


def phase_fanout(num_frames=150, width=W, height=H, n_devices=4):
    """S=8 streams over n_devices vs the one-device serve: bit-identical."""
    import jax
    import jax.numpy as jnp

    from pvot.config import TrackerConfig
    from pvot.io.serving import serve_streams

    config = TrackerConfig()
    clips = [_clip(num_frames - s * num_frames // 10, width, height,
                   spec_len=num_frames + 1, seed=80 + s) for s in range(8)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[c[2] for c in clips])
    _, one = serve_streams([iter(c[1][1:]) for c in clips], stacked,
                           (height, width), config)
    _, many = serve_streams([iter(c[1][1:]) for c in clips], stacked,
                            (height, width), config,
                            devices=jax.devices()[:n_devices])
    for s, (spec, _, _) in enumerate(clips):
        _same_track(one[s], many[s], f"fan-out stream {s}", score_tol=0.0)
        _check(np.array_equal(one[s].score, many[s].score),
               f"fan-out stream {s}: scores differ")
        _check(_gt_err(spec, many[s].bbox) <= GT_TOL_PX, f"stream {s} lost")
    print(f"  8 streams over {n_devices} devices equal to the one-device serve")


def phase_sharded(num_frames=48, width=W, height=H, n_devices=4):
    """track_video_sharded on a (1, n_devices) mesh vs the unsharded step on
    an exit-and-reenter clip: bboxes and flags exact (row-major ties across
    shards), scores within SCORE_TOL."""
    import jax
    from jax.sharding import Mesh

    from pvot.config import TrackerConfig
    from pvot.parallel.sharded import track_video_sharded
    from pvot.tracker.scan import track_video

    config = TrackerConfig(lost_frame_threshold=2)
    spec, frames, state = _clip(num_frames, width, height,
                                exit_and_reenter=True, seed=3)
    mesh = Mesh(np.array(jax.devices()[:n_devices]).reshape(1, n_devices),
                ("data", "search"))
    states = jax.tree.map(lambda a: a[None], state)
    _, got = track_video_sharded(frames[None, 1:], states, mesh, config)
    _, want = track_video(frames[1:], state, config)
    got = type(want)(*(np.asarray(a)[:, 0] for a in got))
    _check(np.asarray(want.used_global).any(), "the clip never went global")
    d = _same_track(got, want, "sharded vs unsharded")
    print(f"  (1, {n_devices}) mesh: {num_frames} frames "
          f"({int(np.asarray(want.used_global).sum())} global) equal to the "
          f"unsharded step, " + _dscore(d))


ONE_CARD = [
    ("1 engine vs reference", lambda wd: phase_engine_vs_reference()),
    ("2 pvot CLI", lambda wd: phase_cli(workdir=wd)),
    ("3 global re-acquisition", lambda wd: phase_global()),
    ("4 --batch=4", lambda wd: phase_batch(workdir=wd)),
    ("5 serving", lambda wd: phase_serving(workdir=wd)),
    ("6 timing (informational)", lambda wd: phase_timing()),
]
FOUR_CARDS = [
    ("7 fan-out over 4 cards", lambda wd: phase_fanout()),
    ("8 sharded (1, 4) mesh", lambda wd: phase_sharded()),
]


def build_native() -> None:
    """Rebuild libpvot.so from libpvot.cpp for this host's CPU."""
    subprocess.run(["make", "-B", "-s", "-C",
                    os.path.join(REPO, "pvot", "runtime")],
                   check=True, timeout=300)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax

    from pvot.utils.device import card_name_and_power_limit, require_gpu

    device = require_gpu("chip_smoke.py")
    want = 4 if args.four_cards else 1
    _check(device["count"] >= want, f"needs {want} GPUs, found {device['count']}")
    build_native()
    from pvot.runtime import native
    from pvot.utils.jaxcache import enable_compilation_cache

    print("== phase 0 device")
    print(card_name_and_power_limit())
    print(f"  jax {jax.__version__}, {device['count']} x {device['kind']}, "
          f"libpvot.so loaded: {native.available()}, compile cache "
          f"{enable_compilation_cache()}")
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".smoke_") as wd:
        for name, phase in FOUR_CARDS if args.four_cards else ONE_CARD:
            t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)
            phase(wd)
            print(f"   ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
