"""pvot-serve: track S video streams concurrently on one device.

The reference serves exactly one stream per process — its tracking loop
owns the single cv::VideoCapture (tracker_ghc/src/main.cpp:83,337-480) —
so S cameras there cost S processes.  This front end drives
pvot.io.serving.serve_streams: one decode thread per stream, every chunk
of every stream in ONE jitted scan of the vmapped multi-stream step.

Headless by design (serving has no interactive window): ROIs come from
--roi — one shared by all streams or one per stream.  Homogeneous inputs
(one frame size, one ROI W,H) serve through the stacked-template layout
(pvot.parallel.multi.init_multi_state); MIXED frame sizes and/or ROI sizes
(the real multi-camera case) serve through geometry groups — one scan per
(frame size, template size) group, groups running concurrently
(pvot.io.serving.serve_streams_grouped).  In multi-object mode (several
--roi over ONE stream) mixed ROI sizes use the bucketed layout: one
shared-frame scan, per-object traced extents
(pvot.parallel.multi.init_multi_state_bucketed).

Every run prints the NCC engine it runs: "xla" (float32 at
Precision.HIGHEST), "xla_fast" with --fast, or "bucketed" for mixed ROI
sizes over one stream.

Examples:
  pvot-serve cam0.mp4 cam1.mp4 cam2.mp4 --roi 600,320,80,80
  pvot-serve cam720p.mp4 cam1080p.mp4 --roi 600,320,80,80 --roi 100,90,64,48
  pvot-serve --synthetic 1280x720x300 --streams 8 --fast
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from pvot.config import TrackerConfig


def parse_args(argv: List[str]):
    p = argparse.ArgumentParser(
        prog="pvot-serve",
        description="Serve S video streams from one process "
                    "(vmapped multi-stream scan)",
    )
    p.add_argument("videos", nargs="*", help="one video path per stream")
    p.add_argument(
        "--synthetic", metavar="WxHxF", default=None,
        help="synthetic streams (distinct trajectories) instead of files",
    )
    p.add_argument(
        "--streams", type=int, default=4,
        help="stream count with --synthetic (files set it by count)",
    )
    p.add_argument(
        "--roi", action="append", default=None, metavar="X,Y,W,H",
        help="template box; give once (shared) or once per stream. "
             "Defaults to each synthetic stream's known target",
    )
    p.add_argument("--chunk-size", type=int, default=32)
    p.add_argument(
        "--fast", action="store_true",
        help="local-search correlation at Precision.HIGH (the xla_fast "
             "engine, TF32 on an H100; see pvot.ops.backends)",
    )
    p.add_argument(
        "--devices", type=int, default=0, metavar="N",
        help="fan stream groups over the first N local devices "
             "(host-driven data parallelism, bit-identical results; "
             "0 = default device only)",
    )
    p.add_argument("--search-radius", type=int, default=None)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument(
        "--trajectory-out", default=None, metavar="PREFIX",
        help="write per-stream JSON-lines trajectories to PREFIX.s<K>.jsonl",
    )
    p.add_argument(
        "--checkpoint-out", default=None,
        help="save the final stacked tracker states (all streams, one .npz)",
    )
    p.add_argument(
        "--resume", default=None,
        help="resume every stream from a stacked-state .npz "
             "(saved by --checkpoint-out) instead of --roi templates; "
             "frames then start at each stream's current position",
    )
    args = p.parse_args(argv)
    if not args.videos and not args.synthetic:
        p.error("give video paths or --synthetic WxHxF")
    if args.videos and args.synthetic:
        p.error("--synthetic and video paths are mutually exclusive")
    return args


def _parse_roi(text: str):
    try:
        x, y, w, h = (int(v) for v in text.split(","))
    except ValueError:
        raise SystemExit(f"Invalid --roi {text!r}: expected X,Y,W,H")
    if w <= 0 or h <= 0:
        raise SystemExit(f"Invalid --roi {text!r}: W and H must be positive")
    return x, y, w, h


def _engine(args) -> str:
    """The NCC engine the flags name (pvot.ops.backends)."""
    return "xla_fast" if args.fast else "xla"


def _config(args) -> TrackerConfig:
    radius = (
        {"search_radius_x": args.search_radius,
         "search_radius_y": args.search_radius}
        if args.search_radius is not None else {}
    )
    return TrackerConfig(**radius).validate()


def _devices(args):
    """The first --devices N local devices, or None for the default one."""
    if args.devices <= 0:
        return None
    import jax

    return jax.devices()[: args.devices]


def _limit(it, n: int):
    if n <= 0:
        yield from it
        return
    for i, frame in enumerate(it):
        if i >= n:
            return
        yield frame


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(list(sys.argv[1:] if argv is None else argv))
    from pvot.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    import jax.numpy as jnp

    from pvot.io.gray import bgr_to_gray_u8, gray_u8_to_f32
    from pvot.parallel.multi import init_multi_state

    if args.resume and args.roi:
        # Pure arg validation — checked before any decoder opens.
        print(
            "--roi and --resume are mutually exclusive: templates and "
            "boxes come from the checkpoint",
            file=sys.stderr,
        )
        return 2

    # --- Per-stream first frames + remaining-frame iterators ---------------
    closers = []

    def _fail(msg: str) -> int:
        # Error exit after decoders may be open: close them, don't leak.
        for c in closers:
            c.close()
        print(msg, file=sys.stderr)
        return 2
    if args.synthetic:
        from pvot.io.synthetic import (
            SyntheticSpec,
            generate_gray_frames,
            target_bbox,
        )

        try:
            w, h, f = (int(v) for v in args.synthetic.lower().split("x"))
        except ValueError:
            print(
                f"Invalid --synthetic {args.synthetic!r}: expected WxHxF",
                file=sys.stderr,
            )
            return 2
        specs = [
            SyntheticSpec(width=w, height=h, num_frames=f, seed=1 + s)
            for s in range(args.streams)
        ]
        firsts, feeds, default_rois = [], [], []
        for spec in specs:
            gen = generate_gray_frames(spec)
            if not args.resume:  # frame 0 seeds the template
                firsts.append(next(gen))
                default_rois.append(target_bbox(spec, 0))
            feeds.append(_limit(gen, args.max_frames))
        frame_shape = (h, w)
    else:
        from pvot.io.video import VideoReader

        readers = []
        for path in args.videos:
            # Append as each decoder opens so a failed Nth open still
            # closes the first N-1 handles via _fail.
            try:
                readers.append(VideoReader(path))
                closers.append(readers[-1])
            except Exception as e:
                return _fail(f"Cannot open video {path!r}: {e}")
        # Mixed frame sizes are served by geometry groups
        # (pvot.serve_streams_grouped); homogeneous inputs keep the single
        # stacked-layout path.
        frame_shapes = [(r.size[1], r.size[0]) for r in readers]
        width, height = readers[0].size
        frame_shape = (height, width)
        firsts, feeds, default_rois = [], [], []
        for r in readers:
            if not args.resume:  # frame 0 seeds the template
                first = r.read()
                if first is None:
                    return _fail(f"Empty video: {r.path}")
                firsts.append(bgr_to_gray_u8(first))
                default_rois.append(None)
            feeds.append(_limit(iter(r), args.max_frames))

    n_streams = len(feeds)
    if args.synthetic:
        frame_shapes = [frame_shape] * n_streams
    hetero_frames = len(set(frame_shapes)) > 1

    if args.resume:
        import os

        from pvot.utils.checkpoint import load_state

        # Heterogeneous checkpoints are one file per stream
        # (PREFIX.s<K>.npz, written by _run_serving_grouped).
        per_stream = [f"{args.resume}.s{s}.npz" for s in range(n_streams)]
        if all(os.path.exists(p) for p in per_stream):
            try:
                states_list = [load_state(p) for p in per_stream]
            except (OSError, ValueError, KeyError) as e:
                return _fail(f"Cannot resume from {args.resume!r}: {e}")
            return _run_serving_grouped(
                args, feeds, states_list, frame_shapes, None, closers
            )
        try:
            states = load_state(args.resume)
        except (OSError, ValueError, KeyError) as e:
            # Missing/corrupt checkpoint after decoders opened: close them.
            return _fail(f"Cannot resume from {args.resume!r}: {e}")
        if np.ndim(states.t_mean) == 0:
            # A single-object checkpoint (saved by the pvot CLI, unstacked
            # scalar leaves): serve it as a one-lane stacked state.
            import jax

            states = jax.tree.map(lambda a: np.asarray(a)[None], states)
        saved = int(np.shape(states.t_mean)[0])
        th, tw = np.shape(states.template)[-2:]
        if n_streams == 1 and saved > 1:
            # A K-object checkpoint over one stream resumes objects mode.
            return _run_objects(args, feeds[0], states, frame_shape,
                                (tw, th), closers)
        if saved != n_streams:
            return _fail(
                f"--resume checkpoint holds {saved} stream states for "
                f"{n_streams} streams"
            )
        return _run_serving(args, feeds, states, frame_shape, (tw, th),
                            closers)

    # --- ROIs: one shared, one per stream, or synthetic defaults.  With a
    # SINGLE stream, several --roi flags switch to multi-object mode: K
    # trackers over the one stream (the vmapped multi-object step). -------
    objects_mode = False
    if args.roi:
        try:
            rois = [_parse_roi(t) for t in args.roi]
        except SystemExit as e:  # invalid --roi after decoders opened
            return _fail(str(e))
        if n_streams == 1 and len(rois) > 1:
            objects_mode = True
        elif len(rois) == 1:
            rois = rois * n_streams
        elif len(rois) != n_streams:
            hint = (
                "pass --streams 1"
                if args.synthetic
                else "give exactly one video path"
            )
            return _fail(
                f"Got {len(rois)} --roi for {n_streams} streams "
                "(give one, or one per stream; for multi-object mode — "
                f"{len(rois)} trackers over ONE stream — {hint})"
            )
    elif all(r is not None for r in default_rois):
        rois = default_rois
    else:
        return _fail("File streams need --roi (serving is headless)")
    hetero_rois = len({(rw, rh) for _, _, rw, rh in rois}) != 1

    for s, (x, y, rw, rh) in enumerate(rois):
        fh, fw = frame_shape if objects_mode else frame_shapes[s]
        if x < 0 or y < 0 or x + rw > fw or y + rh > fh:
            return _fail(
                f"--roi {x},{y},{rw},{rh} (stream {s}) lies outside the "
                f"{fw}x{fh} frame"
            )
    template_firsts = [firsts[0]] * len(rois) if objects_mode else firsts
    templates = [
        jnp.asarray(gray_u8_to_f32(first)[y : y + rh, x : x + rw])
        for first, (x, y, rw, rh) in zip(template_firsts, rois)
    ]
    if objects_mode:
        if hetero_rois:
            # Mixed template sizes over one stream: the BUCKETED layout
            # (zero-padded to the max extent, traced per-object extents —
            # pvot.parallel.multi.init_multi_state_bucketed).
            from pvot.parallel.multi import init_multi_state_bucketed

            states = init_multi_state_bucketed(
                [np.asarray(t) for t in templates], rois
            )
            bw = max(r[2] for r in rois)
            bh = max(r[3] for r in rois)
            return _run_objects(
                args, feeds[0], states, frame_shape, (bw, bh), closers,
            )
        states = init_multi_state(templates, rois)
        return _run_objects(
            args, feeds[0], states, frame_shape,
            (rois[0][2], rois[0][3]), closers,
        )
    if hetero_rois or hetero_frames:
        # Heterogeneous serving: per-stream states, geometry-grouped scans
        # (pvot.io.serving.serve_streams_grouped).
        from pvot.tracker.state import init_state

        states_list = [
            init_state(t, r) for t, r in zip(templates, rois)
        ]
        return _run_serving_grouped(
            args, feeds, states_list, frame_shapes, rois, closers
        )
    states = init_multi_state(templates, rois)
    return _run_serving(
        args, feeds, states, frame_shape, (rois[0][2], rois[0][3]), closers
    )


def _run_objects(args, feed, states, frame_shape, templ_wh, closers) -> int:
    """Multi-object serving: K trackers over one stream
    (pvot.serve_objects — the vmapped multi-object step)."""
    from pvot.io.serving import serve_objects
    from pvot.parallel.multi import is_bucketed

    k = int(np.shape(states.t_mean)[0])
    config = _config(args)
    engine = "bucketed" if is_bucketed(states) else _engine(args)
    print(f"Serving 1 stream x {k} objects at "
          f"{frame_shape[1]}x{frame_shape[0]}, template "
          f"{templ_wh[0]}x{templ_wh[1]}, chunk {args.chunk_size}, "
          f"engine {engine}")
    timings: list = []
    t0 = time.perf_counter()
    try:
        final, out = serve_objects(
            feed, states, frame_shape, config, backend=_engine(args),
            chunk_size=args.chunk_size, timings=timings,
        )
        elapsed = time.perf_counter() - t0
    finally:  # decoder handles must not leak if a stream raises mid-serve
        for c in closers:
            c.close()

    n = out.bbox.shape[0]
    for i in range(k):
        score = float(np.mean(out.score[:, i])) if n else float("nan")
        print(
            f"object {i}: frames={n}, updated={int(out.updated[:, i].sum())}, "
            f"global={int(out.used_global[:, i].sum())}, "
            f"mean_score={score:.4f}, "
            f"final_bbox={out.bbox[-1, i].tolist() if n else None}"
        )
    rate = n * k / elapsed if elapsed > 0 else 0.0
    print(
        f"Serving summary: objects={k}, frames={n}, "
        f"time={elapsed:.6g} s, object-updates/s={rate:.6g}"
    )

    if args.trajectory_out:
        import json

        for i in range(k):
            path = f"{args.trajectory_out}.o{i}.jsonl"
            with open(path, "w") as f:
                for j in range(n):
                    f.write(json.dumps({
                        "object": i,
                        "frame": 1 + j,
                        "bbox": np.asarray(out.bbox[j, i]).tolist(),
                        "score": round(float(out.score[j, i]), 6),
                        "used_global": bool(out.used_global[j, i]),
                        "updated": bool(out.updated[j, i]),
                    }) + "\n")
        print(f"Trajectories written: {args.trajectory_out}.o*.jsonl")

    if args.checkpoint_out:
        from pvot.utils.checkpoint import save_state

        saved_path = save_state(args.checkpoint_out, final)
        print(f"Checkpoint saved: {saved_path} ({k} object states)")
    return 0


def _run_serving_grouped(
    args, feeds, states_list, frame_shapes, rois, closers
) -> int:
    """Heterogeneous serving: per-stream states, geometry-grouped scans
    (pvot.io.serving.serve_streams_grouped)."""
    from pvot.io.serving import serve_streams_grouped

    n_streams = len(feeds)
    config = _config(args)
    devices = _devices(args)
    shapes = sorted(
        {
            (fs, tuple(np.shape(st.template)))
            for fs, st in zip(frame_shapes, states_list)
        }
    )
    groups = ", ".join(
        f"{fw}x{fh}/t{tw}x{th}" for (fh, fw), (th, tw) in shapes
    )
    print(f"Serving {n_streams} streams in {len(shapes)} geometry groups "
          f"({groups}), chunk {args.chunk_size}, engine {_engine(args)}"
          + (f", {len(devices)} devices" if devices else ""))
    timings: list = []
    t0 = time.perf_counter()
    try:
        finals, outs = serve_streams_grouped(
            feeds, states_list, frame_shapes, config, backend=_engine(args),
            chunk_size=args.chunk_size, timings=timings, devices=devices,
        )
        elapsed = time.perf_counter() - t0
    finally:  # decoder handles must not leak if a stream raises mid-serve
        for c in closers:
            c.close()

    total = 0
    for s, out in enumerate(outs):
        n = out.bbox.shape[0]
        total += n
        score = float(np.mean(out.score)) if n else float("nan")
        print(
            f"stream {s}: frames={n}, updated={int(out.updated.sum())}, "
            f"global={int(out.used_global.sum())}, mean_score={score:.4f}, "
            f"final_bbox={out.bbox[-1].tolist() if n else None}"
        )
    fps = total / elapsed if elapsed > 0 else 0.0
    print(
        f"Serving summary: streams={n_streams}, frames={total}, "
        f"time={elapsed:.6g} s, aggregate FPS={fps:.6g}"
    )

    if args.trajectory_out:
        _write_trajectories(args.trajectory_out, outs)

    if args.checkpoint_out:
        from pvot.utils.checkpoint import save_state

        # One file per stream: heterogeneous states cannot stack.
        for s, final in enumerate(finals):
            save_state(f"{args.checkpoint_out}.s{s}.npz", final)
        print(
            f"Checkpoints saved: {args.checkpoint_out}.s<K>.npz "
            f"({n_streams} per-stream states; resume with "
            f"--resume {args.checkpoint_out})"
        )
    return 0


def _write_trajectories(prefix: str, outs) -> None:
    import json

    for s, out in enumerate(outs):
        path = f"{prefix}.s{s}.jsonl"
        with open(path, "w") as f:
            for i in range(out.bbox.shape[0]):
                f.write(json.dumps({
                    "stream": s,
                    "frame": 1 + i,
                    "bbox": np.asarray(out.bbox[i]).tolist(),
                    "score": round(float(out.score[i]), 6),
                    "used_global": bool(out.used_global[i]),
                    "updated": bool(out.updated[i]),
                }) + "\n")
    print(f"Trajectories written: {prefix}.s*.jsonl")


def _run_serving(args, feeds, states, frame_shape, templ_wh, closers) -> int:
    from pvot.io.serving import serve_streams

    n_streams = len(feeds)
    config = _config(args)
    devices = _devices(args)
    print(f"Serving {n_streams} streams at {frame_shape[1]}x{frame_shape[0]}, "
          f"template {templ_wh[0]}x{templ_wh[1]}, chunk {args.chunk_size}, "
          f"engine {_engine(args)}"
          + (f", {len(devices)} devices" if devices else ""))
    timings: list = []
    t0 = time.perf_counter()
    try:
        final, outs = serve_streams(
            feeds, states, frame_shape, config, backend=_engine(args),
            chunk_size=args.chunk_size, timings=timings, devices=devices,
        )
        elapsed = time.perf_counter() - t0
    finally:  # decoder handles must not leak if a stream raises mid-serve
        for c in closers:
            c.close()

    total = 0
    for s, out in enumerate(outs):
        n = out.bbox.shape[0]
        total += n
        score = float(np.mean(out.score)) if n else float("nan")
        print(
            f"stream {s}: frames={n}, updated={int(out.updated.sum())}, "
            f"global={int(out.used_global.sum())}, mean_score={score:.4f}, "
            f"final_bbox={out.bbox[-1].tolist() if n else None}"
        )
    fps = total / elapsed if elapsed > 0 else 0.0
    # Aggregate summary in the reference's summary spelling (main.cpp:485-488)
    # extended with the stream count.
    print(
        f"Serving summary: streams={n_streams}, frames={total}, "
        f"time={elapsed:.6g} s, aggregate FPS={fps:.6g}"
    )

    if args.trajectory_out:
        _write_trajectories(args.trajectory_out, outs)

    if args.checkpoint_out:
        from pvot.utils.checkpoint import save_state

        saved_path = save_state(args.checkpoint_out, final)
        print(f"Checkpoint saved: {saved_path} ({n_streams} stream states)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
