"""pvot command-line interface.

Mirrors the reference CLI surface (tracker_ghc/src/main.cpp:57-79 and
run_tracker.sh:16-27):

    pvot [video] [--cpu|--shared|--const|--const_tiled|--batch=N]
         [--record] [--first]

plus headless extensions the reference lacks (its ROI selection is GUI-only,
record_tracker hard-fails without DISPLAY, main.cpp:281-285):

    --roi X,Y,W,H     template box, skips the GUI selector
    --start-frame K   template source frame (reference: interactive preview)
    --output PATH     override the generated output path
    --max-frames N    stop after N tracked frames
    --synthetic WxHxF generate a deterministic clip instead of reading a file
    --strategy, --chunk-size, --search-radius, ... tracking knobs (the
                      reference's compile-time constants, main.cpp:10-23)

Output naming matches generate_output_path (main.cpp:28-47):
output/<base>_<mode>[_<batch>]<ext>, with mkdir("output").
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

from pvot.config import TrackerConfig


# Reference mode-flag spelling (main.cpp:63-75), plus pvot's serving mode
# (--fast: the local-search correlation at Precision.HIGH, see
# pvot.ops.backends) and --host (accelerator-free: the native C++ NCC engine
# + host loop, pvot.models.host — trajectory-equal to the device path on all
# tested clips).  pvot.ops.backends.MODE_TO_BACKEND maps each mode to the
# engine that runs it.
_MODE_FLAGS = {
    "--cpu": "cpu",
    "--shared": "shared",
    "--const": "const",
    "--const_tiled": "const_tiled",
    "--fast": "fast",
    "--host": "host",
    "--auto": "auto",
}


def generate_output_path(video_path: str, mode: str, batch_size: int) -> str:
    """Port of generate_output_path (tracker_ghc/src/main.cpp:28-47)."""
    base = os.path.basename(video_path)
    root, ext = os.path.splitext(base)
    if not ext:
        ext = ".mp4"
        root = base
    os.makedirs("output", exist_ok=True)
    filename = f"output/{root}_{mode}"
    if mode == "batch" and batch_size > 0:
        filename += f"_{batch_size}"
    return filename + ext


def parse_args(argv: List[str]):
    """Hand-rolled to accept the reference's exact flag spelling (including
    --batch=N) alongside the extended options.

    An engine flag composes with --batch=N: `--batch=8 --fast` runs batch
    semantics (C10) on the fast engine.  The reference's --batch is
    naive-kernel-only (main.cpp:71-74), so mode/output naming stays "batch"
    for parity; the engine choice is pvot's extension."""
    engine = None  # NCC engine flag (--cpu/--shared/--fast/...), if given
    batch_size = 0
    passthrough = []
    for arg in argv:
        if arg in _MODE_FLAGS:
            engine = _MODE_FLAGS[arg]
        elif arg.startswith("--batch="):
            batch_size = max(1, int(arg.split("=", 1)[1] or 1))
        else:
            passthrough.append(arg)
    mode = "batch" if batch_size else (engine or "cuda")  # main.cpp:59 default

    p = argparse.ArgumentParser(
        prog="pvot",
        description="NCC video object tracker (JAX)",
    )
    p.add_argument("video", nargs="?", default="data/car.mp4")
    p.add_argument("--record", action="store_true", help="write annotated video")
    p.add_argument("--first", action="store_true", help="template from first frame")
    p.add_argument("--roi", type=str, default=None, help="X,Y,W,H template box (headless)")
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--synthetic", type=str, default=None, metavar="WxHxF")
    p.add_argument("--strategy", choices=["fused", "full"], default="fused")
    p.add_argument("--chunk-size", type=int, default=32)
    p.add_argument("--search-radius", type=int, default=None)
    p.add_argument("--search-radius-x", type=int, default=TrackerConfig.search_radius_x)
    p.add_argument("--search-radius-y", type=int, default=TrackerConfig.search_radius_y)
    p.add_argument("--min-confidence", type=float, default=TrackerConfig.min_confidence)
    p.add_argument("--global-confidence", type=float, default=TrackerConfig.global_confidence)
    p.add_argument("--strong-confidence", type=float, default=TrackerConfig.strong_confidence)
    p.add_argument("--template-update-lr", type=float, default=TrackerConfig.template_update_lr)
    p.add_argument("--lost-frame-threshold", type=int, default=TrackerConfig.lost_frame_threshold)
    p.add_argument(
        "--no-global-search", action="store_true",
        help="disable lost-object re-acquisition (the reference Windows-tree"
             "/main_old behavior)",
    )
    p.add_argument("--no-display", action="store_true", help="never open GUI windows")
    p.add_argument(
        "--stage-timing", action="store_true",
        help="print the Windows-tree summary block with the compute-only "
             "time accumulator (tracker/src/main.cpp:175-182)",
    )
    p.add_argument(
        "--trajectory-out", type=str, default=None,
        help="write per-frame results (bbox/score/flags) as JSON lines",
    )
    p.add_argument(
        "--checkpoint-out", type=str, default=None,
        help="save the final tracker state (bbox/template/counters) to this .npz",
    )
    p.add_argument(
        "--resume", type=str, default=None,
        help="resume from a tracker-state .npz instead of selecting a ROI",
    )
    args = p.parse_args(passthrough)
    args.mode = mode
    args.batch_size = batch_size
    # The NCC engine driving the batch scan (default: the xla matmul
    # engine, the reference naive-kernel analog).
    args.engine = engine or "cuda"
    if args.mode == "batch" and args.engine == "host":
        p.error("--host has no batch driver; drop --batch=N or the "
                "engine flag")
    if args.search_radius is not None:
        args.search_radius_x = args.search_radius_y = args.search_radius
    return args


def _config_from_args(args) -> TrackerConfig:
    return TrackerConfig(
        search_radius_x=args.search_radius_x,
        search_radius_y=args.search_radius_y,
        batch_size=args.batch_size or TrackerConfig.batch_size,
        min_confidence=args.min_confidence,
        global_confidence=args.global_confidence,
        strong_confidence=args.strong_confidence,
        template_update_lr=args.template_update_lr,
        lost_frame_threshold=args.lost_frame_threshold,
        enable_global_search=not args.no_global_search,
    ).validate()


class FrameSource:
    """Re-iterable, bounded-memory BGR frame source (file or synthetic).

    The reference streams frames one at a time through its tracking loop
    (tracker_ghc/src/main.cpp:362); loading a whole clip into host RAM
    breaks on exactly the long/4K inputs the tracker targets, so every
    pass here re-decodes from the start offset instead."""

    def __init__(self, args):
        self.spec = None
        self.path = args.video
        if args.synthetic:
            from pvot.io.synthetic import SyntheticSpec

            try:
                w, h, f = (int(v) for v in args.synthetic.lower().split("x"))
            except ValueError:
                print(
                    f"Invalid --synthetic {args.synthetic!r}: expected WxHxF, "
                    "e.g. 1280x720x300",
                    file=sys.stderr,
                )
                raise SystemExit(2)
            self.spec = SyntheticSpec(width=w, height=h, num_frames=f)
            self.fps = 30.0
            self.shape = (h, w)  # (H, W)
        else:
            from pvot.io.video import VideoReader

            try:
                with VideoReader(self.path) as r:
                    self.fps = r.fps
                    w, h = r.size
            except IOError:
                print(f"Cannot open video: {self.path}", file=sys.stderr)
                raise SystemExit(-1)
            self.shape = (h, w)

    def frames(self, start: int = 0, limit: Optional[int] = None):
        """Yield uint8 BGR frames [start, start+limit)."""
        if self.spec is not None:
            import itertools

            from pvot.io.synthetic import generate_bgr_frames

            stop = None if limit is None else start + limit
            yield from itertools.islice(
                generate_bgr_frames(self.spec), start, stop
            )
            return
        from pvot.io.video import VideoReader

        with VideoReader(self.path) as r:
            for _ in range(start):  # skip without keeping frames
                if r.read() is None:
                    return
            n = 0
            while limit is None or n < limit:
                frame = r.read()
                if frame is None:
                    return
                yield frame
                n += 1

    def nth_frame(self, idx: int, clamp: bool = False) -> Optional[np.ndarray]:
        """Decode frame `idx`; with clamp=True, the last frame when the clip
        is shorter (matches the old array path's start-frame clamping)."""
        last = None
        for i, frame in enumerate(self.frames(0, idx + 1)):
            last = frame
            if i == idx:
                return frame
        return last if clamp else None


# Display cap matching the reference demo (tracker_ghc/src/main.cpp:250-259).
_MAX_DISPLAY_W = 1280
_MAX_DISPLAY_H = 720


def display_downscale(frame_bgr: np.ndarray) -> np.ndarray:
    """Downscale a frame to fit 1280x720 for display, preserving aspect
    (reference demo_tracker, tracker_ghc/src/main.cpp:250-259: min(1, min(
    maxW/cols, maxH/rows)) INTER_AREA resize).  Returns the input unchanged
    when it already fits."""
    h, w = frame_bgr.shape[:2]
    scale = min(1.0, min(_MAX_DISPLAY_W / w, _MAX_DISPLAY_H / h))
    if scale >= 1.0:
        return frame_bgr
    import cv2

    return cv2.resize(
        frame_bgr, None, fx=scale, fy=scale, interpolation=cv2.INTER_AREA
    )


def _select_roi(args, source: FrameSource):
    """Template selection: --roi (headless) or GUI selectROI like the
    reference (main.cpp:287-319).  Returns (start, roi, template_frame)."""
    start = args.start_frame
    if args.first:
        start = 0
    if args.roi:
        try:
            x, y, w, h = (int(v) for v in args.roi.split(","))
        except ValueError:
            print(
                f"Invalid --roi {args.roi!r}: expected X,Y,W,H integers",
                file=sys.stderr,
            )
            raise SystemExit(2)
        fh, fw = source.shape
        if w <= 0 or h <= 0:
            print("No template selected", file=sys.stderr)
            raise SystemExit(-1)
        if x < 0 or y < 0 or x + w > fw or y + h > fh:
            print(
                f"--roi {args.roi} lies outside the {fw}x{fh} frame",
                file=sys.stderr,
            )
            raise SystemExit(2)
        template_frame = source.nth_frame(start, clamp=True)
        if template_frame is None:
            print(f"Cannot open video: {source.path}", file=sys.stderr)
            raise SystemExit(-1)
        return start, (x, y, w, h), template_frame
    if args.no_display or not os.environ.get("DISPLAY"):
        print(
            "DISPLAY not set\n(headless runs need --roi X,Y,W,H)",
            file=sys.stderr,
        )
        raise SystemExit(-1)
    import cv2

    frame = None
    if not args.first:
        # Frame-preview browser: ENTER selects, ESC quits (main.cpp:295-312).
        print(
            "Use the preview window to pick a frame that contains the target object.\n"
            "Press ENTER to select the current frame. Press ESC to quit."
        )
        cv2.namedWindow("Frame Preview", cv2.WINDOW_NORMAL)
        idx = start - 1
        for frame in source.frames(start):
            idx += 1
            # Raw-resolution preview, as the reference shows it (:106); only
            # the live tracking window downsizes (:250-259).
            cv2.imshow("Frame Preview", frame)
            key = cv2.waitKey(30)
            if key == 27:
                print("Template selection cancelled by user.")
                raise SystemExit(0)
            if key in (13, 10):
                break
        else:
            print("Reached End of Video.", file=sys.stderr)
            raise SystemExit(-1)
        cv2.destroyWindow("Frame Preview")
        start = idx
    if frame is None:
        frame = source.nth_frame(start, clamp=True)
        if frame is None:
            print(f"Cannot open video: {source.path}", file=sys.stderr)
            raise SystemExit(-1)
    roi = cv2.selectROI("Select Template", frame, False, False)
    cv2.destroyWindow("Select Template")
    if roi[2] == 0 or roi[3] == 0:
        print("No template selected", file=sys.stderr)
        raise SystemExit(-1)
    return start, tuple(int(v) for v in roi), frame


def _draw_bbox(frame_bgr: np.ndarray, bbox, color=(0, 255, 0)) -> None:
    import cv2

    x, y, w, h = (int(v) for v in bbox)
    cv2.rectangle(frame_bgr, (x, y), (x + w, y + h), color, 2)


def _draw_fps(frame_bgr: np.ndarray, fps: float) -> None:
    import cv2

    cv2.putText(
        frame_bgr, f"FPS: {fps:.1f}", (20, 30),
        cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 0), 2,
    )


def per_frame_fps(timings, n_frames: int, fallback: float) -> np.ndarray:
    """Expand (n_frames, seconds) tracking-pass timings into a per-frame FPS
    array for the on-frame overlay.

    The reference burns each frame's instantaneous tick-delta FPS into the
    recorded output (tracker_ghc/src/main.cpp:470-478).  pvot tracks in
    scanned chunks, so the finest honestly-timeable rate is per chunk (per
    frame on the host path, whose driver times each frame); frames not
    covered by a timing record (e.g. batch-mode leftovers) fall back to the
    run average."""
    fps = np.full((n_frames,), fallback, np.float64)
    i = 0
    for n, dt in timings:
        rate = (n / dt) if dt > 0 else fallback
        n = min(int(n), n_frames - i)
        if n <= 0:
            break
        fps[i : i + n] = rate
        i += n
    return fps


def run_tracking(args) -> int:
    from pvot.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()  # scan compiles persist across CLI runs
    import jax.numpy as jnp

    from pvot.io.gray import gray_u8_to_f32
    from pvot.io.pipeline import track_stream, track_stream_batched
    from pvot.runtime import native
    from pvot.tracker.state import init_state

    config = _config_from_args(args)
    source = FrameSource(args)
    if args.resume:
        # Resume a stream: state (bbox/template/counters) comes from the
        # checkpoint; the video supplies the remaining frames.  The
        # reference has no such facility (SURVEY.md §5 checkpoint row).
        from pvot.utils.checkpoint import load_state

        state = load_state(args.resume)
        roi = tuple(int(v) for v in (
            state.bbox_x, state.bbox_y, state.bbox_w, state.bbox_h
        ))
        # Frame 0 is tracked (not a template source) when resuming.
        track_from = 0
        template_frame = source.nth_frame(0)
        if template_frame is None:
            print(f"Cannot open video: {source.path}", file=sys.stderr)
            raise SystemExit(-1)
    else:
        start, roi, template_frame = _select_roi(args, source)
        track_from = start + 1
        x, y, w, h = roi
        gray0 = native.bgr_to_gray_u8(template_frame)
        templ = gray_u8_to_f32(gray0)[y : y + h, x : x + w]
        if args.mode == "host":
            # Device-free init (numpy leaves): --host must work — and stay
            # fast — with no accelerator and no device round-trips at all.
            from pvot.runtime.native import template_stats_host
            from pvot.tracker.state import TrackerState

            t_mean, t_std = template_stats_host(templ)
            state = TrackerState(
                bbox_x=np.int32(x), bbox_y=np.int32(y),
                bbox_w=np.int32(w), bbox_h=np.int32(h),
                template=np.ascontiguousarray(templ, np.float32),
                t_mean=np.float32(t_mean), t_std=np.float32(t_std),
                lost_count=np.int32(0), use_global=np.bool_(False),
            )
        else:
            state = init_state(jnp.asarray(templ), roi)

    backend = args.mode
    mode_label = args.mode
    suffix = ""
    if args.mode == "batch":
        suffix = f" (batch size: {args.batch_size}"
        if args.engine != "cuda":
            suffix += f", engine: {args.engine}"
        suffix += ")"
    print(f"Tracking mode: {mode_label}{suffix}")
    if args.mode != "host":
        from pvot.ops.backends import resolve

        print(f"NCC engine: {resolve(args.engine)}")

    output_path = None
    if args.record:
        output_path = args.output or generate_output_path(
            args.video if not args.synthetic else "synthetic.mp4",
            mode_label,
            args.batch_size,
        )
        print(f"Output video: {output_path}")

    # --- Tracking pass: decode overlaps device compute; memory is bounded
    # by the pipeline ring, never the clip length.
    limit = args.max_frames if args.max_frames else None
    print("Tracking...")
    t_start = time.perf_counter()
    frame_iter = source.frames(track_from, limit)
    chunk_timings: list = []  # (n_frames, seconds) per tracked chunk/frame
    if args.mode == "host":
        # Accelerator-free path: native C++ NCC + host loop (bit-matching
        # trajectories with the device path, tests/test_host.py).
        from pvot.models.host import track_stream_host
        from pvot.tracker.state import StepOutput, TrackerState

        host_final, host_out = track_stream_host(
            frame_iter, np.asarray(state.template),
            (int(state.bbox_x), int(state.bbox_y),
             int(state.bbox_w), int(state.bbox_h)),
            config,
            lost_count=int(state.lost_count),
            use_global=bool(state.use_global),
            timings=chunk_timings,
        )
        # numpy leaves keep this mode fully device-free; TrackerState is
        # dtype-agnostic for checkpointing.
        out = StepOutput(**host_out)
        bx, by, bw, bh = host_final["bbox"]
        final = TrackerState(
            bbox_x=np.int32(bx), bbox_y=np.int32(by),
            bbox_w=np.int32(bw), bbox_h=np.int32(bh),
            template=host_final["template"],
            t_mean=np.float32(host_final["t_mean"]),
            t_std=np.float32(host_final["t_std"]),
            lost_count=np.int32(host_final["lost_count"]),
            use_global=np.bool_(host_final["use_global"]),
        )
    elif args.mode == "batch":
        # The engine flag (--fast/--shared/...) composes with --batch=N
        # instead of being silently dropped; default is the xla engine.
        final, out = track_stream_batched(
            frame_iter, state, source.shape, config,
            batch_size=args.batch_size, strategy=args.strategy,
            backend=args.engine, timings=chunk_timings,
        )
    else:
        final, out = track_stream(
            frame_iter, state, source.shape, config=config,
            strategy=args.strategy, backend=backend,
            chunk_size=args.chunk_size, timings=chunk_timings,
        )
    elapsed = time.perf_counter() - t_start
    n_tracked = len(out.bbox)
    total_frames = n_tracked + 1  # + template frame, like main.cpp:356
    avg_fps = total_frames / elapsed if elapsed > 0 else 0.0

    # --- Drawing/encode pass: re-decode and annotate; frames stream through
    # one at a time (the reference also writes inside its decode loop).
    show = not args.record and not args.no_display and os.environ.get("DISPLAY")
    if args.record or show:
        import cv2

        writer = None
        if args.record:
            from pvot.io.video import VideoWriter

            fh, fw = source.shape
            writer = VideoWriter(output_path, source.fps, (fw, fh))
            first = template_frame.copy()
            _draw_bbox(first, roi)
            writer.write(first)
        bboxes = np.asarray(out.bbox)
        # Per-frame FPS overlay like the reference (main.cpp:470-478);
        # chunk-amortized on the device path, per-frame on the host path.
        frame_fps = per_frame_fps(chunk_timings, n_tracked, avg_fps)
        for i, frame in enumerate(source.frames(track_from, n_tracked)):
            _draw_bbox(frame, bboxes[i])
            _draw_fps(frame, frame_fps[i])
            if writer:
                writer.write(frame)
            if show:
                # Live window capped at 1280x720 like the reference demo
                # (tracker_ghc/src/main.cpp:250-259).
                cv2.imshow("Tracking", display_downscale(frame))
                if cv2.waitKey(1) == 27:
                    break
        if writer:
            writer.close()

    if args.trajectory_out:
        import json

        bb = np.asarray(out.bbox)
        sc = np.asarray(out.score)
        ug = np.asarray(out.used_global)
        up = np.asarray(out.updated)
        with open(args.trajectory_out, "w") as f:
            for i in range(len(bb)):
                f.write(json.dumps({
                    "frame": track_from + i,
                    "bbox": bb[i].tolist(),
                    "score": round(float(sc[i]), 6),
                    "used_global": bool(ug[i]),
                    "updated": bool(up[i]),
                }) + "\n")
        print(f"Trajectory written: {args.trajectory_out}")

    if args.checkpoint_out:
        from pvot.utils.checkpoint import save_state

        saved_path = save_state(args.checkpoint_out, final)
        print(f"Checkpoint saved: {saved_path}")

    kind = "Recorded" if args.record else "Interactive"
    # Summary format matches the reference (main.cpp:485-488).
    print(
        f"{kind} tracking summary: frames={total_frames}, "
        f"time={elapsed:.6g} s, FPS={avg_fps:.6g}"
    )
    if args.stage_timing:
        # Windows-tree summary block (tracker/src/main.cpp:175-182): total
        # wall time vs the compute-only accumulator t_tot.  Here "computation"
        # is the tracking pass (device NCC + state scan, with decode
        # overlapped); drawing/encode is the extra cost on top.
        t_total = time.perf_counter() - t_start
        print("\n--------")
        print(" Tracking Complete")
        print(f" Mode       : {mode_label}")
        print(f" Frames     : {total_frames}")
        print(f" Time (sec) : {t_total:.6g}")
        print(f" Computation Time (sec)  : {elapsed:.6g}")
        print(f" FPS        : {total_frames / t_total if t_total > 0 else 0.0:.6g}")
        print("--------")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(list(sys.argv[1:] if argv is None else argv))
    return run_tracking(args)


if __name__ == "__main__":
    raise SystemExit(main())
