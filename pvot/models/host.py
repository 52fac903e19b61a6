"""Accelerator-free host tracker — the reference's CPU path, natively.

Runs the complete tracking state machine (C5-C8: clamped-window search,
confidence gating, template EMA, lost-object global re-acquisition;
tracker_ghc/src/main.cpp:399-463) on the host CPU, with the NCC computed by
the native C++ engine (pvot/runtime/libpvot.cpp::pvot_ncc_match_f32 — the
analog of tracker/src/ncc_cpu.cpp; OpenMP + integral images; numpy fallback
when no toolchain).  This makes pvot usable with no accelerator at all,
and serves as an independent second implementation of the tracker
semantics: tests assert trajectory equality against the scanned JAX path on
every tested/fuzzed clip.  That equality is a measured per-clip property,
not a structural guarantee — the host converts uint8 via gray_u8_to_f32
(f64 scale) while the device wire path converts slices via ensure_gray_f32
(f32 multiply; the two differ by 1 ulp for 126/256 uint8 values), and NCC
accumulation orders differ (double integral images here vs HIGHEST f32
matmuls there) — so near-threshold/tie frames could in principle diverge
on adversarial inputs.  The fuzz tests (tests/test_host.py) are the guard.

Unlike the reference CPU mode (full-frame cv::matchTemplate every frame,
main.cpp:158), the local search computes NCC only over the clamped window's
support — the same ~50x work cut as the fused device path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pvot.config import TrackerConfig


def _is_outside(bx: int, by: int, bw: int, bh: int, fw: int, fh: int) -> bool:
    """isBboxOutsideFrame (main.cpp:49-55): center out OR box entirely out."""
    cx = bx + bw // 2
    cy = by + bh // 2
    center_out = cx < 0 or cx >= fw or cy < 0 or cy >= fh
    box_out = bx + bw < 0 or bx >= fw or by + bh < 0 or by >= fh
    return center_out or box_out


def _argmax_rowmajor(m: np.ndarray) -> Tuple[float, int, int]:
    """cv::minMaxLoc scan order: row-major first occurrence."""
    idx = int(np.argmax(m))
    w = m.shape[1]
    return float(m.flat[idx]), idx % w, idx // w


def track_video_host(
    frames: np.ndarray,
    template: np.ndarray,
    roi: Tuple[int, int, int, int],
    config: TrackerConfig = TrackerConfig(),
    lost_count: int = 0,
    use_global: bool = False,
):
    """Track through gray frames (F, H, W) u8 (or f32 in [0,1]) on the host.

    template: (h, w) f32 initial template (as passed to pvot.init_state);
    roi: the initial (x, y, w, h); lost_count/use_global resume a carried
    state (HostTracker threads them).  Returns (final, out) where final is a
    dict {bbox, template, t_mean, t_std, lost_count, use_global} and out has
    arrays bbox (F, 4) i32, score (F,) f32, used_global / updated (F,) bool —
    the same per-frame record as the device path's StepOutput.
    """
    from pvot.io.gray import gray_u8_to_f32
    from pvot.runtime.native import ncc_match, template_stats_host

    config = config.validate()
    frames = np.asarray(frames)
    f, fh, fw = frames.shape
    templ = np.ascontiguousarray(template, np.float32)
    th, tw = templ.shape
    out_w = fw - tw + 1
    out_h = fh - th + 1
    if out_w <= 0 or out_h <= 0:
        raise ValueError(f"template {templ.shape} larger than frame ({fh}, {fw})")
    bx, by, bw, bh = (int(v) for v in roi)
    t_mean, t_std = template_stats_host(templ)
    lost = int(lost_count)
    use_global = bool(use_global)
    rx, ry = config.search_radius_x, config.search_radius_y
    lr = np.float32(config.template_update_lr)
    lost_threshold = int(config.lost_frame_threshold)

    def to_f32(a: np.ndarray) -> np.ndarray:
        return gray_u8_to_f32(a) if a.dtype == np.uint8 else np.asarray(a, np.float32)

    bboxes = np.empty((f, 4), np.int32)
    scores = np.empty((f,), np.float32)
    used_global = np.empty((f,), bool)
    updated = np.empty((f,), bool)

    for i in range(f):
        frame = frames[i]
        # --- Mode selection (main.cpp:399-413) ---------------------------
        if config.enable_global_search:
            ug = use_global or _is_outside(bx, by, bw, bh, fw, fh) or (
                lost >= lost_threshold
            )
        else:  # Windows-tree / main_old variant
            ug = False
        cx = bx + bw // 2
        cy = by + bh // 2
        min_tx = max(0, cx - rx - tw // 2)
        max_tx = min(out_w - 1, cx + rx - tw // 2)
        min_ty = max(0, cy - ry - th // 2)
        max_ty = min(out_h - 1, cy + ry - th // 2)
        valid = max_tx >= min_tx and max_ty >= min_ty
        global_argmax = ug or not valid

        # --- NCC + argmax (main.cpp:414-446) -----------------------------
        if global_argmax:
            m = ncc_match(to_f32(frame), templ, t_mean, t_std)
            best_val, best_x, best_y = _argmax_rowmajor(m)
        else:
            # NCC over exactly the clamped window's support: the map of this
            # slice IS the window's scores (fused-path work cut, host style).
            sub = frame[min_ty : max_ty + th, min_tx : max_tx + tw]
            m = ncc_match(to_f32(sub), templ, t_mean, t_std)
            best_val, lx, ly = _argmax_rowmajor(m)
            best_x, best_y = min_tx + lx, min_ty + ly

        # --- Gate + update (main.cpp:448-463) ----------------------------
        threshold = (
            config.global_confidence if ug else config.min_confidence
        )
        accept = best_val >= threshold
        if accept:
            bx, by, bw, bh = best_x, best_y, tw, th
            lost = 0
        else:
            lost += 1
        use_global = (
            False if (accept and not _is_outside(bx, by, bw, bh, fw, fh)) else ug
        )
        if accept and best_val >= config.strong_confidence:
            patch = to_f32(frame[by : by + th, bx : bx + tw])
            templ = ((np.float32(1.0) - lr) * templ + lr * patch).astype(np.float32)
            t_mean, t_std = template_stats_host(templ)

        bboxes[i] = (bx, by, bw, bh)
        scores[i] = best_val
        used_global[i] = global_argmax
        updated[i] = accept

    final = {
        "bbox": (bx, by, bw, bh),
        "template": templ,
        "t_mean": t_mean,
        "t_std": t_std,
        "lost_count": lost,
        "use_global": use_global,
    }
    out = {
        "bbox": bboxes,
        "score": scores,
        "used_global": used_global,
        "updated": updated,
    }
    return final, out


def track_stream_host(
    frame_iter,
    template: np.ndarray,
    roi: Tuple[int, int, int, int],
    config: TrackerConfig = TrackerConfig(),
    lost_count: int = 0,
    use_global: bool = False,
    timings=None,
):
    """Streaming host tracking: one frame at a time from an iterator (gray
    u8 (H, W) or BGR u8 (H, W, 3)); memory stays bounded regardless of clip
    length.  Same return contract as track_video_host.

    timings, when given a list, receives one (1, seconds) pair per frame —
    true per-frame instantaneous timing, matching the reference's tick-delta
    FPS overlay granularity (tracker_ghc/src/main.cpp:470-478)."""
    import time

    from pvot.runtime.native import template_stats_host

    template = np.ascontiguousarray(template, np.float32)
    t_mean, t_std = template_stats_host(template)
    final = {
        "bbox": tuple(int(v) for v in roi),
        "template": template,
        "t_mean": t_mean,
        "t_std": t_std,
        "lost_count": int(lost_count),
        "use_global": bool(use_global),
    }
    bboxes, scores, used_global, updated = [], [], [], []
    mark = time.perf_counter()
    for frame in frame_iter:
        frame = np.asarray(frame)
        if frame.ndim == 3:
            from pvot.runtime import native

            frame = native.bgr_to_gray_u8(frame)
        final, out = track_video_host(
            frame[None], final["template"], final["bbox"], config,
            lost_count=final["lost_count"], use_global=final["use_global"],
        )
        if timings is not None:
            now = time.perf_counter()
            timings.append((1, now - mark))
            mark = now
        bboxes.append(out["bbox"][0])
        scores.append(out["score"][0])
        used_global.append(out["used_global"][0])
        updated.append(out["updated"][0])
    n = len(bboxes)
    out = {
        "bbox": np.asarray(bboxes, np.int32).reshape(n, 4),
        "score": np.asarray(scores, np.float32),
        "used_global": np.asarray(used_global, bool),
        "updated": np.asarray(updated, bool),
    }
    return final, out


class HostTracker:
    """Object-style wrapper (NccTracker shape) over track_video_host's loop.

    >>> t = HostTracker(first_gray_u8, roi=(x, y, w, h))
    >>> bbox, score = t.update(frame)
    """

    def __init__(
        self,
        first_frame: np.ndarray,
        roi: Tuple[int, int, int, int],
        config: TrackerConfig = TrackerConfig(),
        template: Optional[np.ndarray] = None,
    ):
        from pvot.io.gray import gray_u8_to_f32

        first_frame = np.asarray(first_frame)
        if first_frame.ndim == 3:
            from pvot.runtime import native

            first_frame = native.bgr_to_gray_u8(first_frame)
        x, y, w, h = (int(v) for v in roi)
        if template is None:
            g = (
                gray_u8_to_f32(first_frame)
                if first_frame.dtype == np.uint8
                else np.asarray(first_frame, np.float32)
            )
            template = g[y : y + h, x : x + w]
        self._template = np.ascontiguousarray(template, np.float32)
        self._roi = (x, y, w, h)
        self._config = config
        self._state = None  # lazily folded via track_video_host single steps

    @property
    def bbox(self) -> Tuple[int, int, int, int]:
        return self._roi if self._state is None else self._state["bbox"]

    def _advance(self, frames: np.ndarray):
        if self._state is None:
            final, out = track_video_host(
                frames, self._template, self._roi, self._config
            )
        else:
            s = self._state
            final, out = track_video_host(
                frames, s["template"], s["bbox"], self._config,
                lost_count=s["lost_count"], use_global=s["use_global"],
            )
        self._state = final
        return final, out

    def update(self, frame: np.ndarray) -> Tuple[Tuple[int, int, int, int], float]:
        frame = np.asarray(frame)
        if frame.ndim == 3:
            from pvot.runtime import native

            frame = native.bgr_to_gray_u8(frame)
        _, out = self._advance(frame[None])
        return tuple(int(v) for v in out["bbox"][0]), float(out["score"][0])

    def track(self, frames: np.ndarray):
        """Track a whole clip; returns (final_state_dict, per-frame out dict)."""
        return self._advance(np.asarray(frames))
