"""Timing / FPS instrumentation (component C9, SURVEY.md §2a).

The reference measures per-frame instantaneous FPS with cv::getTickCount
deltas and prints an end-of-run summary (tracker_ghc/src/main.cpp:243-246,
482-488); its Windows main additionally accumulates pure compute time
(tracker/src/main.cpp:101,163-164,180), and the CPU baseline times each
pipeline stage (baseline_cpu/cpub.cpp:101-148).  All three styles exist here.

Accelerator caveat baked into the API: device dispatch is asynchronous, so compute
sections must synchronize on their outputs (`block=` argument) or the
measured time is the enqueue time, not the execution time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict


class FpsCounter:
    """Per-frame instantaneous FPS + running totals (main.cpp:243-246)."""

    def __init__(self):
        self._last = time.perf_counter()
        self._start = self._last
        self.total_frames = 0
        self.instant_fps = 0.0

    def tick(self, n: int = 1) -> float:
        now = time.perf_counter()
        delta = now - self._last
        self._last = now
        self.total_frames += n
        self.instant_fps = (n / delta) if delta > 0 else 0.0
        return self.instant_fps

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    @property
    def average_fps(self) -> float:
        e = self.elapsed
        return self.total_frames / e if e > 0 else 0.0

    def summary(self, kind: str = "Interactive") -> str:
        """Reference summary format (main.cpp:485-488)."""
        return (
            f"{kind} tracking summary: frames={self.total_frames}, "
            f"time={self.elapsed:.6g} s, FPS={self.average_fps:.6g}"
        )


class StageTimer:
    """Accumulating per-stage wall clock (cpub.cpp's decode/track/draw/write
    breakdown).  Use as `with timer.stage("decode"): ...`."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    class _Section:
        def __init__(self, timer: "StageTimer", name: str, block):
            self._timer = timer
            self._name = name
            self._block = block

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            if self._block is not None:
                import jax

                jax.block_until_ready(self._block)
            self._timer.totals[self._name] += time.perf_counter() - self._t0
            self._timer.counts[self._name] += 1

    def stage(self, name: str, block=None) -> "StageTimer._Section":
        """`block`: a jax pytree to block_until_ready before closing the
        section (REQUIRED for device compute, else you time the enqueue)."""
        return StageTimer._Section(self, name, block)

    def report(self) -> str:
        lines = ["Stage timing:"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"  {name:12s} total={total * 1e3:9.1f} ms  "
                f"calls={n:6d}  mean={total / n * 1e3:8.3f} ms"
            )
        return "\n".join(lines)


def profile_trace(log_dir: str):
    """jax.profiler trace context (SURVEY.md §5 tracing row): captures a
    TensorBoard-compatible device trace of everything inside the block."""
    import jax

    return jax.profiler.trace(log_dir)
