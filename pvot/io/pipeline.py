"""Host streaming pipeline: decode -> native gray -> ring -> device chunks.

The reference decodes, converts, and copies synchronously inside its tracking
loop (tracker_ghc/src/main.cpp:362-365 + the per-call cudaMemcpy in every op,
baseline_kernel.cu:278-279) — nothing overlaps.  Here a background thread
decodes and gray-converts (native C++ kernels, pvot.runtime.native) into a
lock-free ring; the consumer pops chunk-sized uint8 arrays and ships them to
the device while the device scans the previous chunk.  The tail chunk is
zero-padded with a validity count, matching the masked-scan contract
(pvot.tracker.scan.make_masked_scan_fn).
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np


class FramePipeline:
    """Background decode/convert into a frame ring; iterate device chunks.

    frame_iter: yields uint8 BGR (H, W, 3) or gray (H, W) frames.
    Produces (chunk (chunk_size, H, W) uint8, n_real) pairs; the last chunk
    may be padded (repeat of the final frame) with n_real < chunk_size.
    """

    def __init__(
        self,
        frame_iter: Iterable[np.ndarray],
        frame_shape: Tuple[int, int],
        chunk_size: int = 32,
        capacity: int = 256,
        use_native: bool = True,
    ):
        self._iter = iter(frame_iter)
        self._shape = tuple(frame_shape)
        self.chunk_size = chunk_size
        self._done = threading.Event()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._use_native = use_native
        from pvot.runtime import native

        if use_native and native.available():
            self._ring = native.FrameRing(capacity, self._shape)
            self._convert = native.bgr_to_gray_u8
        else:  # pure-Python fallback ring
            from collections import deque

            self._ring = None
            self._queue = deque()
            self._qlock = threading.Lock()
            self._capacity = capacity
            from pvot.io.gray import bgr_to_gray_u8

            self._convert = bgr_to_gray_u8
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- producer -----------------------------------------------------------
    def _push(self, frame: np.ndarray) -> None:
        if self._ring is not None:
            while not self._ring.push(frame):
                if self._stop.is_set():
                    return
                time.sleep(0.0005)
        else:
            while not self._stop.is_set():
                with self._qlock:
                    if len(self._queue) < self._capacity:
                        self._queue.append(frame)
                        return
                time.sleep(0.0005)

    def _worker(self) -> None:
        try:
            for frame in self._iter:
                if self._stop.is_set():
                    return
                if frame.ndim == 3:
                    frame = self._convert(frame)
                if frame.shape != self._shape:
                    raise ValueError(
                        f"frame shape {frame.shape} != pipeline {self._shape}"
                    )
                self._push(np.ascontiguousarray(frame, np.uint8))
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
        finally:
            self._done.set()

    # -- consumer -----------------------------------------------------------
    def _pop(self, max_frames: int) -> np.ndarray:
        if self._ring is not None:
            return self._ring.pop(max_frames)
        out = []
        with self._qlock:
            while self._queue and len(out) < max_frames:
                out.append(self._queue.popleft())
        return (
            np.stack(out) if out else np.zeros((0, *self._shape), np.uint8)
        )

    def chunks(self) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (padded chunk, n_real) until the stream is exhausted."""
        pending = np.zeros((0, *self._shape), np.uint8)
        while True:
            got = self._pop(self.chunk_size - len(pending))
            pending = np.concatenate([pending, got]) if len(got) else pending
            stream_over = self._done.is_set() and self._pop_peek_empty()
            if len(pending) == self.chunk_size:
                yield pending, self.chunk_size
                pending = pending[:0]
            elif stream_over:
                if self._error is not None:
                    raise self._error
                if len(pending):
                    n_real = len(pending)
                    pad = np.repeat(
                        pending[-1:], self.chunk_size - n_real, axis=0
                    )
                    yield np.concatenate([pending, pad]), n_real
                return
            else:
                time.sleep(0.0005)

    def _pop_peek_empty(self) -> bool:
        if self._ring is not None:
            return len(self._ring) == 0
        with self._qlock:
            return not self._queue

    def close(self) -> None:
        """Stop the producer, join it, THEN free the native ring.

        Destroying the ring while the decode thread is still blocked inside
        _push would hand a freed C struct to pvot_ring_push (use-after-free);
        the stop event breaks that spin first and the join guarantees no
        native call is in flight when the ring is destroyed."""
        self._stop.set()
        self._thread.join(timeout=30)
        if self._ring is not None:
            self._ring.close()
            self._ring = None


def track_stream(
    frame_iter: Iterable[np.ndarray],
    state,
    frame_shape: Tuple[int, int],
    config=None,
    strategy: str = "fused",
    backend: str = "xla",
    chunk_size: int = 32,
    timings: Optional[list] = None,
):
    """Track a frame stream end to end with decode/compute overlap.

    Returns (final_state, StepOutput) like pvot.track_video, but frames are
    decoded and converted concurrently with device tracking.

    timings, when given a list, receives one (n_frames, seconds) pair per
    chunk in output order — the per-chunk amortized frame rate the CLI
    burns into recorded frames (the reference burns per-frame tick-delta
    FPS, tracker_ghc/src/main.cpp:470-478; a scanned chunk is this
    pipeline's smallest honestly-timeable unit).
    """
    import jax

    from pvot.config import TrackerConfig
    from pvot.tracker.scan import _cached_masked_scan, _stack_outputs

    config = config or TrackerConfig()
    h, w = frame_shape
    th, tw = state.template.shape
    scan_fn = _cached_masked_scan(
        (h, w), (th, tw), config, strategy, backend, "uint8", chunk_size
    )
    pipe = FramePipeline(frame_iter, frame_shape, chunk_size=chunk_size)
    outs = []
    # Fetch each chunk's per-frame records eagerly (they are tiny:
    # bbox/score/flags).  This bounds device-side output memory and is the
    # natural streaming contract (results arrive as the stream advances).
    # The fetch is async
    # (copy_to_host_async) and materializes one chunk LATE, so chunk k's
    # host conversion overlaps chunk k+1's dispatch.
    pending = None  # (device-sliced leaves, n_real)
    mark = time.perf_counter()

    def drain(entry):
        nonlocal mark
        sliced, n = entry
        outs.append(jax.tree.map(np.asarray, sliced))
        now = time.perf_counter()
        if timings is not None:
            timings.append((n, now - mark))
        mark = now

    try:
        for chunk, n_real in pipe.chunks():
            valid = np.arange(chunk_size) < n_real
            state, out = scan_fn(
                state, jax.device_put(chunk), jax.device_put(valid)
            )
            sliced = jax.tree.map(lambda a: a[:n_real], out)
            for leaf in jax.tree.leaves(sliced):
                leaf.copy_to_host_async()
            if pending is not None:
                drain(pending)
            pending = (sliced, n_real)
        if pending is not None:
            drain(pending)
    finally:
        pipe.close()
    return state, _stack_outputs(outs)


def track_stream_batched(
    frame_iter: Iterable[np.ndarray],
    state,
    frame_shape: Tuple[int, int],
    config=None,
    batch_size: Optional[int] = None,
    strategy: str = "fused",
    backend: str = "xla",
    chunks_per_dispatch: int = 8,
    timings: Optional[list] = None,
):
    """Reference-parity batch mode (--batch=N) over a frame stream.

    Same semantics as pvot.tracker.scan.track_video_batched (C10: one state
    update per batch against the batch's LAST frame; leftover frames that
    never fill a batch re-emit the previous bbox with no update,
    tracker_ghc/src/main.cpp:385-397) but frames are decoded/converted by the
    pipeline concurrently with device tracking — memory stays bounded by the
    ring capacity, never the clip length.
    """
    import jax

    from pvot.config import TrackerConfig
    from pvot.tracker.scan import (
        _stack_outputs,
        leftover_tail,
        make_batched_scan_fn,
        slice_batch_outputs,
    )

    config = config or TrackerConfig()
    n = batch_size or config.batch_size
    h, w = frame_shape
    th, tw = state.template.shape
    group = max(1, chunks_per_dispatch)
    scan_fn = make_batched_scan_fn(
        (h, w), (th, tw), config, n, strategy, backend
    )

    # One pipeline chunk = one dispatch group of `group` batches; only the
    # final chunk can be partial (mid-stream chunks are always full).
    pipe = FramePipeline(frame_iter, frame_shape, chunk_size=n * group)
    outs = []
    leftover = 0
    mark = time.perf_counter()
    try:
        for chunk, n_real in pipe.chunks():
            k_full = n_real // n
            leftover = n_real - k_full * n
            batches = chunk.reshape(group, n, h, w)
            valid = np.arange(group) < k_full
            state, out = scan_fn(
                state, jax.device_put(batches), jax.device_put(valid)
            )
            if k_full:
                # Eager per-group fetch, same rationale as track_stream.
                outs.append(
                    jax.tree.map(np.asarray, slice_batch_outputs(out, k_full))
                )
                now = time.perf_counter()
                if timings is not None:
                    timings.append((k_full * n, now - mark))
                mark = now
    finally:
        pipe.close()
    if leftover:
        outs.append(leftover_tail(state, leftover, outs))
    return state, _stack_outputs(outs)
