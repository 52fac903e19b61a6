"""End-to-end multi-stream serving: S live video streams from one process.

The reference serves exactly one stream per process (its tracking loop owns
the single capture handle, tracker_ghc/src/main.cpp:337-480); serving S
cameras there means S processes.  Here one device serves all S:

  decode      — one background decode/gray thread per stream
                (pvot.io.pipeline.FramePipeline: native C++ ring +
                bgr_to_gray_u8), all running concurrently with the device
  stage       — lockstep (C, S, H, W) uint8 chunks, wire size
  compute     — every chunk of every stream is ONE jitted scan of the
                vmapped multi-stream step (pvot.parallel.multi), with a
                per-stream validity mask
  fetch       — each chunk's records are packed on device and fetched one
                chunk late, so the fetch overlaps the next chunk's compute

Streams may end at different times: an ended stream's lanes carry invalid
padding frames (its state is frozen) until every stream is drained.

Heterogeneous inputs (mixed frame sizes / template sizes — the real
multi-camera case) serve through serve_streams_grouped: geometry groups,
one scan per group chunk, groups running concurrently in host threads.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from pvot.io.pipeline import FramePipeline


class _StreamFeed:
    """One stream's decode pipeline + lockstep chunk cursor.

    next_chunk() always returns a full (chunk_size, H, W) uint8 array; once
    the stream is exhausted it keeps returning (held last frame, n_real=0)
    so the lockstep loop can carry live streams to their own ends."""

    def __init__(self, frame_iter: Iterable[np.ndarray], frame_shape, chunk_size: int):
        self.pipe = FramePipeline(frame_iter, frame_shape, chunk_size=chunk_size)
        self._gen = self.pipe.chunks()
        self._shape = tuple(frame_shape)
        self._cs = chunk_size
        self._last: Optional[np.ndarray] = None
        self.done = False

    def next_chunk(self) -> Tuple[np.ndarray, int]:
        if not self.done:
            try:
                chunk, n = next(self._gen)
                self._last = np.array(chunk[n - 1]) if n else self._last
                return chunk, n
            except StopIteration:
                self.done = True
        base = (
            self._last
            if self._last is not None
            else np.zeros(self._shape, np.uint8)
        )
        return np.broadcast_to(base, (self._cs, *self._shape)), 0

    def close(self) -> None:
        self.pipe.close()


def _empty_objects_output(k_objects: int):
    """A zero-frame StepOutput in serve_objects' documented (F, K) layout."""
    from pvot.tracker.state import StepOutput

    return StepOutput(
        bbox=np.zeros((0, k_objects, 4), np.int32),
        score=np.zeros((0, k_objects), np.float32),
        used_global=np.zeros((0, k_objects), bool),
        updated=np.zeros((0, k_objects), bool),
    )


def serve_streams(
    frame_iters: Sequence[Iterable[np.ndarray]],
    states,
    frame_shape: Tuple[int, int],
    config=None,
    backend: str = "xla",
    chunk_size: int = 32,
    timings: Optional[list] = None,
    devices: Optional[Sequence] = None,
):
    """Serve S live frame streams end to end with decode/compute overlap.

    frame_iters: S iterables yielding uint8 BGR (H, W, 3) or gray (H, W)
    frames (different lengths allowed).  states: a stacked TrackerState
    with leading S axis (pvot.parallel.multi.init_multi_state layout).
    backend names the NCC engine (pvot.ops.backends).

    Returns (final stacked TrackerState, list of S host StepOutputs — one
    per stream, each with that stream's own frame count).  timings, when
    given a list, receives one (frames_committed, seconds) pair per
    lockstep chunk.

    devices: a sequence of jax.Devices to spread the streams over — pure
    host-driven data parallelism (streams are independent, so no
    collectives are needed: each device serves its contiguous stream group
    through its own pipelined loop in its own host thread, and dispatches
    interleave across devices).  The per-group drivers are exactly the
    single-device path, so semantics are unchanged; `timings` then holds
    each group's per-chunk pairs concatenated group by group.  None
    (default) serves everything on the default device.
    """
    from pvot.config import TrackerConfig

    config = config or TrackerConfig()
    n_streams = int(np.shape(states.t_mean)[0])
    if len(frame_iters) != n_streams:
        raise ValueError(
            f"{len(frame_iters)} frame iterators for {n_streams} states"
        )
    if devices is not None and len(devices) > 1:
        return _serve_streams_multidevice(
            frame_iters, states, frame_shape, config, backend, chunk_size,
            timings, list(devices),
        )
    device = devices[0] if devices else None
    return _serve_streams_scan(
        frame_iters, states, frame_shape, config, backend, chunk_size,
        timings, device,
    )


def _serve_streams_multidevice(
    frame_iters,
    states,
    frame_shape,
    config,
    backend: str,
    chunk_size: int,
    timings: Optional[list],
    devices: list,
):
    """Fan the streams out over devices: contiguous groups, one pipelined
    single-device driver per group in its own host thread.  Streams are
    independent so no collectives are involved; dispatches interleave
    across devices while every group keeps the single-device semantics."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    n_streams = len(frame_iters)
    # Contiguous groups, sizes within one of each other; empty groups drop.
    n_dev = min(len(devices), n_streams)
    bounds = [round(g * n_streams / n_dev) for g in range(n_dev + 1)]
    groups = [
        (bounds[g], bounds[g + 1], devices[g])
        for g in range(n_dev)
        if bounds[g + 1] > bounds[g]
    ]

    def run_group(lo, hi, device):
        group_states = jax.tree.map(lambda a: a[lo:hi], states)
        group_timings: Optional[list] = [] if timings is not None else None
        final, outs = _serve_streams_scan(
            frame_iters[lo:hi], group_states, frame_shape, config, backend,
            chunk_size, group_timings, device,
        )
        # Decommit so cross-device finals can restack on the default device.
        return jax.tree.map(np.asarray, final), outs, group_timings

    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        futures = [pool.submit(run_group, lo, hi, d) for lo, hi, d in groups]
        results = [f.result() for f in futures]

    finals = [r[0] for r in results]
    final = jax.tree.map(
        lambda *xs: jnp.concatenate([jnp.atleast_1d(x) for x in xs]), *finals
    )
    outs = [o for _, group_outs, _ in results for o in group_outs]
    if timings is not None:
        for _, _, gt in results:
            timings.extend(gt or [])
    return final, outs


def serve_streams_grouped(
    frame_iters: Sequence[Iterable[np.ndarray]],
    states_list: Sequence,
    frame_shapes: Sequence[Tuple[int, int]],
    config=None,
    backend: str = "xla",
    chunk_size: int = 32,
    timings: Optional[list] = None,
    devices: Optional[Sequence] = None,
):
    """Serve S live streams with HETEROGENEOUS geometries: streams may
    differ in frame size and/or template size — the real multi-camera case
    the homogeneous serve_streams layout (one stacked template) cannot
    express.

    Streams group by (frame_shape, template_shape); each group serves
    through the ordinary serve_streams driver in its own host thread, so
    the groups' device dispatches interleave exactly like the devices=
    fan-out's (streams are independent; no collectives).  Per-stream
    semantics are identical to serving each group alone.

    frame_iters: S frame iterables.  states_list: S SINGLE-stream
    TrackerStates (pvot.init_state), one per stream — unlike serve_streams
    there is no stacked layout to build, since shapes differ.
    frame_shapes: S (H, W) pairs.  devices: optional device list; groups
    round-robin over it (group g on devices[g % len]).

    Returns (list of S final single-stream TrackerStates, list of S host
    StepOutputs) in input order.  timings, when given, receives each
    group's per-chunk (frames, seconds) pairs concatenated group by group
    (groups run concurrently, so pairs interleave in wall time).
    """
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from pvot.config import TrackerConfig

    config = config or TrackerConfig()
    n = len(frame_iters)
    if len(states_list) != n or len(frame_shapes) != n:
        raise ValueError(
            f"{n} frame iterators for {len(states_list)} states / "
            f"{len(frame_shapes)} frame shapes"
        )
    groups: dict = {}  # (frame_shape, templ_shape) -> [stream indices]
    for s in range(n):
        key = (
            tuple(frame_shapes[s]),
            tuple(np.shape(states_list[s].template)),
        )
        groups.setdefault(key, []).append(s)
    group_list = list(groups.items())

    def run_group(gi, key, idxs):
        stacked = jax.tree.map(
            lambda *xs: jnp.stack(xs), *[states_list[i] for i in idxs]
        )
        group_timings: Optional[list] = [] if timings is not None else None
        dev = [devices[gi % len(devices)]] if devices else None
        final, outs = serve_streams(
            [frame_iters[i] for i in idxs], stacked, key[0], config,
            backend=backend, chunk_size=chunk_size, timings=group_timings,
            devices=dev,
        )
        return final, outs, group_timings

    if len(group_list) == 1:
        results = [run_group(0, *group_list[0])]
    else:
        with ThreadPoolExecutor(max_workers=len(group_list)) as pool:
            futures = [
                pool.submit(run_group, gi, key, idxs)
                for gi, (key, idxs) in enumerate(group_list)
            ]
            results = [f.result() for f in futures]

    finals: list = [None] * n
    outs_by_stream: list = [None] * n
    for (_, idxs), (final, outs, gt) in zip(group_list, results):
        for pos, s in enumerate(idxs):
            finals[s] = jax.tree.map(lambda a: a[pos], final)
            outs_by_stream[s] = outs[pos]
        if timings is not None:
            timings.extend(gt or [])
    return finals, outs_by_stream


def serve_objects(
    frame_iter: Iterable[np.ndarray],
    states,
    frame_shape: Tuple[int, int],
    config=None,
    backend: str = "xla",
    chunk_size: int = 32,
    timings: Optional[list] = None,
):
    """Serve ONE live frame stream with K trackers end to end — the
    multi-object analog of serve_streams: a single decode thread, every
    chunk one jitted scan of the vmapped multi-object step
    (pvot.parallel.multi), chunk fetches overlapped one chunk deep.

    `states` is a stacked TrackerState (leading K axis).  States from
    pvot.parallel.multi.init_multi_state_bucketed (mixed template sizes,
    detected by bbox extents differing from the template bucket) run the
    traced-extent bucketed step, which has its own matmul NCC; `backend`
    then does not apply.  Returns (final stacked TrackerState, host
    StepOutput with the (F, K) leading layout — all lanes share the
    stream's length)."""
    import jax

    from pvot.config import TrackerConfig

    config = config or TrackerConfig()
    h, w = frame_shape
    th, tw = states.template.shape[-2:]
    # All lanes share the stream's validity, so the plain per-frame mask
    # suffices.  Chunk fetches overlap one chunk deep, like every sibling
    # driver here: pack on device, fetch async, drain one chunk late.
    from pvot.parallel.multi import (
        is_bucketed,
        make_multi_step,
        make_multi_step_bucketed,
    )
    from pvot.tracker.scan import (
        _pack_outputs,
        _unpack_outputs,
        make_masked_scan_fn,
    )
    from pvot.tracker.state import StepOutput

    k_objects = int(np.shape(states.t_mean)[0])
    if is_bucketed(states):
        step = make_multi_step_bucketed((h, w), (th, tw), config)
    else:
        step = make_multi_step(
            (h, w), (th, tw), config, strategy="fused", backend=backend
        )
    scan_fn = make_masked_scan_fn(step)
    pipe = FramePipeline(frame_iter, frame_shape, chunk_size=chunk_size)
    outs = []
    st = states
    pending = None  # (device packed outs (C, K, 7), n_real)
    mark = time.perf_counter()

    def drain(entry):
        nonlocal mark
        packed, n = entry
        outs.append(_unpack_outputs(np.asarray(packed)[:n]))  # (n, K, 7)
        now = time.perf_counter()
        if timings is not None:
            timings.append((n, now - mark))
        mark = now

    try:
        for chunk, n_real in pipe.chunks():
            valid = np.arange(chunk_size) < n_real
            st, out = scan_fn(
                st, jax.device_put(chunk), jax.device_put(valid)
            )
            packed = _pack_outputs(out)
            packed.copy_to_host_async()
            if pending is not None:
                drain(pending)
            pending = (packed, n_real)
        if pending is not None:
            drain(pending)
    finally:
        pipe.close()
    if not outs:
        return st, _empty_objects_output(k_objects)
    return st, StepOutput(*(np.concatenate(xs) for xs in zip(*outs)))


def _serve_streams_scan(
    frame_iters,
    states,
    frame_shape,
    config,
    backend: str,
    chunk_size: int,
    timings: Optional[list],
    device=None,
):
    import jax

    from pvot.parallel.multi import (
        make_multi_stream_step,
        make_stream_masked_scan_fn,
    )
    from pvot.tracker.scan import (
        _pack_outputs,
        _stack_outputs,
        _unpack_outputs,
    )
    from pvot.tracker.state import StepOutput

    h, w = frame_shape
    th, tw = states.template.shape[-2:]
    n_streams = len(frame_iters)
    step = make_multi_stream_step(
        (h, w), (th, tw), config, strategy="fused", backend=backend
    )
    scan_fn = make_stream_masked_scan_fn(step)

    feeds = [_StreamFeed(it, frame_shape, chunk_size) for it in frame_iters]
    outs: List[list] = [[] for _ in range(n_streams)]
    st = jax.device_put(states, device) if device is not None else states
    pending = None  # (device packed outs, n_real) — one-chunk fetch overlap
    mark = time.perf_counter()

    def drain(entry):
        nonlocal mark
        packed, n_real = entry
        host = np.asarray(packed)  # (C, S, 7)
        for s in range(n_streams):
            n = int(n_real[s])
            if n == 0:
                continue
            outs[s].append(_unpack_outputs(host[:n, s]))
        now = time.perf_counter()
        if timings is not None:
            timings.append((int(n_real.sum()), now - mark))
        mark = now

    try:
        while True:
            chunks = [f.next_chunk() for f in feeds]
            n_real = np.array([n for _, n in chunks], np.int32)
            if not n_real.any():
                break
            frames = np.stack([c for c, _ in chunks], axis=1)  # (C, S, H, W)
            valid = np.arange(chunk_size)[:, None] < n_real[None, :]
            st, out = scan_fn(
                st,
                jax.device_put(frames, device),
                jax.device_put(valid, device),
            )
            packed = _pack_outputs(out)
            packed.copy_to_host_async()
            if pending is not None:
                drain(pending)
            pending = (packed, n_real)
        if pending is not None:
            drain(pending)
    finally:
        for f in feeds:
            f.close()
    return st, [_stack_outputs(o) for o in outs]
