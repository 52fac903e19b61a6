"""Scanned tracking drivers: sequential, chunked, and look-ahead batch modes.

The reference's tracking loop is strictly sequential (frame t+1 needs frame
t's bbox/template, tracker_ghc/src/main.cpp:362-480); here that dependency is
a `jax.lax.scan` carry, so a whole chunk of frames runs as ONE device dispatch
instead of the reference's per-frame launch + PCIe round-trip
(tracker_ghc/src/baseline_kernel.cu:274-292).

Batch mode (--batch=N) reproduces the reference's semantics exactly
(component C10, SURVEY.md §2a; tracker_ghc/src/main.cpp:385-397): the first
N-1 frames of every batch just re-emit the previous bbox; the state update
runs once per batch against the LAST frame's NCC map.  Since the reference
discards the other N-1 maps, applying the single-frame step to the last frame
is behaviorally identical (lost_count/use_global only advance on update
frames because the loop `continue`s before that logic, main.cpp:387-392).
Leftover frames that never fill a batch get no update, also as in the
reference.  An "improved" batch mode — per-frame updates with chunked
dispatch — is simply the default scan driver.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pvot.config import TrackerConfig
from pvot.tracker.state import StepOutput, TrackerState
from pvot.tracker.step import make_step


def make_scan_fn(step, donate: bool = False):
    """jit(scan(step)) over a chunk of frames: (state, (C,H,W)) -> (state, outs).

    donate defaults to False: donating invalidates the caller's initial
    state buffer on an accelerator (a reuse footgun CPU tests cannot catch,
    because donation is a no-op there).  The state is tiny (~25 KB
    template), so donation buys nothing; opt in only for throwaway states."""

    def scan_chunk(state: TrackerState, frames: jax.Array):
        return lax.scan(step, state, frames)

    return jax.jit(scan_chunk, donate_argnums=(0,) if donate else ())


def make_masked_scan_fn(step, donate: bool = False):
    """Like make_scan_fn but each frame carries a validity flag; invalid
    (padding) frames leave the state untouched.  Lets every chunk share ONE
    compiled program regardless of how many real frames the tail chunk has,
    so a clip of any length compiles once.  donate defaults to False for the
    same reuse reason as make_scan_fn."""

    def masked_step(state: TrackerState, xs):
        frame, valid = xs
        new_state, out = step(state, frame)
        keep = lambda new, old: jnp.where(valid, new, old)
        return jax.tree.map(keep, new_state, state), out

    def scan_chunk(state: TrackerState, frames: jax.Array, valid: jax.Array):
        return lax.scan(masked_step, state, (frames, valid))

    return jax.jit(scan_chunk, donate_argnums=(0,) if donate else ())


def as_frames(frames):
    """Normalize a frames argument: host inputs become numpy; DEVICE-RESIDENT
    jax arrays stay put.  Pre-staged clips then slice/pad on device and
    re-tracking never re-crosses the host->device link."""
    if isinstance(frames, jax.Array):
        return frames
    return np.asarray(frames)


def pad_tail(chunk, n_pad: int, axis: int = 0):
    """Repeat the last frame along `axis` n_pad times — numpy for host
    chunks, jnp (on device, no host round trip) for device-resident ones."""
    xp = jnp if isinstance(chunk, jax.Array) else np
    last = xp.take(chunk, chunk.shape[axis] - 1, axis=axis)
    last = xp.expand_dims(last, axis)
    return xp.concatenate(
        [chunk, xp.repeat(last, n_pad, axis=axis)], axis=axis
    )


# Compiled-scan cache: geometry + config + strategy/backend + chunk layout.
_SCAN_CACHE = {}


def _cached_masked_scan(frame_shape, templ_shape, config, strategy, backend,
                        dtype_str, chunk_size):
    key = (frame_shape, templ_shape, config, strategy, backend, dtype_str, chunk_size)
    fn = _SCAN_CACHE.get(key)
    if fn is None:
        from pvot.ops.backends import get_backend

        full_fn, region_fn = get_backend(
            backend, frame_shape, templ_shape, config
        )
        step = make_step(
            frame_shape, templ_shape, config,
            ncc_full_fn=full_fn, ncc_region_fn=region_fn, strategy=strategy,
        )
        # No donation: the state is tiny (the template dominates at ~25 KB)
        # and donating would invalidate a caller's initial state if they
        # track two clips from the same starting point.
        fn = make_masked_scan_fn(step, donate=False)
        _SCAN_CACHE[key] = fn
    return fn


def _stack_outputs(outs) -> StepOutput:
    """Concatenate per-chunk outputs and fetch to host ONCE.

    Chunks keep their outputs on device; the concatenation happens
    device-side and a single fetch lands everything, so a clip pays one
    device->host round trip.  Host-side (numpy) chunks concatenate for free.
    """
    if not outs:
        empty = StepOutput(
            bbox=np.zeros((0, 4), np.int32),
            score=np.zeros((0,), np.float32),
            used_global=np.zeros((0,), bool),
            updated=np.zeros((0,), bool),
        )
        return empty
    if isinstance(outs[0].score, np.ndarray):
        return StepOutput(*(np.concatenate(xs) for xs in zip(*outs)))
    dev = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
    # Both the single-object (F,) and multi-object/stream (F, K) layouts
    # pack into one transfer.
    return fetch_outputs(dev)


@jax.jit
def _pack_outputs(out: StepOutput) -> jnp.ndarray:
    """Pack all per-frame outputs into ONE f32 buffer: a single device->host
    transfer instead of four.  bbox coordinates are exact in f32 (|v| < 2^24).  Works for the single-object
    (F, ...) and multi-object/stream (F, K, ...) layouts alike: the packed
    axis is the trailing one."""
    return jnp.concatenate(
        [
            out.bbox.astype(jnp.float32),
            out.score[..., None].astype(jnp.float32),
            out.used_global[..., None].astype(jnp.float32),
            out.updated[..., None].astype(jnp.float32),
        ],
        axis=-1,
    )


def _unpack_outputs(host: np.ndarray) -> StepOutput:
    """Inverse of _pack_outputs on a fetched host array of shape (..., 7).

    The single source of truth for the packed column layout — every driver
    that fetches a _pack_outputs buffer unpacks through here."""
    return StepOutput(
        bbox=host[..., 0:4].astype(np.int32),
        score=host[..., 4].copy(),
        used_global=host[..., 5] != 0.0,
        updated=host[..., 6] != 0.0,
    )


def fetch_outputs(dev: StepOutput) -> StepOutput:
    """Single-transfer fetch of a device-side StepOutput (frames[, K], ...)."""
    packed = _pack_outputs(dev)
    packed.copy_to_host_async()
    return _unpack_outputs(np.asarray(packed))


def track_video(
    frames: np.ndarray,
    state: TrackerState,
    config: TrackerConfig = TrackerConfig(),
    strategy: str = "fused",
    backend: str = "xla",
    chunk_size: int = 32,
    step=None,
) -> Tuple[TrackerState, StepOutput]:
    """Track a pre-decoded gray video (F, H, W) uint8/f32.

    Frames are shipped to the device in chunks; each chunk is one scanned
    dispatch.  Enqueueing is async, so the host uploads chunk k+1 while the
    device scans chunk k.  Device-resident frames (a jax.Array) are accepted
    and never re-cross the link (as_frames).
    """
    frames = as_frames(frames)
    if frames.ndim != 3:
        raise ValueError(f"expected (F, H, W) frames, got {frames.shape}")
    f, h, w = frames.shape
    th, tw = state.template.shape
    if step is not None:
        scan_fn = make_masked_scan_fn(step)
    else:
        scan_fn = _cached_masked_scan(
            (h, w), (th, tw), config, strategy, backend, str(frames.dtype), chunk_size
        )
    outs = []
    for start in range(0, f, chunk_size):
        chunk = frames[start : start + chunk_size]
        n_real = chunk.shape[0]
        if n_real < chunk_size:  # pad the tail; padded frames are masked out
            chunk = pad_tail(chunk, chunk_size - n_real)
        valid = np.arange(chunk_size) < n_real
        state, out = scan_fn(state, jax.device_put(chunk), jax.device_put(valid))
        outs.append(jax.tree.map(lambda a: a[:n_real], out))
    return state, _stack_outputs(outs)


def make_batch_step(step, batch_size: int):
    """Look-ahead batch step with the reference's last-frame-only update
    semantics (C10).  Consumes (batch_size, H, W); emits per-frame outputs."""

    def batch_step(state: TrackerState, chunk: jax.Array):
        pre_bbox = jnp.stack([state.bbox_x, state.bbox_y, state.bbox_w, state.bbox_h])
        new_state, last_out = step(state, chunk[-1])
        n = batch_size
        bboxes = jnp.concatenate(
            [jnp.tile(pre_bbox[None, :], (n - 1, 1)), last_out.bbox[None, :]], axis=0
        )
        scores = jnp.concatenate(
            [jnp.full((n - 1,), -1.0, jnp.float32), last_out.score[None]]
        )
        used_global = jnp.concatenate(
            [jnp.zeros((n - 1,), bool), last_out.used_global[None]]
        )
        updated = jnp.concatenate([jnp.zeros((n - 1,), bool), last_out.updated[None]])
        return new_state, StepOutput(bboxes, scores, used_global, updated)

    return batch_step


def make_batched_scan_fn(
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig,
    batch_size: int,
    strategy: str = "fused",
    backend: str = "xla",
):
    """Jitted masked scan over look-ahead batches: (state, batches
    (K, n, H, W), valid (K,)) -> (state, outs).  The C10 parity core shared
    by the array driver (track_video_batched) and the streaming driver
    (pvot.io.pipeline.track_stream_batched)."""
    from pvot.ops.backends import get_backend

    full_fn, region_fn = get_backend(backend, frame_shape, templ_shape, config)
    step = make_step(
        frame_shape, templ_shape, config,
        ncc_full_fn=full_fn, ncc_region_fn=region_fn, strategy=strategy,
    )
    batch_step = make_batch_step(step, batch_size)

    def masked_batch_step(state, xs):
        batch, valid = xs
        new_state, out = batch_step(state, batch)
        keep = lambda new, old: jnp.where(valid, new, old)
        return jax.tree.map(keep, new_state, state), out

    def scan_batches(state, batches, valid):
        return lax.scan(masked_batch_step, state, (batches, valid))

    return jax.jit(scan_batches)


def slice_batch_outputs(out: StepOutput, k_real: int) -> StepOutput:
    """Flatten the first k_real batches of a (K, n, ...) batched-scan output
    into per-frame records."""
    return StepOutput(
        bbox=out.bbox[:k_real].reshape(-1, 4),
        score=out.score[:k_real].reshape(-1),
        used_global=out.used_global[:k_real].reshape(-1),
        updated=out.updated[:k_real].reshape(-1),
    )


def leftover_tail(state: TrackerState, leftover: int, outs) -> StepOutput:
    """Records for end-of-video frames that never filled a batch: previous
    bbox re-emitted, no update (main.cpp:386-392 — the loop continues until
    the batch is full; end-of-video leaves it partial).  Matches the dtype
    family of `outs` so _stack_outputs concatenates cleanly."""
    state_np = jax.device_get(state)
    pre_bbox = np.array(
        [state_np.bbox_x, state_np.bbox_y, state_np.bbox_w, state_np.bbox_h],
        dtype=np.int32,
    )
    tail = StepOutput(
        bbox=np.tile(pre_bbox[None, :], (leftover, 1)),
        score=np.full((leftover,), -1.0, np.float32),
        used_global=np.zeros((leftover,), bool),
        updated=np.zeros((leftover,), bool),
    )
    if outs and not isinstance(outs[0].score, np.ndarray):
        tail = jax.tree.map(jnp.asarray, tail)
    return tail


def track_video_batched(
    frames: np.ndarray,
    state: TrackerState,
    config: TrackerConfig = TrackerConfig(),
    batch_size: Optional[int] = None,
    strategy: str = "fused",
    backend: str = "xla",
    chunks_per_dispatch: int = 8,
) -> Tuple[TrackerState, StepOutput]:
    """Reference-parity batch mode (--batch=N).

    Leftover frames that do not fill a final batch re-emit the previous bbox
    with no state update (main.cpp:386-392: the loop continues until the
    batch is full; end-of-video leaves it partial).
    """
    n = batch_size or config.batch_size
    frames = np.asarray(frames)
    f, h, w = frames.shape
    th, tw = state.template.shape
    scan_fn = make_batched_scan_fn((h, w), (th, tw), config, n, strategy, backend)

    num_full = f // n
    outs = []
    group = max(1, chunks_per_dispatch)
    for start in range(0, num_full, group):
        stop = min(num_full, start + group)
        batches = frames[start * n : stop * n].reshape(stop - start, n, h, w)
        k_real = stop - start
        if k_real < group:  # pad so every dispatch shares one compiled shape
            pad = np.repeat(batches[-1:], group - k_real, axis=0)
            batches = np.concatenate([batches, pad], axis=0)
        valid = np.arange(group) < k_real
        state, out = scan_fn(state, jax.device_put(batches), jax.device_put(valid))
        outs.append(slice_batch_outputs(out, k_real))
    leftover = f - num_full * n
    if leftover:
        outs.append(leftover_tail(state, leftover, outs))
    return state, _stack_outputs(outs)
