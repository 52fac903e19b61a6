"""Multi-chip sharded tracking via jax.sharding.Mesh + shard_map.

The reference is single-process/single-GPU with no communication backend
(SURVEY.md §2e); scaling here is a device mesh with named axes, explicit
shardings, and XLA collectives (NCCL on GPUs).

Two orthogonal parallel axes:

  "data"    — independent video streams (pure data parallelism; each device
              scans its own streams' tracker states).
  "search"  — tensor-style parallelism INSIDE one NCC search: the candidate
              window's rows are sliced across devices; each device scores its
              slab and the global argmax is combined with an all_gather +
              lexicographic reduction that preserves cv::minMaxLoc's
              row-major first-occurrence tie-break.

track_video_sharded scans a clip through the combined step; chip_smoke.py
--four-cards checks it against the unsharded step on four GPUs, and
__graft_entry__.dryrun_multichip rehearses it on virtual CPU devices.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pvot.config import TrackerConfig
from pvot.io.gray import ensure_gray_f32
from pvot.ops import search as search_ops
from pvot.ops.ncc_matmul import ncc_map_matmul
from pvot.ops.ncc_reference import template_stats
from pvot.tracker.state import StepOutput, TrackerState, is_bbox_outside_frame


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def make_search_sharded_step(
    mesh: Mesh,
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    data_axis: str = "data",
    search_axis: str = "search",
    backend: str = "xla",
):
    """Tracking step sharded over (streams x search-rows).

    Inputs inside jit:
      states: TrackerState with leading stream axis S (sharded over `data_axis`)
      frames: (S, H, W) f32/u8 (sharded over `data_axis`, replicated over
              `search_axis`)

    Per stream, the local-search candidate window (span_y x span_x) is split
    row-wise across `search_axis`: each device evaluates NCC on its slab,
    takes a local argmax, and the winners combine with an all_gather.
    Global (re-acquisition) search splits the full NCC map the same way.
    Row-major tie-breaking survives because slabs are ordered by y and the
    combine prefers (val, -y, -x) lexicographically.

    backend names the per-slab NCC engine: "xla" scores each slab with
    pvot.ops.ncc_matmul.ncc_map_matmul in one piece; any other name
    resolves through pvot.ops.backends to that engine's full-map scorer.
    """
    frame_h, frame_w = frame_shape
    templ_h, templ_w = templ_shape
    out_w = frame_w - templ_w + 1
    out_h = frame_h - templ_h + 1
    span_x = 2 * config.search_radius_x + 1
    span_y = 2 * config.search_radius_y + 1
    n_search = mesh.shape[search_axis]
    slab_y = _ceil_to(span_y, n_search) // n_search  # candidate rows per device
    full_slab = _ceil_to(out_h, n_search) // n_search  # global-map rows per device
    lr = float(config.template_update_lr)

    if backend == "xla":
        slab_map_fn = strip_map_fn = ncc_map_matmul
    else:
        from pvot.ops.backends import get_backend

        slab_map_fn = strip_map_fn = get_backend(
            backend, frame_shape, templ_shape, config
        )[0]

    def _lex_combine(val, x, y, axis_name):
        """all_gather winners and pick max val, ties -> smallest (y, x).

        Row-major position fits int32: out_h * out_w < 2^31 for any frame
        this tracker sees (checked at build time below)."""
        vals = lax.all_gather(val, axis_name)  # (P,)
        xs = lax.all_gather(x, axis_name)
        ys = lax.all_gather(y, axis_name)
        best = jnp.max(vals)
        is_best = vals >= best
        key = jnp.where(is_best, ys * out_w + xs, jnp.int32(2**31 - 1))
        idx = jnp.argmin(key)
        return vals[idx], xs[idx], ys[idx]

    if out_h * out_w >= 2**31:
        raise ValueError("NCC map too large for int32 position keys")
    if out_w < span_x or out_h < span_y:
        raise ValueError(
            "search-sharded step needs the NCC map to contain the candidate "
            f"span: out=({out_h}, {out_w}) < span=({span_y}, {span_x})"
        )

    def _slab_scores_local(frame, templ, t_mean, t_std, x0, y0, my):
        """Score this device's slab of the candidate window."""
        slab_y0 = y0 + my * slab_y
        # Clamp so the frame slice stays in bounds; masking fixes overlap.
        slab_y0 = jnp.minimum(slab_y0, out_h - slab_y)
        region = lax.dynamic_slice(
            frame, (slab_y0, x0), (slab_y + templ_h - 1, span_x + templ_w - 1)
        )
        return slab_map_fn(region, templ, t_mean, t_std), slab_y0

    def sharded_step(states: TrackerState, frames: jax.Array):
        def per_shard(states, frames):
            my = lax.axis_index(search_axis)

            # Structure note: the per-stream work is vmapped, and under
            # vmap lax.cond lowers to a select that executes BOTH branches
            # — so the expensive global full-map pass must NOT sit inside a
            # per-stream cond (the pvot.parallel.multi trap).  Instead: the cheap local slab
            # pass always runs (vmapped), and the global pass runs under a
            # SCALAR cond — only on frames where some local stream needs
            # re-acquisition — overlaid via where.  The predicate is
            # replicated over the search axis (states are), so every
            # search shard takes the same branch.

            def local_pass(state: TrackerState, frame: jax.Array):
                # Frame stays in wire dtype; slab/strip/patch slices convert
                # after slicing (pvot.io.gray.ensure_gray_f32, bit-exact).
                bbox_outside = is_bbox_outside_frame(
                    state.bbox_x, state.bbox_y, state.bbox_w, state.bbox_h,
                    frame_w, frame_h,
                )
                cx = state.bbox_x + state.bbox_w // 2
                cy = state.bbox_y + state.bbox_h // 2
                use_global = (
                    state.use_global
                    | bbox_outside
                    | (state.lost_count >= config.lost_frame_threshold)
                )
                if not config.enable_global_search:
                    use_global = jnp.zeros_like(use_global)
                bounds = search_ops.local_window_bounds(
                    cx, cy, templ_w, templ_h, out_w, out_h,
                    config.search_radius_x, config.search_radius_y,
                )
                global_argmax = use_global | ~bounds.valid

                x0, y0 = search_ops.region_origin(
                    bounds, out_w, out_h, span_x, span_y
                )
                scores, slab_y0 = _slab_scores_local(
                    frame, state.template, state.t_mean, state.t_std, x0, y0, my
                )
                # Mask to both the true window AND this slab's share to
                # avoid double-counting clamp overlap.
                sy, sx = scores.shape
                yy = slab_y0 + lax.broadcasted_iota(jnp.int32, (sy, sx), 0)
                xx = x0 + lax.broadcasted_iota(jnp.int32, (sy, sx), 1)
                share_lo = y0 + my * slab_y
                mask = (
                    (xx >= bounds.min_tx) & (xx <= bounds.max_tx)
                    & (yy >= bounds.min_ty) & (yy <= bounds.max_ty)
                    & (yy >= share_lo) & (yy < share_lo + slab_y)
                )
                v, rx, ry = search_ops.argmax2d(
                    jnp.where(mask, scores, search_ops.NEG_INF)
                )
                return use_global, global_argmax, v, x0 + rx, slab_y0 + ry

            use_global, global_k, l_val, l_x, l_y = jax.vmap(local_pass)(
                states, frames
            )

            def global_one(state: TrackerState, frame: jax.Array):
                gy0 = jnp.minimum(my * full_slab, out_h - full_slab)
                strip = lax.dynamic_slice(
                    frame, (gy0, 0), (full_slab + templ_h - 1, frame_w)
                )
                scores = strip_map_fn(
                    strip, state.template, state.t_mean, state.t_std
                )
                sy, sx = scores.shape
                yy = gy0 + lax.broadcasted_iota(jnp.int32, (sy, sx), 0)
                share_lo = my * full_slab
                mask = (yy >= share_lo) & (yy < share_lo + full_slab)
                v, rx, ry = search_ops.argmax2d(
                    jnp.where(mask, scores, search_ops.NEG_INF)
                )
                return v, rx, gy0 + ry

            def do_global(frames):
                return jax.vmap(global_one)(states, frames)

            def skip_global(frames):
                k = use_global.shape[0]
                return (
                    jnp.zeros((k,), jnp.float32),
                    jnp.zeros((k,), jnp.int32),
                    jnp.zeros((k,), jnp.int32),
                )

            g_val, g_x, g_y = lax.cond(
                jnp.any(global_k), do_global, skip_global, frames
            )
            cand_val = jnp.where(global_k, g_val, l_val)
            cand_x = jnp.where(global_k, g_x, l_x)
            cand_y = jnp.where(global_k, g_y, l_y)
            best_val, best_x, best_y = jax.vmap(
                lambda v, x, y: _lex_combine(v, x, y, search_axis)
            )(cand_val, cand_x, cand_y)

            def update_one(state, frame, best_val, best_x, best_y, ug, ga):
                # Replicated state update (identical on every search shard).
                threshold = jnp.where(
                    ug, config.global_confidence, config.min_confidence
                )
                accept = best_val >= threshold
                new_bx = jnp.where(accept, best_x, state.bbox_x)
                new_by = jnp.where(accept, best_y, state.bbox_y)
                new_bw = jnp.where(accept, jnp.int32(templ_w), state.bbox_w)
                new_bh = jnp.where(accept, jnp.int32(templ_h), state.bbox_h)
                lost = jnp.where(accept, jnp.int32(0), state.lost_count + 1)
                new_out = is_bbox_outside_frame(
                    new_bx, new_by, new_bw, new_bh, frame_w, frame_h
                )
                use_global_next = jnp.where(
                    accept & ~new_out, jnp.bool_(False), ug
                )
                strong = accept & (best_val >= config.strong_confidence)
                patch = ensure_gray_f32(
                    lax.dynamic_slice(frame, (new_by, new_bx), (templ_h, templ_w))
                )
                new_template = jnp.where(
                    strong, (1.0 - lr) * state.template + lr * patch, state.template
                )
                t_mean, t_std = lax.cond(
                    strong,
                    lambda t: template_stats(t),
                    lambda _: (state.t_mean, state.t_std),
                    new_template,
                )
                new_state = TrackerState(
                    new_bx, new_by, new_bw, new_bh,
                    new_template, t_mean, t_std, lost, use_global_next,
                )
                out = StepOutput(
                    bbox=jnp.stack([new_bx, new_by, new_bw, new_bh]),
                    score=best_val,
                    used_global=ga,
                    updated=accept,
                )
                return new_state, out

            return jax.vmap(update_one)(
                states, frames, best_val, best_x, best_y, use_global, global_k
            )

        state_spec = jax.tree.map(lambda _: P(data_axis), states)
        out_spec = (
            jax.tree.map(lambda _: P(data_axis), states),
            StepOutput(P(data_axis), P(data_axis), P(data_axis), P(data_axis)),
        )
        # check_vma can't prove the post-all_gather outputs are replicated
        # over the search axis (they are, by construction of _lex_combine).
        return jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(state_spec, P(data_axis, None, None)),
            out_specs=out_spec,
            check_vma=False,
        )(states, frames)

    return sharded_step


def make_data_parallel_multi_step(
    mesh: Mesh,
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    data_axis: str = "data",
    obj_axis: str = "obj",
    strategy: str = "fused",
    backend: str = "xla",
):
    """(streams x objects) sharded step: streams over `data_axis`, each
    stream's K objects over `obj_axis`.  Frames replicate across `obj_axis`;
    no collectives needed (embarrassingly parallel)."""
    from pvot.parallel.multi import make_multi_step

    multi_step = make_multi_step(frame_shape, templ_shape, config, strategy, backend)

    def per_shard(states, frames):
        # states leaves: (S_local, K_local, ...); frames: (S_local, H, W)
        return jax.vmap(multi_step)(states, frames)

    def step(states, frames):
        state_spec = jax.tree.map(lambda _: P(data_axis, obj_axis), states)
        out_spec = (
            state_spec,
            StepOutput(
                P(data_axis, obj_axis), P(data_axis, obj_axis),
                P(data_axis, obj_axis), P(data_axis, obj_axis),
            ),
        )
        return jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(state_spec, P(data_axis, None, None)),
            out_specs=out_spec,
            check_vma=False,
        )(states, frames)

    return step


def shard_states(mesh: Mesh, states: TrackerState, spec: P) -> TrackerState:
    """Place a batched TrackerState onto the mesh with the given spec."""
    return jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, spec)), states
    )


def make_sharded_scan_fn(sharded_step):
    """jit(scan(masked sharded_step)) over a frame chunk.

    (S-states, frames (C, S, H, W), valid (C,)) -> (S-states, outs (C, S)).
    Invalid (padding) frames leave the state untouched, so every chunk
    shares one compiled program (the pvot.tracker.scan masked-scan contract,
    here applied across a mesh: the scan carry is the sharded state pytree
    and each scan step runs the shard_map'd collective step)."""
    import jax.numpy as jnp

    def masked_step(states: TrackerState, xs):
        frames, valid = xs
        new_states, out = sharded_step(states, frames)
        keep = lambda new, old: jnp.where(valid, new, old)
        return jax.tree.map(keep, new_states, states), out

    def scan_chunk(states: TrackerState, frames, valid):
        return lax.scan(masked_step, states, (frames, valid))

    return jax.jit(scan_chunk)


def track_video_sharded(
    videos: np.ndarray,
    states: TrackerState,
    mesh: Mesh,
    config: TrackerConfig = TrackerConfig(),
    chunk_size: int = 16,
    data_axis: str = "data",
    search_axis: str = "search",
    backend: str = "xla",
):
    """Scan S video streams across a device mesh: the multi-device analog
    of pvot.tracker.scan.track_video.  `backend` picks the per-slab NCC
    engine (make_search_sharded_step).

    videos: (S, F, H, W) uint8/f32 — S lockstep streams of F frames each.
    states: TrackerState with leading stream axis S (sharded over
    `data_axis`, or unsharded — it is placed onto the mesh here).

    Each chunk of `chunk_size` frames is ONE device dispatch: a lax.scan
    whose carry is the sharded state and whose body runs the
    (data x search)-sharded collective step (make_search_sharded_step).
    Streams ride `data_axis`; each NCC search splits row-wise over
    `search_axis` and recombines with an all_gather, so trajectories are
    EXACTLY those of the unsharded per-stream tracker (asserted in
    tests/test_parallel.py).

    Returns (final states, StepOutput with (F, S) leading axes).
    """
    videos = np.asarray(videos)
    if videos.ndim != 4:
        raise ValueError(f"expected (S, F, H, W) videos, got {videos.shape}")
    s, f, h, w = videos.shape
    th, tw = states.template.shape[-2:]
    states = shard_states(mesh, states, P(data_axis))
    step = make_search_sharded_step(
        mesh, (h, w), (th, tw), config, data_axis, search_axis,
        backend=backend,
    )
    scan_fn = make_sharded_scan_fn(step)
    frame_sharding = NamedSharding(mesh, P(None, data_axis, None, None))

    outs = []
    for start in range(0, f, chunk_size):
        chunk = videos[:, start : start + chunk_size]  # (S, C', H, W)
        n_real = chunk.shape[1]
        if n_real < chunk_size:  # pad the tail; padding is masked out
            pad = np.repeat(chunk[:, -1:], chunk_size - n_real, axis=1)
            chunk = np.concatenate([chunk, pad], axis=1)
        frames = np.ascontiguousarray(chunk.transpose(1, 0, 2, 3))
        valid = np.arange(chunk_size) < n_real
        states, out = scan_fn(
            states,
            jax.device_put(frames, frame_sharding),
            jax.device_put(valid),
        )
        outs.append(jax.tree.map(lambda a: a[:n_real], out))
    if not outs:
        empty = StepOutput(
            bbox=np.zeros((0, s, 4), np.int32),
            score=np.zeros((0, s), np.float32),
            used_global=np.zeros((0, s), bool),
            updated=np.zeros((0, s), bool),
        )
        return states, empty
    dev = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
    # One packed (F, S, 7) transfer instead of four leaves (see
    # tracker.scan.fetch_outputs).
    from pvot.tracker.scan import fetch_outputs

    return states, fetch_outputs(dev)
