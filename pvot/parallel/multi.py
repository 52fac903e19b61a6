"""Multi-object tracking via vmap.

The reference's proposal lists "multiple-object tracking by running several
trackers concurrently" as its never-implemented 150% stretch goal (Proposal
PDF p.3; SURVEY.md §2e).  Here it falls out of the functional design: the
per-frame step is a pure function of (state, frame), so K objects are a
`jax.vmap` over K TrackerStates sharing each frame — one fused dispatch for
all objects, K NCC searches batched into the same matmuls.

Templates sharing one (th, tw) shape use the plain batched path
(init_multi_state / make_multi_step).  Heterogeneous template sizes use the
bucketed path (init_multi_state_bucketed / make_multi_step_bucketed): zero
padding into a shared bucket with TRACED per-object extents, so shapes stay
static while each tracker runs its own geometry.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pvot.config import TrackerConfig
from pvot.tracker.state import StepOutput, TrackerState, init_state


def init_multi_state(
    templates: Sequence[jax.Array],
    rois: Sequence[Tuple[int, int, int, int]],
) -> TrackerState:
    """Stack K single-object states into one batched TrackerState."""
    if len(templates) != len(rois):
        raise ValueError("templates and rois must pair up")
    shapes = {tuple(np.shape(t)) for t in templates}
    if len(shapes) != 1:
        raise ValueError(f"all templates must share one shape, got {shapes}")
    states = [init_state(jnp.asarray(t), r) for t, r in zip(templates, rois)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def make_multi_step(
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    strategy: str = "fused",
    backend: str = "xla",
    per_object_frames: bool = False,
):
    """Per-frame step over a batched state: (K-state, frame) -> (K-state, K-outs).

    per_object_frames=False: one shared frame, K objects (multi-object).
    per_object_frames=True: frames (K, H, W), one per tracker — K independent
    STREAMS advancing in lockstep (the serving layout; shard it over a mesh
    with pvot.parallel.sharded for multi-chip).

    NOT a plain vmap of the single-object step: under vmap, lax.cond lowers
    to a select that executes BOTH branches, so every object would pay the
    full-frame NCC every frame.  Instead the local
    region search is vmapped (cheap, batched matmul work), and the expensive
    global search runs under a SCALAR cond — only on frames where at least
    one object needs re-acquisition, and then for all K objects (their
    templates differ, so K full maps are inherent to that rare case).
    """
    from jax import lax

    from pvot.ops import search as search_ops
    from pvot.ops.backends import get_backend
    from pvot.tracker.state import is_bbox_outside_frame
    from pvot.tracker.step import apply_update

    full_fn, region_fn = get_backend(backend, frame_shape, templ_shape, config)
    frame_h, frame_w = frame_shape
    templ_h, templ_w = templ_shape
    out_w = frame_w - templ_w + 1
    out_h = frame_h - templ_h + 1
    span_x = 2 * config.search_radius_x + 1
    span_y = 2 * config.search_radius_y + 1
    lost_threshold = int(config.lost_frame_threshold)
    use_region = strategy == "fused" and out_w >= span_x and out_h >= span_y

    def multi_step(states: TrackerState, frame: jax.Array):
        # Frame stays in its wire dtype: every NCC op slices first and
        # converts through pvot.io.gray.ensure_gray_f32; apply_update
        # converts its template patch after slicing.
        bbox_outside = is_bbox_outside_frame(
            states.bbox_x, states.bbox_y, states.bbox_w, states.bbox_h,
            frame_w, frame_h,
        )
        cx = states.bbox_x + states.bbox_w // 2
        cy = states.bbox_y + states.bbox_h // 2
        use_global = (
            states.use_global | bbox_outside | (states.lost_count >= lost_threshold)
        )
        if not config.enable_global_search:  # Windows-tree/main_old variant
            use_global = jnp.zeros_like(use_global)
        bounds = search_ops.local_window_bounds(
            cx, cy, templ_w, templ_h, out_w, out_h,
            config.search_radius_x, config.search_radius_y,
        )  # all fields (K,)
        global_k = use_global | ~bounds.valid

        f_ax = 0 if per_object_frames else None

        # Local pass for every object (batched matmul work).
        if use_region:
            x0, y0 = search_ops.region_origin(bounds, out_w, out_h, span_x, span_y)

            def one_local(fr, templ, t_mean, t_std, x0k, y0k, b):
                scores = region_fn(fr, templ, t_mean, t_std, x0k, y0k)
                return search_ops.masked_region_argmax(scores, x0k, y0k, b)

            l_val, l_x, l_y = jax.vmap(one_local, in_axes=(f_ax, 0, 0, 0, 0, 0, 0))(
                frame, states.template, states.t_mean, states.t_std, x0, y0, bounds
            )
        else:

            def one_full(fr, templ, t_mean, t_std, b):
                m = full_fn(fr, templ, t_mean, t_std)
                return search_ops.masked_window_argmax(m, b)

            l_val, l_x, l_y = jax.vmap(one_full, in_axes=(f_ax, 0, 0, 0, 0))(
                frame, states.template, states.t_mean, states.t_std, bounds
            )

        # Global pass, only when some object needs it (scalar cond: one
        # branch executes).
        def do_global(frame):
            def one(fr, templ, t_mean, t_std):
                return search_ops.argmax2d(full_fn(fr, templ, t_mean, t_std))

            return jax.vmap(one, in_axes=(f_ax, 0, 0, 0))(
                frame, states.template, states.t_mean, states.t_std
            )

        def skip(frame):
            k = states.t_mean.shape[0]
            return (
                jnp.zeros((k,), jnp.float32),
                jnp.zeros((k,), jnp.int32),
                jnp.zeros((k,), jnp.int32),
            )

        g_val, g_x, g_y = lax.cond(jnp.any(global_k), do_global, skip, frame)
        best_val = jnp.where(global_k, g_val, l_val)
        best_x = jnp.where(global_k, g_x, l_x)
        best_y = jnp.where(global_k, g_y, l_y)

        return jax.vmap(
            lambda st, fr, bv, bx, by, ug, ga: apply_update(
                st, fr, bv, bx, by, ug, ga,
                frame_shape, templ_shape, config,
            ),
            in_axes=(0, f_ax, 0, 0, 0, 0, 0),
        )(states, frame, best_val, best_x, best_y, use_global, global_k)

    return multi_step


def make_multi_stream_step(
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    strategy: str = "fused",
    backend: str = "xla",
):
    """S independent streams in lockstep: (S-state, (S,H,W)) -> (S-state, S-outs).

    The serving layout for a single chip; combine with
    pvot.parallel.sharded.make_data_parallel_multi_step to span a mesh.
    """
    return make_multi_step(
        frame_shape, templ_shape, config, strategy, backend,
        per_object_frames=True,
    )


def make_stream_masked_scan_fn(multi_step):
    """Masked lockstep scan over S streams with PER-STREAM validity.

    Like pvot.tracker.scan.make_masked_scan_fn, but `valid` is (C, S) — one
    flag per frame per stream — so live serving can keep a lockstep chunk
    shape while individual streams end at different times: an ended stream's
    padding frames leave ITS state untouched while the others advance.
    (state, frames (C, S, H, W), valid (C, S)) -> (state, outs)."""
    from jax import lax

    def masked_step(states: TrackerState, xs):
        frames, valid = xs  # (S, H, W), (S,)
        new_states, out = multi_step(states, frames)

        def keep(new, old):
            v = valid.reshape(valid.shape + (1,) * (new.ndim - 1))
            return jnp.where(v, new, old)

        return jax.tree.map(keep, new_states, states), out

    def scan_chunk(states: TrackerState, frames: jax.Array, valid: jax.Array):
        return lax.scan(masked_step, states, (frames, valid))

    return jax.jit(scan_chunk)


def track_video_multi(
    frames: np.ndarray,
    states: TrackerState,
    config: TrackerConfig = TrackerConfig(),
    strategy: str = "fused",
    backend: str = "xla",
    chunk_size: int = 32,
) -> Tuple[TrackerState, StepOutput]:
    """Track K objects through a gray video (F, H, W); outputs get a leading
    (F, K) layout.

    Heterogeneous template sizes (init_multi_state_bucketed states —
    detected by bbox extents differing from the shared template bucket)
    route through the bucketed traced-extent step; `strategy`/`backend`
    are then ignored (the bucketed NCC is its own matmul formulation,
    pvot.ops.ncc_matmul.ncc_scores_bucketed)."""
    from pvot.tracker.scan import _stack_outputs, make_masked_scan_fn

    frames = np.asarray(frames)
    f, h, w = frames.shape
    th, tw = states.template.shape[-2:]
    if is_bucketed(states):
        multi_step = make_multi_step_bucketed((h, w), (th, tw), config)
    else:
        multi_step = make_multi_step(
            (h, w), (th, tw), config, strategy, backend
        )
    scan_fn = make_masked_scan_fn(multi_step)
    outs = []
    for start in range(0, f, chunk_size):
        chunk = frames[start : start + chunk_size]
        n_real = chunk.shape[0]
        if n_real < chunk_size:
            pad = np.repeat(chunk[-1:], chunk_size - n_real, axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        valid = np.arange(chunk_size) < n_real
        states, out = scan_fn(states, jax.device_put(chunk), jax.device_put(valid))
        outs.append(jax.tree.map(lambda a: a[:n_real], out))
    return states, _stack_outputs(outs)


# --- Heterogeneous template sizes (bucketed) --------------------------------


def init_multi_state_bucketed(
    templates: Sequence[np.ndarray],
    rois: Sequence[Tuple[int, int, int, int]],
    bucket: Tuple[int, int] | None = None,
) -> TrackerState:
    """Stack K trackers whose templates have DIFFERENT sizes.

    Templates are zero-padded into a shared (bh, bw) bucket (default: the
    element-wise max); the actual per-object size rides in bbox_w/bbox_h,
    which by the reference's semantics always equal the template size
    (tracker_ghc/src/main.cpp:451-454).
    """
    import numpy as onp

    from pvot.ops.ncc_matmul import template_stats_bucketed

    if len(templates) != len(rois):
        raise ValueError("templates and rois must pair up")
    shapes = [tuple(onp.shape(t)) for t in templates]
    bh = max(s[0] for s in shapes)
    bw = max(s[1] for s in shapes)
    if bucket is not None:
        if bucket[0] < bh or bucket[1] < bw:
            raise ValueError(f"bucket {bucket} smaller than largest template")
        bh, bw = bucket
    states = []
    for t, (x, y, w, h) in zip(templates, rois):
        t = jnp.asarray(t, jnp.float32)
        if t.shape != (h, w):
            raise ValueError(f"template shape {t.shape} != roi (h={h}, w={w})")
        padded = jnp.pad(t, ((0, bh - h), (0, bw - w)))
        t_mean, t_std = template_stats_bucketed(padded, jnp.int32(h * w))
        states.append(
            TrackerState(
                bbox_x=jnp.int32(x), bbox_y=jnp.int32(y),
                bbox_w=jnp.int32(w), bbox_h=jnp.int32(h),
                template=padded, t_mean=t_mean, t_std=t_std,
                lost_count=jnp.int32(0), use_global=jnp.bool_(False),
            )
        )
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def is_bucketed(states: TrackerState) -> bool:
    """True for stacked states from init_multi_state_bucketed: some lane's
    bbox extent (== its template extent) differs from the template bucket."""
    th, tw = np.shape(states.template)[-2:]
    return any(
        (int(eh), int(ew)) != (th, tw)
        for eh, ew in zip(np.asarray(states.bbox_h), np.asarray(states.bbox_w))
    )


def make_multi_step_bucketed(
    frame_shape: Tuple[int, int],
    bucket: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
):
    """Multi-object step for heterogeneous template sizes.

    Same shape as make_multi_step (vmapped local region pass; scalar-cond
    global pass) built on the traced-extent bucketed NCC
    (pvot.ops.ncc_matmul.ncc_scores_bucketed): every per-object size
    quantity (template extent, NCC-map extent, window bounds, window pixel
    count) is a traced scalar; shapes stay static at the bucket.
    """
    from jax import lax

    from pvot.io.gray import ensure_gray_f32
    from pvot.ops import search as search_ops
    from pvot.ops.ncc_matmul import (
        make_bucketed_full_fn,
        make_bucketed_region_fn,
        template_stats_bucketed,
    )
    from pvot.tracker.state import is_bbox_outside_frame

    frame_h, frame_w = frame_shape
    bh, bw = bucket
    span_x = 2 * config.search_radius_x + 1
    span_y = 2 * config.search_radius_y + 1
    lost_threshold = int(config.lost_frame_threshold)
    lr = float(config.template_update_lr)
    region_fn = make_bucketed_region_fn(span_x, span_y, bucket)
    full_fn = make_bucketed_full_fn(frame_shape, bucket)
    # The local fast path requires every per-object NCC map to contain the
    # candidate span; the largest bucketed template is the binding case.
    if frame_w - bw + 1 < span_x or frame_h - bh + 1 < span_y:
        raise ValueError(
            "bucketed multi-step needs frame - bucket + 1 >= search span"
        )

    def multi_step(states: TrackerState, frame: jax.Array):
        # Wire-dtype frame: zero padding commutes with the uint8->f32/255
        # conversion, which happens per-slice inside the bucketed NCC ops.
        frame_padded = jnp.pad(frame, ((0, bh - 1), (0, bw - 1)))
        th_k = states.bbox_h  # == template extent (reference invariant)
        tw_k = states.bbox_w
        out_w_k = frame_w - tw_k + 1
        out_h_k = frame_h - th_k + 1
        bbox_outside = is_bbox_outside_frame(
            states.bbox_x, states.bbox_y, states.bbox_w, states.bbox_h,
            frame_w, frame_h,
        )
        cx = states.bbox_x + states.bbox_w // 2
        cy = states.bbox_y + states.bbox_h // 2
        use_global = (
            states.use_global | bbox_outside | (states.lost_count >= lost_threshold)
        )
        if not config.enable_global_search:  # Windows-tree/main_old variant
            use_global = jnp.zeros_like(use_global)
        bounds = search_ops.local_window_bounds(
            cx, cy, tw_k, th_k, out_w_k, out_h_k,
            config.search_radius_x, config.search_radius_y,
        )
        global_k = use_global | ~bounds.valid

        x0 = jnp.minimum(bounds.min_tx, out_w_k - span_x)
        y0 = jnp.minimum(bounds.min_ty, out_h_k - span_y)

        def one_local(templ, t_mean, t_std, th, tw, x0k, y0k, b):
            scores = region_fn(frame_padded, templ, t_mean, t_std, th, tw, x0k, y0k)
            return search_ops.masked_region_argmax(scores, x0k, y0k, b)

        l_val, l_x, l_y = jax.vmap(one_local)(
            states.template, states.t_mean, states.t_std,
            th_k, tw_k, x0, y0, bounds,
        )

        def do_global(frame):
            def one(fr, templ, t_mean, t_std, th, tw, ow, oh):
                m = full_fn(fr, templ, t_mean, t_std, th, tw)
                ys = lax.broadcasted_iota(jnp.int32, m.shape, 0)
                xs = lax.broadcasted_iota(jnp.int32, m.shape, 1)
                m = jnp.where((xs < ow) & (ys < oh), m, search_ops.NEG_INF)
                return search_ops.argmax2d(m)

            return jax.vmap(one, in_axes=(None, 0, 0, 0, 0, 0, 0, 0))(
                frame, states.template, states.t_mean, states.t_std,
                th_k, tw_k, out_w_k, out_h_k,
            )

        def skip(frame):
            k = states.t_mean.shape[0]
            return (
                jnp.zeros((k,), jnp.float32),
                jnp.zeros((k,), jnp.int32),
                jnp.zeros((k,), jnp.int32),
            )

        g_val, g_x, g_y = lax.cond(jnp.any(global_k), do_global, skip, frame)
        best_val = jnp.where(global_k, g_val, l_val)
        best_x = jnp.where(global_k, g_x, l_x)
        best_y = jnp.where(global_k, g_y, l_y)

        def update_one(st, bv, bx, by, ug, ga, th, tw):
            threshold = jnp.where(
                ug, jnp.float32(config.global_confidence),
                jnp.float32(config.min_confidence),
            )
            accept = bv >= threshold
            nbx = jnp.where(accept, bx, st.bbox_x)
            nby = jnp.where(accept, by, st.bbox_y)
            lost = jnp.where(accept, jnp.int32(0), st.lost_count + 1)
            n_out = is_bbox_outside_frame(nbx, nby, tw, th, frame_w, frame_h)
            ug_next = jnp.where(accept & ~n_out, jnp.bool_(False), ug)
            strong = accept & (bv >= jnp.float32(config.strong_confidence))
            patch = ensure_gray_f32(
                lax.dynamic_slice(frame_padded, (nby, nbx), (bh, bw))
            )
            mask = (
                (lax.broadcasted_iota(jnp.int32, (bh, bw), 0) < th)
                & (lax.broadcasted_iota(jnp.int32, (bh, bw), 1) < tw)
            )
            blended = jnp.where(mask, (1.0 - lr) * st.template + lr * patch, 0.0)
            new_t = jnp.where(strong, blended, st.template)
            t_mean, t_std = lax.cond(
                strong,
                lambda t: template_stats_bucketed(t, th * tw),
                lambda _: (st.t_mean, st.t_std),
                new_t,
            )
            new_state = TrackerState(
                nbx, nby, tw, th, new_t, t_mean, t_std, lost, ug_next
            )
            out = StepOutput(
                bbox=jnp.stack([nbx, nby, tw, th]),
                score=bv, used_global=ga, updated=accept,
            )
            return new_state, out

        return jax.vmap(update_one)(
            states, best_val, best_x, best_y, use_global, global_k, th_k, tw_k
        )

    return multi_step
