"""The per-frame tracking step as a pure, scannable function.

Ports the reference's sequential state machine (components C5-C8, SURVEY.md
§2a; tracker_ghc/src/main.cpp:172-239 demo loop / :399-467 record loop) to a
pure function `step(state, frame) -> (state, outputs)` suitable as a
`jax.lax.scan` body.  All control flow is `lax.cond`/`jnp.where`; shapes are
static per (frame size, template size, search radii), so XLA compiles one
fused program per tracking run.

Two search strategies, both bit-matching the reference's argmax semantics:

  * "full"  — compute the full-frame NCC map and window-mask the argmax:
    exactly the reference's flow (compute everything, read a window).
  * "fused" — the fast path: slice a fixed-size candidate region around
    the bbox and compute NCC only there (~50x less work for 720p/80px,
    SURVEY.md §3.5); global search still evaluates the full frame, but only
    inside the rarely-taken `lax.cond` branch.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from pvot.config import TrackerConfig
from pvot.ops import search as search_ops
from pvot.ops.ncc_reference import ncc_map_reference, template_stats
from pvot.tracker.state import StepOutput, TrackerState, is_bbox_outside_frame

# An NCC "full map" callable: (frame, templ, t_mean, t_std) -> (outH, outW).
NccFullFn = Callable[[jax.Array, jax.Array, jax.Array, jax.Array], jax.Array]
# An NCC "region" callable: (frame, templ, t_mean, t_std, x0, y0) -> (span_y, span_x)
# scoring map positions (y0+dy, x0+dx).
NccRegionFn = Callable[..., jax.Array]


def default_region_fn(span_x: int, span_y: int) -> NccRegionFn:
    """Conv-oracle region scorer — slices the frame and scores the slice.

    TESTS ONLY (the "ref_conv" engine): production paths use
    pvot.ops.ncc_matmul.make_region_fn, which make_step resolves by
    default.  Work per frame either way:
    (span+t-1)^2 windows instead of the full frame — the reference computes
    the full map and discards ~98% of it (SURVEY.md §2b)."""

    def region_fn(frame, templ, t_mean, t_std, x0, y0):
        th, tw = templ.shape
        region = lax.dynamic_slice(
            frame, (y0, x0), (span_y + th - 1, span_x + tw - 1)
        )
        return ncc_map_reference(region, templ, t_mean, t_std)

    return region_fn


def _ensure_f32(frame: jax.Array) -> jax.Array:
    """Accept uint8 (scaled by 1/255, reference utils.hpp:4-13) or float32.

    uint8->f32*(1/255) commutes exactly with slicing and zero padding, so
    hot paths slice FIRST and convert the slice — a 720p frame is 0.9 MB as
    uint8 but 3.7 MB materialized as f32, and the local search only ever
    reads a (span+t-1)^2 region of it."""
    from pvot.io.gray import ensure_gray_f32

    return ensure_gray_f32(frame)


def make_step(
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    ncc_full_fn: Optional[NccFullFn] = None,
    ncc_region_fn: Optional[NccRegionFn] = None,
    strategy: str = "fused",
) -> Callable[[TrackerState, jax.Array], Tuple[TrackerState, StepOutput]]:
    """Build the per-frame step for fixed frame/template geometry.

    strategy:
      "full"  — full-frame NCC every frame + masked window argmax (parity
                with the reference's compute-everything flow).
      "fused" — region-restricted NCC in local mode, full-frame only in
                global mode (the fast path).

    ncc_full_fn / ncc_region_fn default to the matmul formulation
    (pvot.ops.ncc_matmul, the "xla" engine).  The conv-based oracle stays
    available explicitly.
    """
    frame_h, frame_w = frame_shape
    templ_h, templ_w = templ_shape
    out_w = frame_w - templ_w + 1
    out_h = frame_h - templ_h + 1
    span_x = 2 * config.search_radius_x + 1
    span_y = 2 * config.search_radius_y + 1
    if strategy == "fused" and (out_w < span_x or out_h < span_y):
        # Candidate region would exceed the NCC map: the local window can
        # never be larger than the map, so fall back to full-map strategy.
        strategy = "full"
    if ncc_full_fn is None or ncc_region_fn is None:
        from pvot.ops.ncc_matmul import make_full_fn, make_region_fn

        if ncc_full_fn is None:
            ncc_full_fn = make_full_fn(strip_rows=128)
        if ncc_region_fn is None:
            ncc_region_fn = make_region_fn(span_x, span_y)

    # Python scalar, not an eager jnp constant: a captured device array
    # would become a jit argument instead of a compile-time constant.
    lost_threshold = int(config.lost_frame_threshold)

    def step(state: TrackerState, frame: jax.Array):
        # The frame stays in its wire dtype (uint8 on the fast path) until a
        # consumer slices its region of interest; only the "full" strategy
        # and the global-search branch convert the whole frame.
        # --- Mode selection (main.cpp:399-413) ----------------------------
        bbox_outside = is_bbox_outside_frame(
            state.bbox_x, state.bbox_y, state.bbox_w, state.bbox_h, frame_w, frame_h
        )
        cx = state.bbox_x + state.bbox_w // 2
        cy = state.bbox_y + state.bbox_h // 2
        if config.enable_global_search:
            use_global = (
                state.use_global | bbox_outside | (state.lost_count >= lost_threshold)
            )
        else:  # Windows-tree / main_old behavior: no re-acquisition mode
            use_global = jnp.bool_(False)
        bounds = search_ops.local_window_bounds(
            cx, cy, templ_w, templ_h, out_w, out_h,
            config.search_radius_x, config.search_radius_y,
        )
        # Window-collapse fallback also searches globally (main.cpp:439-446)
        # but keeps the LOCAL confidence threshold (main.cpp:449 keys the
        # threshold off use_global, not off which argmax ran).
        global_argmax = use_global | ~bounds.valid

        # --- NCC + argmax (main.cpp:414-446) ------------------------------
        if strategy == "full":
            frame_f = _ensure_f32(frame)
            ncc_map = ncc_full_fn(frame_f, state.template, state.t_mean, state.t_std)
            best_val, best_x, best_y = lax.cond(
                global_argmax,
                lambda m: search_ops.argmax2d(m),
                lambda m: search_ops.masked_window_argmax(m, bounds),
                ncc_map,
            )
        else:
            # Overlay structure (measured ~5% faster than a cond that
            # SELECTS local-vs-global, tools/cond_ab.py; trajectory
            # bit-equal): the cheap local region pass always runs — its
            # region_origin clamp keeps the slice in-bounds even when the
            # window collapsed — and the expensive global pass runs under a
            # cond whose skip branch is trivial; the rare global result
            # overlays via where.  On global frames the wasted local pass
            # is noise next to the full-map cost.
            x0, y0 = search_ops.region_origin(bounds, out_w, out_h, span_x, span_y)
            # region_fn slices its region out of the raw frame and converts
            # the slice (see _ensure_f32).
            scores = ncc_region_fn(
                frame, state.template, state.t_mean, state.t_std, x0, y0
            )
            l_val, l_x, l_y = search_ops.masked_region_argmax(
                scores, x0, y0, bounds
            )

            def do_global(frame):
                ncc_map = ncc_full_fn(
                    _ensure_f32(frame), state.template, state.t_mean, state.t_std
                )
                return search_ops.argmax2d(ncc_map)

            def skip_global(frame):
                return (jnp.float32(0.0), jnp.int32(0), jnp.int32(0))

            g_val, g_x, g_y = lax.cond(global_argmax, do_global, skip_global, frame)
            best_val = jnp.where(global_argmax, g_val, l_val)
            best_x = jnp.where(global_argmax, g_x, l_x)
            best_y = jnp.where(global_argmax, g_y, l_y)

        return apply_update(
            state, frame, best_val, best_x, best_y, use_global, global_argmax,
            (frame_h, frame_w), (templ_h, templ_w), config,
        )

    return step


def apply_update(
    state: TrackerState,
    frame: jax.Array,
    best_val: jax.Array,
    best_x: jax.Array,
    best_y: jax.Array,
    use_global: jax.Array,
    global_argmax: jax.Array,
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig,
) -> Tuple[TrackerState, StepOutput]:
    """Post-argmax state update: confidence gate + bbox move
    (main.cpp:448-459), lost counter, global-flag reset, and adaptive
    template EMA (main.cpp:460-463).  Shared by the single-object step and
    the vmapped multi-object step."""
    frame_h, frame_w = frame_shape
    templ_h, templ_w = templ_shape
    lr = float(config.template_update_lr)
    threshold = jnp.where(
        use_global,
        jnp.float32(config.global_confidence),
        jnp.float32(config.min_confidence),
    )
    accept = best_val >= threshold
    new_bx = jnp.where(accept, best_x, state.bbox_x)
    new_by = jnp.where(accept, best_y, state.bbox_y)
    new_bw = jnp.where(accept, jnp.int32(templ_w), state.bbox_w)
    new_bh = jnp.where(accept, jnp.int32(templ_h), state.bbox_h)
    lost_count = jnp.where(accept, jnp.int32(0), state.lost_count + 1)
    new_outside = is_bbox_outside_frame(new_bx, new_by, new_bw, new_bh, frame_w, frame_h)
    use_global_next = jnp.where(accept & ~new_outside, jnp.bool_(False), use_global)

    strong = accept & (best_val >= jnp.float32(config.strong_confidence))
    # Slice the patch from the raw frame, THEN convert: avoids materializing
    # a full f32 frame per step when the wire dtype is uint8 (bit-exact, the
    # conversion is elementwise).
    patch = _ensure_f32(
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
        bbox_x=new_bx,
        bbox_y=new_by,
        bbox_w=new_bw,
        bbox_h=new_bh,
        template=new_template,
        t_mean=t_mean,
        t_std=t_std,
        lost_count=lost_count,
        use_global=use_global_next,
    )
    out = StepOutput(
        bbox=jnp.stack([new_bx, new_by, new_bw, new_bh]),
        score=best_val,
        used_global=global_argmax,
        updated=accept,
    )
    return new_state, out


@functools.lru_cache(maxsize=32)
def jitted_step(
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig = TrackerConfig(),
    strategy: str = "fused",
    backend: str = "xla",
):
    """Cached jit-compiled step for a given geometry (see pvot.ops.backends
    for backend names).  No donation: callers may keep the input state."""
    from pvot.ops.backends import get_backend

    full_fn, region_fn = get_backend(backend, frame_shape, templ_shape, config)
    step = make_step(
        frame_shape, templ_shape, config,
        ncc_full_fn=full_fn, ncc_region_fn=region_fn, strategy=strategy,
    )
    return jax.jit(step)
