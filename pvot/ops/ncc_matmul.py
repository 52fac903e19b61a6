"""Matmul-formulated NCC (the "xla" engine): im2col-x matmul + integral-image
box sums.

This module expresses the reference NCC math
(tracker_ghc/src/baseline_kernel.cu:17-47, see pvot.ops.ncc_reference for the
semantics) as one matrix product plus cheap elementwise work, instead of a
convolution with a template-sized kernel:

  cross-correlation   im2col along x only:  X[y, dx, c] = img[y, dx+c]
                      R1[y, dx, r] = X @ T^T           (one matmul)
                      cross[dy, dx] = sum_r R1[dy+r, dx, r]
                      (th shifted adds)

  window sums         integral images (exclusive cumsum) -> each sliding
                      box sum is 4 adds, O(1) per output pixel.

The im2col buffer is (Y, outW, tw) f32; for big frames the y-axis is
processed in strips so the buffer stays bounded.  f32 throughout with
precision=HIGHEST on the matmul, preserving parity with the reference's f32
device arithmetic.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from pvot.io.gray import ensure_gray_f32
from pvot.ops.ncc_reference import template_stats


def _im2col_x(img: jax.Array, tw: int, out_w: int) -> jax.Array:
    """(Y, W) -> (Y, out_w, tw) where result[y, dx, c] = img[y, dx + c].

    Built from tw static slices; XLA fuses these into cheap copies.
    """
    cols = [lax.slice_in_dim(img, c, c + out_w, axis=1) for c in range(tw)]
    return jnp.stack(cols, axis=-1)


def cross_correlate(
    img: jax.Array, templ: jax.Array, precision=lax.Precision.HIGHEST
) -> jax.Array:
    """Valid-mode cross-correlation via im2col-x + one matmul.

    img (Y, W), templ (th, tw) -> (Y - th + 1, W - tw + 1).
    Equivalent to pvot.ops.ncc_reference.corr2_valid.

    precision: the f32 matmul's precision.  HIGHEST (float32, no TF32) is
    the parity default; see pvot.ops.backends for what HIGH means on a GPU.
    """
    th, tw = templ.shape
    y, w = img.shape
    out_h = y - th + 1
    out_w = w - tw + 1
    x = _im2col_x(img, tw, out_w)  # (Y, out_w, tw)
    # R1[y, dx, r] = sum_c X[y, dx, c] * T[r, c]
    r1 = lax.dot_general(
        x,
        templ,
        dimension_numbers=(((2,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )  # (Y, out_w, th)
    # cross[dy, dx] = sum_r R1[dy + r, dx, r]
    shifted = [
        lax.slice(r1, (r, 0, r), (r + out_h, out_w, r + 1)).reshape(out_h, out_w)
        for r in range(th)
    ]
    return jnp.sum(jnp.stack(shifted, axis=0), axis=0)


def cross_correlate_conv1d(img: jax.Array, templ: jax.Array) -> jax.Array:
    """Same math as cross_correlate via a 1-D valid conv along width.

    An alternate lowering (a width-wise 1-D conv with template-row filters)
    that skips materializing the (Y, out_w, tw) im2col buffer in device
    memory; the row-correlation tensor R1 is produced directly.  Not used
    by an engine; kept as the cuDNN candidate for the correlation.
    """
    th, tw = templ.shape
    y, w = img.shape
    out_h = y - th + 1
    out_w = w - tw + 1
    # (N=y, C=1, W) conv (O=th, I=1, KW=tw) -> (y, th, out_w)
    r1 = lax.conv_general_dilated(
        img[:, None, :],
        templ[:, None, :],
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=lax.Precision.HIGHEST,
    )
    # cross[dy, dx] = sum_r R1[dy + r, r, dx]
    shifted = [
        lax.slice(r1, (r, r, 0), (r + out_h, r + 1, out_w)).reshape(out_h, out_w)
        for r in range(th)
    ]
    return jnp.sum(jnp.stack(shifted, axis=0), axis=0)


def sliding_box_sums(
    img: jax.Array, th: int, tw: int
) -> Tuple[jax.Array, jax.Array]:
    """Sliding-window (sum, sum-of-squares) over all valid th x tw windows.

    Integral-image formulation: an exclusive 2-D cumsum S gives every box sum
    as S[y2,x2] - S[y1,x2] - S[y2,x1] + S[y1,x1] — O(1) per output instead of
    the reference's O(N) per-thread loops (baseline_kernel.cu:22-29).
    """
    y, w = img.shape
    out_h = y - th + 1
    out_w = w - tw + 1

    def box(values: jax.Array) -> jax.Array:
        s = jnp.cumsum(jnp.cumsum(values, axis=0), axis=1)
        s = jnp.pad(s, ((1, 0), (1, 0)))  # exclusive integral image
        a = lax.slice(s, (th, tw), (th + out_h, tw + out_w))
        b = lax.slice(s, (0, tw), (out_h, tw + out_w))
        c = lax.slice(s, (th, 0), (th + out_h, out_w))
        d = lax.slice(s, (0, 0), (out_h, out_w))
        return a - b - c + d

    return box(img), box(jnp.square(img))


def ncc_map_matmul(
    frame: jax.Array,
    templ: jax.Array,
    t_mean: jax.Array | None = None,
    t_std: jax.Array | None = None,
    strip_rows: int = 0,
    precision=lax.Precision.HIGHEST,
) -> jax.Array:
    """Full NCC map with reference epsilon semantics, matmul formulation.

    Matches pvot.ops.ncc_reference.ncc_map_reference to f32 accumulation
    order (tests assert ~1e-5 agreement with the f64 oracle).

    strip_rows > 0 processes the cross-correlation in y-strips of that many
    output rows to bound the im2col buffer ((strip+th-1) * outW * tw * 4 B);
    0 materializes one buffer for the whole frame.
    """
    frame = ensure_gray_f32(frame)
    templ = templ.astype(jnp.float32)
    if t_mean is None or t_std is None:
        t_mean, t_std = template_stats(templ)
    th, tw = templ.shape
    n = float(th * tw)
    fh, fw = frame.shape
    out_h = fh - th + 1
    out_w = fw - tw + 1

    t_centered = templ - t_mean
    if strip_rows and strip_rows < out_h:
        pieces = []
        for dy0 in range(0, out_h, strip_rows):
            rows = min(strip_rows, out_h - dy0)
            strip = lax.slice(frame, (dy0, 0), (dy0 + rows + th - 1, fw))
            pieces.append(cross_correlate(strip, t_centered, precision))
        cov = jnp.concatenate(pieces, axis=0)
    else:
        cov = cross_correlate(frame, t_centered, precision)

    sums, ssq = sliding_box_sums(frame, th, tw)
    mean = sums / n
    var = ssq / n - jnp.square(mean)
    std = jnp.sqrt(jnp.maximum(var, 1e-6))
    denom = (std + 1e-6) * (t_std + 1e-6) * n
    return cov / denom


def ncc_map_opencv_matmul(
    frame: jax.Array, templ: jax.Array, strip_rows: int = 0
) -> jax.Array:
    """cv::matchTemplate(TM_CCOEFF_NORMED) semantics, matmul formulation.

    Same math as pvot.ops.ncc_reference.ncc_map_opencv (the --cpu parity
    mode) built from cross_correlate + sliding_box_sums.
    """
    frame = ensure_gray_f32(frame)
    templ = templ.astype(jnp.float32)
    th, tw = templ.shape
    n = float(th * tw)
    fh, fw = frame.shape
    out_h = fh - th + 1
    t_centered = templ - jnp.mean(templ)
    t_ssq = jnp.sum(jnp.square(t_centered))
    if strip_rows and strip_rows < out_h:
        pieces = []
        for dy0 in range(0, out_h, strip_rows):
            rows = min(strip_rows, out_h - dy0)
            strip = lax.slice(frame, (dy0, 0), (dy0 + rows + th - 1, fw))
            pieces.append(cross_correlate(strip, t_centered))
        numer = jnp.concatenate(pieces, axis=0)
    else:
        numer = cross_correlate(frame, t_centered)
    sums, ssq = sliding_box_sums(frame, th, tw)
    win_ssq = jnp.maximum(ssq - jnp.square(sums) / n, 0.0)
    denom = jnp.sqrt(t_ssq * win_ssq)
    return numer / jnp.maximum(denom, 1e-12)


def make_opencv_full_fn(strip_rows: int = 128):
    """--cpu parity full-map callable (frame, templ, t_mean, t_std)."""

    def full_fn(frame, templ, t_mean, t_std):
        del t_mean, t_std  # TM_CCOEFF_NORMED normalizes differently
        return ncc_map_opencv_matmul(frame, templ, strip_rows=strip_rows)

    return full_fn


def make_opencv_region_fn(span_x: int, span_y: int):
    """--cpu parity region scorer."""

    def region_fn(frame, templ, t_mean, t_std, x0, y0):
        del t_mean, t_std
        th, tw = templ.shape
        region = lax.dynamic_slice(
            frame, (y0, x0), (span_y + th - 1, span_x + tw - 1)
        )
        return ncc_map_opencv_matmul(region, templ)

    return region_fn


# --- Bucketed (traced-extent) NCC -----------------------------------------
# Heterogeneous template sizes under vmap: every template is zero-padded
# into a static (bh, bw) bucket; the ACTUAL extent (th, tw) is a traced
# scalar pair.  Zeros outside the valid region contribute nothing to the
# cross-correlation, and the window sums come from integral images whose
# box corners are dynamic_slices at traced offsets — static shapes
# throughout, per-object sizes at runtime.


def template_stats_bucketed(templ_padded: jax.Array, n: jax.Array):
    """(mean, std + 1e-6) of the VALID region of a zero-padded template.

    Zeros outside the valid region vanish from the sums; `n` is the traced
    valid-pixel count th*tw.  Mirrors pvot.ops.ncc_reference.template_stats.
    """
    n = n.astype(jnp.float32)
    s = jnp.sum(templ_padded)
    sq = jnp.sum(jnp.square(templ_padded))
    mean = s / n
    var = sq / n - jnp.square(mean)
    std = jnp.sqrt(jnp.maximum(var, 0.0)) + jnp.float32(1e-6)
    return mean, std


def _integral(img: jax.Array) -> jax.Array:
    """Exclusive 2-D integral image: S[y, x] = sum(img[:y, :x])."""
    s = jnp.cumsum(jnp.cumsum(img, axis=0), axis=1)
    return jnp.pad(s, ((1, 0), (1, 0)))


def _box_sums_traced(img: jax.Array, th, tw, out_h: int, out_w: int):
    """Sliding box sums with TRACED window extent (static output shape).

    Every (out_h, out_w) corner plane is one dynamic_slice of the integral
    image at traced offsets (th, tw)."""
    s = _integral(img)
    a = lax.dynamic_slice(s, (th, tw), (out_h, out_w))
    b = lax.dynamic_slice(s, (jnp.int32(0), tw), (out_h, out_w))
    c = lax.dynamic_slice(s, (th, jnp.int32(0)), (out_h, out_w))
    d = lax.slice(s, (0, 0), (out_h, out_w))
    return a - b - c + d


def ncc_scores_bucketed(
    img: jax.Array,
    templ_padded: jax.Array,
    t_mean: jax.Array,
    t_std: jax.Array,
    th: jax.Array,
    tw: jax.Array,
    out_h: int,
    out_w: int,
) -> jax.Array:
    """NCC scores with reference epsilon semantics, traced template extent.

    img (out_h + bh - 1, out_w + bw - 1) f32 (zero-pad if the source is
    smaller), templ_padded (bh, bw) RAW template values zero-padded.
    Scores at positions whose window hangs past the true image content are
    garbage; callers mask them (pvot.ops.search masking covers this).
    """
    img = ensure_gray_f32(img)
    bh, bw = templ_padded.shape
    mask = (
        (lax.broadcasted_iota(jnp.int32, (bh, bw), 0) < th)
        & (lax.broadcasted_iota(jnp.int32, (bh, bw), 1) < tw)
    )
    t_centered = jnp.where(mask, templ_padded - t_mean, 0.0)
    cross = cross_correlate(img, t_centered)  # (out_h, out_w)
    n = (th * tw).astype(jnp.float32)
    sums = _box_sums_traced(img, th, tw, out_h, out_w)
    ssq = _box_sums_traced(jnp.square(img), th, tw, out_h, out_w)
    mean = sums / n
    var = ssq / n - jnp.square(mean)
    std = jnp.sqrt(jnp.maximum(var, 1e-6))
    cov = cross - mean * jnp.sum(t_centered)
    return cov / ((std + 1e-6) * (t_std + 1e-6) * n)


def make_bucketed_region_fn(span_x: int, span_y: int, bucket: Tuple[int, int]):
    """Region scorer over a fixed-size candidate window, traced extent.

    (frame, templ_padded, t_mean, t_std, th, tw, x0, y0) -> (span_y, span_x)
    """
    bh, bw = bucket

    def region_fn(frame, templ_padded, t_mean, t_std, th, tw, x0, y0):
        region = lax.dynamic_slice(
            frame, (y0, x0), (span_y + bh - 1, span_x + bw - 1)
        )
        return ncc_scores_bucketed(
            region, templ_padded, t_mean, t_std, th, tw, span_y, span_x
        )

    return region_fn


def make_bucketed_full_fn(frame_shape: Tuple[int, int], bucket: Tuple[int, int]):
    """Full-frame scorer with traced extent: the frame is zero-padded by
    (bh-1, bw-1) so every valid candidate for ANY template size in the
    bucket exists; positions past (H - th + 1, W - tw + 1) are garbage and
    must be masked by the caller."""
    fh, fw = frame_shape
    bh, bw = bucket

    def full_fn(frame, templ_padded, t_mean, t_std, th, tw):
        img = jnp.pad(frame, ((0, bh - 1), (0, bw - 1)))
        return ncc_scores_bucketed(
            img, templ_padded, t_mean, t_std, th, tw, fh, fw
        )

    return full_fn


def make_full_fn(strip_rows: int = 128):
    """Full-map NCC callable (frame, templ, t_mean, t_std) -> map, strip-wise."""

    def full_fn(frame, templ, t_mean, t_std):
        return ncc_map_matmul(frame, templ, t_mean, t_std, strip_rows=strip_rows)

    return full_fn


def make_region_fn(span_x: int, span_y: int, precision=lax.Precision.HIGHEST):
    """Fused local-search region scorer (the hot path).

    Slices the (span + templ - 1)^2 neighborhood around the candidate window
    and evaluates NCC only there — the ~50x work reduction the reference
    leaves on the table (SURVEY.md §3.5).

    precision sets the correlation matmul's precision.  HIGHEST (float32)
    is the default and the only setting with score parity to the f32
    oracle; HIGH is the "xla_fast" engine (pvot.ops.backends)."""

    def region_fn(frame, templ, t_mean, t_std, x0, y0):
        th, tw = templ.shape
        region = lax.dynamic_slice(
            frame, (y0, x0), (span_y + th - 1, span_x + tw - 1)
        )
        return ncc_map_matmul(region, templ, t_mean, t_std, precision=precision)

    return region_fn
