"""Tests for the matmul-formulated NCC (pvot.ops.ncc_matmul).

It must agree with the conv-based oracle (pvot.ops.ncc_reference) and the f64
brute force to f32 tolerance, for every code path (whole-buffer, strip-wise,
region slicing) and for odd shapes.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pvot.ops.ncc_matmul import (
    cross_correlate,
    make_full_fn,
    make_region_fn,
    ncc_map_matmul,
    sliding_box_sums,
)
from pvot.ops.ncc_reference import ncc_map_reference, template_stats
from tests.test_ncc_ops import bruteforce_reference_map


@pytest.fixture
def data(rng):
    frame = rng.random((64, 80)).astype(np.float32)
    templ = frame[20:36, 30:42].copy()  # 16x12
    return frame, templ


def test_cross_correlate_matches_conv(data, rng):
    frame, templ = data
    got = np.asarray(cross_correlate(jnp.asarray(frame), jnp.asarray(templ)))
    # f64 direct correlation
    win = np.lib.stride_tricks.sliding_window_view(frame.astype(np.float64), templ.shape)
    want = (win * templ.astype(np.float64)).sum(axis=(-1, -2))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_sliding_box_sums(data):
    frame, _ = data
    sums, ssq = sliding_box_sums(jnp.asarray(frame), 16, 12)
    win = np.lib.stride_tricks.sliding_window_view(frame.astype(np.float64), (16, 12))
    np.testing.assert_allclose(np.asarray(sums), win.sum(axis=(-1, -2)), atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(ssq), (win**2).sum(axis=(-1, -2)), atol=1e-3
    )


def test_ncc_matmul_matches_bruteforce(data):
    frame, templ = data
    got = np.asarray(ncc_map_matmul(jnp.asarray(frame), jnp.asarray(templ)))
    want = bruteforce_reference_map(frame, templ)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_ncc_matmul_matches_conv_oracle(data):
    frame, templ = data
    a = np.asarray(ncc_map_matmul(jnp.asarray(frame), jnp.asarray(templ)))
    b = np.asarray(ncc_map_reference(jnp.asarray(frame), jnp.asarray(templ)))
    np.testing.assert_allclose(a, b, atol=5e-5)


def test_strip_wise_equals_whole(rng):
    frame = rng.random((100, 90)).astype(np.float32)
    templ = rng.random((17, 13)).astype(np.float32)
    whole = np.asarray(ncc_map_matmul(jnp.asarray(frame), jnp.asarray(templ)))
    for strip in (1, 7, 32, 83, 84, 1000):
        strips = np.asarray(
            ncc_map_matmul(jnp.asarray(frame), jnp.asarray(templ), strip_rows=strip)
        )
        np.testing.assert_allclose(strips, whole, atol=1e-6)


def test_full_fn_and_region_fn_consistent(rng):
    """make_region_fn sliced at (x0, y0) must equal the same window of the
    full map (the fused-path correctness contract)."""
    frame = rng.random((120, 160)).astype(np.float32)
    templ = rng.random((16, 16)).astype(np.float32)
    t_mean, t_std = template_stats(jnp.asarray(templ))
    full = np.asarray(
        make_full_fn(strip_rows=32)(jnp.asarray(frame), jnp.asarray(templ), t_mean, t_std)
    )
    span = 21
    region_fn = make_region_fn(span, span)
    for (x0, y0) in [(0, 0), (40, 30), (160 - 16 + 1 - span, 120 - 16 + 1 - span)]:
        reg = np.asarray(
            region_fn(
                jnp.asarray(frame), jnp.asarray(templ), t_mean, t_std,
                jnp.int32(x0), jnp.int32(y0),
            )
        )
        np.testing.assert_allclose(
            reg, full[y0 : y0 + span, x0 : x0 + span], atol=2e-5
        )


def test_flat_window_epsilon_clamp(rng):
    frame = np.full((40, 40), 0.25, np.float32)
    templ = rng.random((8, 8)).astype(np.float32)
    got = np.asarray(ncc_map_matmul(jnp.asarray(frame), jnp.asarray(templ)))
    assert np.all(np.isfinite(got))
    assert np.all(np.abs(got) < 1e-3)


def test_opencv_matmul_matches_conv_oracle(rng):
    """--cpu parity backend: matmul formulation == conv-based TM_CCOEFF."""
    from pvot.ops.ncc_matmul import ncc_map_opencv_matmul
    from pvot.ops.ncc_reference import ncc_map_opencv

    frame = rng.random((96, 120)).astype(np.float32)
    templ = frame[10:42, 50:90].copy()
    a = np.asarray(ncc_map_opencv_matmul(jnp.asarray(frame), jnp.asarray(templ)))
    b = np.asarray(ncc_map_opencv(jnp.asarray(frame), jnp.asarray(templ)))
    np.testing.assert_allclose(a, b, atol=5e-5)
    s = np.asarray(
        ncc_map_opencv_matmul(jnp.asarray(frame), jnp.asarray(templ), strip_rows=17)
    )
    np.testing.assert_allclose(s, a, atol=1e-6)


def test_conv1d_cross_correlate_matches_im2col(rng):
    """cross_correlate_conv1d is an alternate lowering of the same math
    (f32 reassociation tolerance)."""
    import jax.numpy as jnp

    from pvot.ops.ncc_matmul import cross_correlate, cross_correlate_conv1d

    img = jnp.asarray(rng.random((64, 96), dtype=np.float32))
    templ = jnp.asarray(rng.random((16, 16), dtype=np.float32) - 0.5)
    a = np.asarray(cross_correlate(img, templ))
    b = np.asarray(cross_correlate_conv1d(img, templ))
    np.testing.assert_allclose(a, b, atol=1e-5)
