"""Oracle tests for the NCC ops (SURVEY.md §4 test strategy, items a/e).

The gold standard is a vectorized float64 NumPy transcription of the
reference CUDA kernel math (tracker_ghc/src/baseline_kernel.cu:17-47 plus the
host wrapper's template stats at :263-266), checked against the conv-based
JAX implementation, and cv2.matchTemplate for the --cpu parity mode.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pvot.ops.ncc_reference import (
    ncc_map_batched,
    ncc_map_opencv,
    ncc_map_reference,
    template_stats,
)

cv2 = pytest.importorskip("cv2")


def bruteforce_reference_map(frame: np.ndarray, templ: np.ndarray) -> np.ndarray:
    """f64 sliding-window transcription of nccKernelNaive + host wrapper."""
    frame = frame.astype(np.float64)
    templ = templ.astype(np.float64)
    th, tw = templ.shape
    n = th * tw
    t_mean = templ.mean()
    t_std = np.sqrt((templ**2).mean() - t_mean**2) + 1e-6  # host adds 1e-6
    windows = np.lib.stride_tricks.sliding_window_view(frame, (th, tw))
    sums = windows.sum(axis=(-1, -2))
    ssq = (windows**2).sum(axis=(-1, -2))
    mean = sums / n
    var = ssq / n - mean**2
    std = np.sqrt(np.maximum(var, 1e-6))
    cov = ((windows - mean[..., None, None]) * (templ - t_mean)).sum(axis=(-1, -2))
    return (cov / ((std + 1e-6) * (t_std + 1e-6) * n)).astype(np.float32)


@pytest.fixture
def frame_and_templ(rng):
    frame = rng.random((64, 80)).astype(np.float32)
    templ = frame[20:36, 30:42].copy()  # 16x12 patch of the frame
    return frame, templ


def test_reference_map_matches_bruteforce(frame_and_templ):
    frame, templ = frame_and_templ
    got = np.asarray(ncc_map_reference(jnp.asarray(frame), jnp.asarray(templ)))
    want = bruteforce_reference_map(frame, templ)
    assert got.shape == (64 - 16 + 1, 80 - 12 + 1)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_reference_map_peaks_at_source_location(frame_and_templ):
    frame, templ = frame_and_templ
    got = np.asarray(ncc_map_reference(jnp.asarray(frame), jnp.asarray(templ)))
    oy, ox = np.unravel_index(np.argmax(got), got.shape)
    assert (oy, ox) == (20, 30)
    assert got[oy, ox] > 0.99


def test_epsilon_structure_on_flat_window():
    """A constant frame region exercises the variance clamp: var=0 ->
    std=sqrt(1e-6), NOT a division blow-up (baseline_kernel.cu:33).

    Own RNG (not the shared fixture): the flat window makes cov a pure
    f32-cancellation residual whose magnitude depends on the template draw,
    so the tolerance is the clamped-denominator amplification bound, not
    ordinary f32 rounding."""
    rng = np.random.default_rng(42)
    frame = np.full((32, 32), 0.5, np.float32)
    templ = rng.random((8, 8)).astype(np.float32)
    got = np.asarray(ncc_map_reference(jnp.asarray(frame), jnp.asarray(templ)))
    want = bruteforce_reference_map(frame, templ)
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert np.all(np.isfinite(got))
    # cov on a flat window is ~0 -> scores ~0, not +-inf.
    assert np.all(np.abs(got) < 1e-3)


def test_template_stats_match_cv_meanstddev(rng):
    templ = rng.random((17, 23)).astype(np.float32)
    mean, std_eps = template_stats(jnp.asarray(templ))
    cv_mean, cv_std = cv2.meanStdDev(templ)
    np.testing.assert_allclose(float(mean), cv_mean[0, 0], atol=1e-6)
    np.testing.assert_allclose(float(std_eps), cv_std[0, 0] + 1e-6, atol=1e-6)


def test_opencv_parity_mode(rng):
    """--cpu mode parity: ncc_map_opencv vs cv2.matchTemplate(TM_CCOEFF_NORMED)
    (tracker_ghc/src/main.cpp:158)."""
    frame = rng.random((96, 120)).astype(np.float32)
    templ = frame[10:42, 50:90].copy()
    want = cv2.matchTemplate(frame, templ, cv2.TM_CCOEFF_NORMED)
    got = np.asarray(ncc_map_opencv(jnp.asarray(frame), jnp.asarray(templ)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_batched_matches_single(rng):
    """K3 equivalent: batched NCC == per-frame NCC (baseline_kernel.cu:100-144
    computes identical math per blockIdx.z)."""
    frames = rng.random((3, 48, 56)).astype(np.float32)
    templ = rng.random((12, 16)).astype(np.float32)
    batched = np.asarray(ncc_map_batched(jnp.asarray(frames), jnp.asarray(templ)))
    for i in range(3):
        single = np.asarray(ncc_map_reference(jnp.asarray(frames[i]), jnp.asarray(templ)))
        np.testing.assert_allclose(batched[i], single, atol=1e-6)


def test_reference_vs_opencv_differ_only_in_normalization(frame_and_templ):
    """Both modes agree on the argmax for a well-textured target even though
    the score normalization differs (SURVEY.md §7 'Hard parts')."""
    frame, templ = frame_and_templ
    ref = np.asarray(ncc_map_reference(jnp.asarray(frame), jnp.asarray(templ)))
    ocv = np.asarray(ncc_map_opencv(jnp.asarray(frame), jnp.asarray(templ)))
    assert np.unravel_index(np.argmax(ref), ref.shape) == np.unravel_index(
        np.argmax(ocv), ocv.shape
    )


def test_backend_registry_covers_reference_modes(rng):
    """Every reference CLI mode resolves to working (full, region) fns."""
    from pvot.config import TrackerConfig
    from pvot.ops.backends import MODE_TO_BACKEND, get_backend

    cfg = TrackerConfig(search_radius_x=6, search_radius_y=6)
    frame = jnp.asarray(rng.random((48, 64)).astype(np.float32))
    templ = jnp.asarray(rng.random((8, 8)).astype(np.float32))
    from pvot.ops.ncc_reference import template_stats

    t_mean, t_std = template_stats(templ)
    want = np.asarray(ncc_map_reference(frame, templ))
    for mode in ("cuda", "naive", "xla", "shared", "const", "const_tiled",
                 "batch", "ref_conv", "fast", "xla_fast", "auto"):
        assert mode in MODE_TO_BACKEND
        full_fn, region_fn = get_backend(mode, (48, 64), (8, 8), cfg)
        got = np.asarray(full_fn(frame, templ, t_mean, t_std))
        np.testing.assert_allclose(got, want, atol=5e-5, err_msg=mode)
        reg = np.asarray(
            region_fn(frame, templ, t_mean, t_std, jnp.int32(5), jnp.int32(7))
        )
        np.testing.assert_allclose(reg, want[7:20, 5:18], atol=5e-5, err_msg=mode)
    # cpu mode normalizes differently (TM_CCOEFF_NORMED) but must run.
    full_fn, region_fn = get_backend("cpu", (48, 64), (8, 8), cfg)
    assert np.asarray(full_fn(frame, templ, t_mean, t_std)).shape == want.shape


def test_uint8_wire_dtype_matches_f32(rng):
    """Every backend accepts uint8 frames (the wire dtype the hot path keeps
    until slicing) and produces bit-identical scores to pre-converted
    f32/255 frames: uint8->f32*(1/255) commutes with slicing/padding."""
    from pvot.config import TrackerConfig
    from pvot.io.gray import ensure_gray_f32
    from pvot.ops.backends import MODE_TO_BACKEND, get_backend
    from pvot.ops.ncc_reference import template_stats

    cfg = TrackerConfig(search_radius_x=6, search_radius_y=6)
    frame_u8 = jnp.asarray(
        rng.integers(0, 256, size=(48, 64)).astype(np.uint8)
    )
    frame_f32 = ensure_gray_f32(frame_u8)
    templ = frame_f32[10:18, 20:28]
    t_mean, t_std = template_stats(templ)
    for mode in sorted(set(MODE_TO_BACKEND.values())):
        full_fn, region_fn = get_backend(mode, (48, 64), (8, 8), cfg)
        a = np.asarray(full_fn(frame_u8, templ, t_mean, t_std))
        b = np.asarray(full_fn(frame_f32, templ, t_mean, t_std))
        np.testing.assert_array_equal(a, b, err_msg=mode)
        ra = np.asarray(
            region_fn(frame_u8, templ, t_mean, t_std, jnp.int32(5), jnp.int32(7))
        )
        rb = np.asarray(
            region_fn(frame_f32, templ, t_mean, t_std, jnp.int32(5), jnp.int32(7))
        )
        np.testing.assert_array_equal(ra, rb, err_msg=mode)


def test_auto_backend_engine_choice():
    """--auto names the xla engine outright: no compile or probe decides
    it, and the resolved functions are the matmul engine's."""
    from pvot.config import TrackerConfig
    from pvot.ops.backends import get_backend, resolve

    assert resolve("auto") == "xla"
    cfg = TrackerConfig(search_radius_x=10, search_radius_y=10)
    full_fn, region_fn = get_backend("auto", (48, 64), (8, 8), cfg)
    assert full_fn.__module__ == "pvot.ops.ncc_matmul"
    assert region_fn.__module__ == "pvot.ops.ncc_matmul"
