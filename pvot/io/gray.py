"""Grayscale preprocessing with exact reference semantics.

The reference converts each BGR frame to CV_32F grayscale scaled by 1/255
(`to_gray` in tracker_ghc/include/utils.hpp:4-13: cv::cvtColor(BGR2GRAY) on
uint8, then convertTo(CV_32F, 1/255)).  OpenCV's uint8 BGR2GRAY is a
fixed-point weighted sum with rounding, 15 fractional bits:

    Y = (B*3735 + G*19235 + R*9798 + 16384) >> 15        (weights sum to 2^15)

We reproduce that bit-exactly on the host (via cv2 when present, else the
fixed-point formula in numpy); the device receives uint8 gray and converts
only the slices it reads (ensure_gray_f32).
"""

from __future__ import annotations

import numpy as np

try:  # OpenCV is available in this image; keep a pure-numpy fallback anyway.
    import cv2  # type: ignore

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

# OpenCV's fixed-point BGR2GRAY coefficients: R=0.299, G=0.587, B=0.114
# quantized to 15 fractional bits (verified bit-exact against this build's
# cv2.cvtColor; see tests/test_io.py::test_gray_fixed_point_formula).
_R_COEF, _G_COEF, _B_COEF, _SHIFT = 9798, 19235, 3735, 15
_ROUND = 1 << (_SHIFT - 1)


def bgr_to_gray_u8(frame_bgr: np.ndarray) -> np.ndarray:
    """uint8 BGR (H, W, 3) -> uint8 gray (H, W), bit-exact with cv2.cvtColor."""
    if frame_bgr.dtype != np.uint8 or frame_bgr.ndim != 3 or frame_bgr.shape[2] != 3:
        raise ValueError(f"expected uint8 HxWx3 BGR, got {frame_bgr.dtype} {frame_bgr.shape}")
    if _HAS_CV2:
        return cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)
    b = frame_bgr[..., 0].astype(np.uint32)
    g = frame_bgr[..., 1].astype(np.uint32)
    r = frame_bgr[..., 2].astype(np.uint32)
    y = (b * _B_COEF + g * _G_COEF + r * _R_COEF + _ROUND) >> _SHIFT
    return y.astype(np.uint8)


def gray_u8_to_f32(gray_u8: np.ndarray) -> np.ndarray:
    """uint8 gray -> float32 in [0, 1] (reference's convertTo(CV_32F, 1/255)).

    cv::convertTo multiplies by a double alpha before the float cast, so the
    scale happens in f64 and rounds once — reproduced here exactly.
    """
    return (gray_u8.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)


def to_gray(frame_bgr: np.ndarray) -> np.ndarray:
    """Reference `to_gray`: BGR uint8 -> float32 gray in [0, 1].

    Matches tracker_ghc/include/utils.hpp:4-13 exactly (fixed-point gray then
    1/255 scale).
    """
    return gray_u8_to_f32(bgr_to_gray_u8(frame_bgr))


# --- Device-side conversion -------------------------------------------------
# For the pipelined path we ship uint8 gray to the device (4x less PCIe/HBM
# traffic than f32) and do the 1/255 scale on-chip; `device_gray_scale` is the
# jittable piece.  A float-weight BGR path also exists for callers that want
# to push the full conversion on-device (not bit-exact with OpenCV's
# fixed-point rounding; differs by at most 1/255).

def device_gray_scale(gray_u8):
    """jnp uint8 gray -> float32/255 on device (jit-safe)."""
    import jax.numpy as jnp

    return gray_u8.astype(jnp.float32) * jnp.float32(1.0 / 255.0)


def ensure_gray_f32(img):
    """jnp uint8 gray -> f32/255 (reference utils.hpp:4-13); floats pass
    through as f32.

    The single conversion point every NCC op funnels through: because
    uint8->f32*(1/255) is elementwise, it commutes exactly with slicing and
    zero padding, so hot paths keep frames in uint8 (4x less HBM traffic)
    and convert only the slices they actually read.
    """
    import jax.numpy as jnp

    if img.dtype == jnp.uint8:
        return img.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    return img.astype(jnp.float32)

