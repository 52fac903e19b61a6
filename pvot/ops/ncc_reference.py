"""Pure-JAX NCC (normalized cross-correlation) — the correctness oracle.

Reproduces the reference's NCC math exactly (SURVEY.md §2b).  Every CUDA
kernel in the reference computes, per output pixel (ox, oy)
(tracker_ghc/src/baseline_kernel.cu:17-47):

    N     = templW * templH
    sum   = sum of the N frame pixels under the window
    ssq   = sum of their squares
    mu_f  = sum / N
    var   = ssq / N - mu_f^2
    std_f = sqrt(max(var, 1e-6))
    cov   = sum((f - mu_f) * (t - mu_t))
    ncc   = cov / ((std_f + 1e-6) * (std_t_in + 1e-6) * N)

where (mu_t, std_t) come from the host wrapper via cv::meanStdDev (population
std) and std_t_in ALREADY includes one +1e-6 added host-side
(tracker_ghc/src/baseline_kernel.cu:263-266) — the template std gets two
epsilons, the frame std gets a variance clamp plus one epsilon.  We reproduce
that epsilon structure bit-for-bit in structure (f32 rounding differs only in
accumulation order).

Instead of a per-pixel loop, all window sums become XLA convolutions:

    sum  = corr2(frame,  ones)
    ssq  = corr2(frame²,  ones)
    cov  = corr2(frame,  templ - mu_t)     # Σ f(t-mu_t) == Σ(f-mu_f)(t-mu_t)
                                           # because Σ(t-mu_t) == 0

Also provides the cv::matchTemplate(TM_CCOEFF_NORMED) parity variant — the
reference's `--cpu` mode (tracker_ghc/src/main.cpp:158).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


def template_stats(templ: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Template mean and (population std + 1e-6).

    Mirrors the host wrapper (tracker_ghc/src/baseline_kernel.cu:263-266):
    cv::meanStdDev gives the population std; the wrapper adds 1e-6 before
    passing it to the kernel (which adds another 1e-6 in the denominator).
    """
    templ = templ.astype(jnp.float32)
    mean = jnp.mean(templ)
    var = jnp.mean(jnp.square(templ)) - jnp.square(mean)
    std = jnp.sqrt(jnp.maximum(var, 0.0)) + jnp.float32(1e-6)
    return mean, std


def corr2_valid(image: jax.Array, kernel: jax.Array) -> jax.Array:
    """Valid-mode 2-D cross-correlation (no kernel flip) via XLA conv.

    image (H, W) f32, kernel (h, w) f32 -> (H-h+1, W-w+1) f32.
    """
    out = lax.conv_general_dilated(
        image[None, None, :, :],
        kernel[None, None, :, :],
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32,
        # Full f32: the default precision may round inputs (TF32 on an
        # NVIDIA GPU), breaking parity with the reference's f32 kernels.
        precision=lax.Precision.HIGHEST,
    )
    return out[0, 0]


def window_moments(frame: jax.Array, templ_shape: Tuple[int, int]):
    """Per-window (mean, std) of the frame under each template placement.

    std uses the reference's variance clamp: sqrt(max(var, 1e-6))
    (tracker_ghc/src/baseline_kernel.cu:31-33).
    """
    th, tw = templ_shape
    n = jnp.float32(th * tw)
    ones = jnp.ones((th, tw), jnp.float32)
    sums = corr2_valid(frame, ones)
    ssq = corr2_valid(jnp.square(frame), ones)
    mean = sums / n
    var = ssq / n - jnp.square(mean)
    std = jnp.sqrt(jnp.maximum(var, jnp.float32(1e-6)))
    return mean, std


def ncc_map_reference(
    frame: jax.Array,
    templ: jax.Array,
    t_mean: jax.Array | None = None,
    t_std: jax.Array | None = None,
) -> jax.Array:
    """Full-frame NCC map with the reference kernels' exact semantics.

    frame (H, W) f32 in [0,1], templ (th, tw) f32 -> (H-th+1, W-tw+1) f32.
    Equivalent to nccKernelNaive / Shared / Const / ConstTiled — all five
    reference kernels compute identical math (SURVEY.md §0).

    t_mean/t_std may be passed to reuse cached template stats (t_std must
    already include the host-side +1e-6, see template_stats).
    """
    from pvot.io.gray import ensure_gray_f32

    frame = ensure_gray_f32(frame)
    templ = templ.astype(jnp.float32)
    if t_mean is None or t_std is None:
        t_mean, t_std = template_stats(templ)
    th, tw = templ.shape
    n = jnp.float32(th * tw)
    mean, std = window_moments(frame, (th, tw))
    cov = corr2_valid(frame, templ - t_mean)
    denom = (std + jnp.float32(1e-6)) * (t_std + jnp.float32(1e-6)) * n
    return cov / denom


def ncc_map_opencv(frame: jax.Array, templ: jax.Array) -> jax.Array:
    """cv::matchTemplate(TM_CCOEFF_NORMED) semantics — the reference's --cpu
    mode (tracker_ghc/src/main.cpp:158).

        R = Σ T'·I' / sqrt(Σ T'² · Σ I'²),  T' = T - mean(T),
                                            I' = I_win - mean(I_win)
    """
    from pvot.io.gray import ensure_gray_f32

    frame = ensure_gray_f32(frame)
    templ = templ.astype(jnp.float32)
    th, tw = templ.shape
    n = jnp.float32(th * tw)
    t_centered = templ - jnp.mean(templ)
    t_ssq = jnp.sum(jnp.square(t_centered))
    ones = jnp.ones((th, tw), jnp.float32)
    sums = corr2_valid(frame, ones)
    ssq = corr2_valid(jnp.square(frame), ones)
    win_ssq = jnp.maximum(ssq - jnp.square(sums) / n, 0.0)
    numer = corr2_valid(frame, t_centered)
    denom = jnp.sqrt(t_ssq * win_ssq)
    # OpenCV guards tiny denominators (crossCorr normalization): where the
    # window is (near-)constant the score snaps to 0 unless |numer| is also
    # large.  We use a plain epsilon guard; parity tests only probe textured
    # regions where the two agree to float tolerance.
    return numer / jnp.maximum(denom, jnp.float32(1e-12))


def ncc_map_batched(frames: jax.Array, templ: jax.Array) -> jax.Array:
    """Batched NCC maps against one template snapshot.

    frames (B, H, W) -> (B, outH, outW).  The equivalent of
    nccKernelNaiveBatched (tracker_ghc/src/baseline_kernel.cu:100-144):
    blockIdx.z-over-frames becomes a vmapped conv (one fused XLA dispatch).
    """
    t_mean, t_std = template_stats(templ)
    return jax.vmap(lambda f: ncc_map_reference(f, templ, t_mean, t_std))(frames)
