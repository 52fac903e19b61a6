"""NCC engine registry.

The reference exposes five interchangeable NCC kernels selected by CLI flag
(tracker_ghc/src/main.cpp:63-75, README.md:56-86).  pvot resolves each
reference mode name to one engine, by name alone: no compile, no probe and
no fallback sit between the name and the engine that runs.

  mode name                   engine      implementation
  ---------                   ------      --------------
  cuda (default), naive,      "xla"       im2col matmul + integral images
  batch, xla, shared, const,              (pvot.ops.ncc_matmul), f32 at
  const_tiled, auto                       Precision.HIGHEST
  cpu                         "cpu"       cv::matchTemplate(TM_CCOEFF_NORMED)
                                          parity math (ncc_matmul)
  fast, xla_fast              "xla_fast"  "xla" with the local-search
                                          correlation at Precision.HIGH
  ref_conv                    "ref_conv"  the conv oracle (tests only)

The reference's --shared/--const/--const_tiled kernels differ only in where
they keep the template and the frame tile; the math is the one naive NCC.
Here they alias the "xla" engine: a fused Triton kernel for the local search
(template and frame tile on chip, as those kernels did) was measured slower
than XLA end to end on an H100 (PERF.md), so it is not kept.  --batch=N
composes with any engine (pvot.tracker.scan).

Every engine provides (full_fn, region_fn):
  full_fn(frame, templ, t_mean, t_std) -> full NCC map (global search)
  region_fn(frame, templ, t_mean, t_std, x0, y0) -> (span_y, span_x) scores
      of the candidate window

Precision on an NVIDIA GPU: a float32 dot without an explicit precision may
run in TF32 there, so every engine states its precision.  Precision.HIGHEST
is float32 without TF32 (cuBLAS, measured 4e-7 relative error on an H100 at
the engine's dot shape).  XLA runs Precision.HIGH as TF32 on the H100: the
same 3.6e-4 relative error as DEFAULT (PERF.md).
"""

from __future__ import annotations

from typing import Callable, Tuple

from jax import lax

from pvot.config import TrackerConfig
from pvot.ops import ncc_matmul
from pvot.ops.ncc_reference import ncc_map_reference

# Reference CLI mode name -> engine name.
MODE_TO_BACKEND = {
    "cuda": "xla",
    "naive": "xla",
    "xla": "xla",
    "batch": "xla",
    "cpu": "cpu",
    "shared": "xla",
    "const": "xla",
    "const_tiled": "xla",
    "auto": "xla",
    "fast": "xla_fast",
    "xla_fast": "xla_fast",
    "ref_conv": "ref_conv",
}

# Engine name -> precision of its local-search correlation.
ENGINE_PRECISION = {
    "xla": "highest",
    "cpu": "highest",
    "xla_fast": "high",
    "ref_conv": "highest",
}


def resolve(name: str) -> str:
    """Mode or engine name -> engine name; unknown names raise."""
    engine = MODE_TO_BACKEND.get(name)
    if engine is None:
        raise ValueError(f"unknown NCC backend: {name!r}")
    return engine


def get_backend(
    name: str,
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig,
) -> Tuple[Callable, Callable]:
    """Resolve a mode or engine name to (full_fn, region_fn)."""
    del frame_shape, templ_shape  # every engine is shape-generic
    span_x = 2 * config.search_radius_x + 1
    span_y = 2 * config.search_radius_y + 1
    engine = resolve(name)
    full_fn = ncc_matmul.make_full_fn(strip_rows=128)
    if engine == "xla":
        return full_fn, ncc_matmul.make_region_fn(span_x, span_y)
    if engine == "xla_fast":
        region_fn = ncc_matmul.make_region_fn(
            span_x, span_y, precision=lax.Precision.HIGH
        )
        return full_fn, region_fn
    if engine == "cpu":
        return (
            ncc_matmul.make_opencv_full_fn(strip_rows=128),
            ncc_matmul.make_opencv_region_fn(span_x, span_y),
        )
    # "ref_conv"
    from pvot.tracker.step import default_region_fn

    return ncc_map_reference, default_region_fn(span_x, span_y)
