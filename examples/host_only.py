"""Accelerator-free tracking: the native C++ NCC engine + host loop.

No GPU — and no JAX device — is touched anywhere in this script.
Run:  python examples/host_only.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pvot.io.gray import gray_u8_to_f32
from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot.models.host import track_video_host
from pvot.runtime import native

print(f"native C++ engine available: {native.available()} "
      "(falls back to numpy when False)")

spec = SyntheticSpec(width=640, height=480, num_frames=60,
                     target_w=48, target_h=48, seed=4)
frames = generate_gray_video(spec)
x, y, w, h = target_bbox(spec, 0)
template = gray_u8_to_f32(frames[0])[y : y + h, x : x + w]

final, out = track_video_host(frames[1:], template, (x, y, w, h))
errs = [
    abs(int(b[0]) - target_bbox(spec, i + 1)[0])
    + abs(int(b[1]) - target_bbox(spec, i + 1)[1])
    for i, b in enumerate(out["bbox"])
]
print(f"tracked {len(out['bbox'])} frames on the host; "
      f"final bbox {final['bbox']}; max |err| {max(errs)} px")
