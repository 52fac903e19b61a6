"""Quickstart: track a synthetic clip with the high-level API.

Run:  python examples/quickstart.py        (CPU or GPU; small shapes)
For a real video, replace the synthetic block with:
    from pvot.io.video import VideoReader
    frames = np.stack(list(VideoReader("clip.mp4")))   # gray u8
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot.models.ncc import NccTracker

spec = SyntheticSpec(width=640, height=480, num_frames=60,
                     target_w=48, target_h=48, seed=4)
frames = generate_gray_video(spec)          # (F, H, W) uint8 gray
roi = target_bbox(spec, 0)                  # (x, y, w, h) of the target

tracker = NccTracker(frames[0], roi)
out = tracker.track(frames[1:])             # one chunked scan dispatch

bboxes = np.asarray(out.bbox)
errs = [
    abs(int(b[0]) - target_bbox(spec, i + 1)[0])
    + abs(int(b[1]) - target_bbox(spec, i + 1)[1])
    for i, b in enumerate(bboxes)
]
print(f"tracked {len(bboxes)} frames; final bbox {tracker.bbox}; "
      f"max |err| {max(errs)} px; mean score {np.asarray(out.score).mean():.3f}")
