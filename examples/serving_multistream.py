"""Serving: S independent video streams from one process.

pvot.serve_streams runs one background decode/gray thread per stream and
tracks every lockstep chunk of all S streams as ONE jitted scan of the
vmapped multi-stream step (pvot.parallel.multi); streams may end at
different times.  pvot.serve_objects does the same for K trackers over one
stream.

Run:  python examples/serving_multistream.py       (CPU or GPU)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import pvot
from pvot.io.gray import gray_u8_to_f32
from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox

S = 4  # independent streams (each with its own template and trajectory)
specs = [
    SyntheticSpec(width=640, height=480, num_frames=80,
                  target_w=48, target_h=48, seed=10 + s)
    for s in range(S)
]
videos = np.stack([generate_gray_video(spec) for spec in specs])

# --- Live serving: frame ITERATORS ------------------------------------------
# pvot.serve_streams runs one background decode/gray thread per stream
# (pvot.io.pipeline.FramePipeline) concurrently with the device and tracks
# lockstep chunks.  Streams may end at different times; each stream's
# StepOutput has its own length.  Here stream s stops after 40 + 10*s frames.
lengths = [40 + 10 * s for s in range(S)]
feeds = [iter(videos[s, 1 : 1 + lengths[s]]) for s in range(S)]
# One tracker state per stream, stacked along a leading S axis (the layout
# pvot.parallel.multi.init_multi_state produces).
states2 = []
for s, spec in enumerate(specs):
    x, y, w, h = target_bbox(spec, 0)
    templ = jnp.asarray(gray_u8_to_f32(videos[s, 0])[y : y + h, x : x + w])
    states2.append(pvot.init_state(templ, (x, y, w, h)))
states2 = jax.tree.map(lambda *xs: jnp.stack(xs), *states2)

timings: list = []
final2, outs = pvot.serve_streams(
    feeds, states2, (480, 640), chunk_size=16, timings=timings
)
for s, spec in enumerate(specs):
    assert outs[s].bbox.shape[0] == lengths[s]
    want = np.array([target_bbox(spec, i + 1)[:2] for i in range(lengths[s])])
    assert np.abs(outs[s].bbox[:, :2] - want).max() <= 2
total = sum(n for n, _ in timings)
secs = sum(t for _, t in timings)
print(f"live serving: {total} frames across {S} streams in {secs:.2f}s "
      f"({total / secs:.0f} aggregate FPS incl. decode)")

# --- Multi-object: K trackers over ONE stream --------------------------------
# pvot.serve_objects runs every chunk of one live stream through the
# vmapped multi-object step (shared frames); output gains a (F, K) layout.
spec0 = specs[0]
x, y, w, h = target_bbox(spec0, 0)
obj_rois = [(x, y, w, h), (40, 30, 48, 48)]
frame0 = videos[0, 0].copy()
obj_states = jax.tree.map(
    lambda *xs: jnp.stack(xs),
    *[
        pvot.init_state(
            jnp.asarray(gray_u8_to_f32(frame0)[ry : ry + rh, rx : rx + rw]),
            (rx, ry, rw, rh),
        )
        for rx, ry, rw, rh in obj_rois
    ],
)
_, obj_out = pvot.serve_objects(
    iter(videos[0, 1:41]), obj_states, (480, 640), chunk_size=16
)
want = np.array([target_bbox(spec0, i + 1)[:2] for i in range(40)])
assert np.abs(obj_out.bbox[:, 0, :2] - want).max() <= 2
print(f"multi-object serving: {obj_out.bbox.shape[0]} frames x "
      f"{obj_out.bbox.shape[1]} objects, target err <= 2 px")
print("serving example OK")
