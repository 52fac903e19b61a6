"""Multi-chip tracking over a jax.sharding Mesh — runnable anywhere via a
virtual 8-device CPU mesh (the same path a mesh of GPUs uses).

Run:  python examples/multichip_sharded.py

Mesh axes ("data", "search"): independent streams are data-parallel; each
stream's NCC candidate rows are sliced across the "search" axis and the
argmax is combined with an all_gather that preserves cv::minMaxLoc
tie-breaking (pvot/parallel/sharded.py).
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")  # drop this line on a real mesh

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from pvot.config import TrackerConfig
from pvot.io.gray import gray_u8_to_f32
from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
from pvot.parallel.sharded import track_video_sharded
from pvot.tracker.state import init_state

DATA, SEARCH = 2, 4  # 2 streams x 4-way sharded search = 8 devices
devices = np.array(jax.devices()[: DATA * SEARCH]).reshape(DATA, SEARCH)
mesh = Mesh(devices, ("data", "search"))

spec = SyntheticSpec(width=320, height=240, num_frames=20,
                     target_w=32, target_h=32, seed=4)
clip = generate_gray_video(spec)
x, y, w, h = target_bbox(spec, 0)
template = jnp.asarray(gray_u8_to_f32(clip[0])[y : y + h, x : x + w])

# One state per stream (here: the same clip twice, offset seeds in practice).
states = jax.tree.map(
    lambda *xs: jnp.stack(xs),
    *[init_state(template, (x, y, w, h)) for _ in range(DATA)],
)
videos = np.stack([clip[1:]] * DATA)  # (DATA, F, H, W)

config = TrackerConfig(search_radius_x=24, search_radius_y=24)
final, out = track_video_sharded(videos, states, mesh, config, chunk_size=8)
print(f"mesh {mesh.shape}; tracked {out.bbox.shape[0]} frames x {DATA} streams; "
      f"last bboxes {np.asarray(out.bbox)[-1].tolist()}")
