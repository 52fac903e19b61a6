"""Single-stream benchmark: tracked frames/s at 720p with an 80x80 template.

Prints ONE JSON line.  The clip (a seeded synthetic video) is staged on the
device once; each timed pass re-tracks it from the same initial state
through pvot.track_video and ends when the outputs are on the host and the
final state is ready (block_until_ready), so the device has finished.  The
first pass compiles and is not timed.  The headline value is the median
pass; every pass's trajectory is checked against the ground truth.

    python bench.py        # needs a GPU; names the card and its power limit

run_bench() itself runs anywhere JAX does (the tests call it on the CPU at
a tiny geometry); only the __main__ entry refuses to run without a GPU.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np


def run_bench(
    num_frames: int = 2048,
    width: int = 1280,
    height: int = 720,
    templ: int = 80,
    chunk_size: int = 256,
    backend: str = "xla",
    passes: int = 5,
) -> dict:
    from pvot.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from pvot.config import TrackerConfig
    from pvot.io.gray import gray_u8_to_f32
    from pvot.io.synthetic import SyntheticSpec, generate_gray_video, target_bbox
    from pvot.ops.backends import ENGINE_PRECISION, resolve
    from pvot.tracker.scan import track_video
    from pvot.tracker.state import init_state
    from pvot.utils.device import device_fields

    spec = SyntheticSpec(
        width=width, height=height, num_frames=num_frames + 1,
        target_w=templ, target_h=templ, seed=1,
    )
    frames = generate_gray_video(spec)
    x, y, w, h = target_bbox(spec, 0)
    template = gray_u8_to_f32(frames[0])[y : y + h, x : x + w]
    config = TrackerConfig()
    state = init_state(jnp.asarray(template), (x, y, w, h))
    clip = jax.block_until_ready(jax.device_put(frames[1:]))
    truth = np.array([target_bbox(spec, i + 1)[:2] for i in range(num_frames)])

    def one_pass():
        final, out = track_video(
            clip, state, config, backend=backend, chunk_size=chunk_size
        )
        jax.block_until_ready(final)
        return out

    t0 = time.perf_counter()
    one_pass()  # compiles
    setup_s = time.perf_counter() - t0

    pass_times, errs, updated = [], [], True
    for _ in range(passes):
        t0 = time.perf_counter()
        out = one_pass()
        pass_times.append(time.perf_counter() - t0)
        bbox = np.asarray(out.bbox)
        errs.append(int(np.abs(bbox[:, :2] - truth).sum(axis=1).max()))
        updated = updated and bool(np.asarray(out.updated).all())
    med = statistics.median(pass_times)
    engine = resolve(backend)
    dev = device_fields()
    return {
        "metric": "tracked_fps_720p_80px",
        "value": num_frames / med,
        "unit": "frames/s",
        "frames": num_frames,
        "passes": passes,
        "ms_per_frame": med / num_frames * 1e3,
        "pass_times_s": pass_times,
        # Timed passes only; the compiling first pass is setup_s.
        "elapsed_s": sum(pass_times),
        "setup_s": setup_s,
        "max_l1_err_px": max(errs),
        "all_updated": updated,
        "backend": engine,
        "precision": ENGINE_PRECISION[engine],
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "device_count": dev["count"],
    }


if __name__ == "__main__":
    from pvot.utils.device import card_name_and_power_limit, require_gpu

    require_gpu("bench.py")
    result = run_bench()
    result["card_and_power_limit"] = card_name_and_power_limit()
    print(json.dumps(result))
