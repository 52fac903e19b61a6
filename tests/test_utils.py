"""Utils coverage: timers (C9) and the profiler hook."""

import tempfile
import time

import numpy as np
import pytest

from pvot.utils.timing import FpsCounter, StageTimer


def test_fps_counter_summary_format():
    c = FpsCounter()
    for _ in range(5):
        c.tick()
    s = c.summary("Interactive")
    assert s.startswith("Interactive tracking summary: frames=5, time=")
    assert ", FPS=" in s
    assert c.average_fps > 0


def test_stage_timer_accumulates():
    t = StageTimer()
    for _ in range(3):
        with t.stage("decode"):
            time.sleep(0.002)
    with t.stage("track"):
        time.sleep(0.001)
    assert t.counts["decode"] == 3 and t.counts["track"] == 1
    assert t.totals["decode"] >= 0.006
    rep = t.report()
    assert "decode" in rep and "track" in rep


def test_stage_timer_blocks_on_device_work():
    import jax.numpy as jnp

    t = StageTimer()
    x = jnp.ones((256, 256))
    with t.stage("matmul", block=x):
        y = x @ x
    assert t.counts["matmul"] == 1


def test_profile_trace_writes_trace(tmp_path):
    import jax.numpy as jnp

    from pvot.utils.timing import profile_trace

    with profile_trace(str(tmp_path)):
        y = jnp.ones((64, 64)) @ jnp.ones((64, 64))
        y.block_until_ready()
    # jax.profiler writes a plugins/profile/<ts>/ tree
    found = list(tmp_path.rglob("*.xplane.pb")) + list(tmp_path.rglob("*trace*"))
    assert found, "no profiler artifacts written"


def test_checkpoint_path_normalized(tmp_path):
    """`--checkpoint-out state` must save AND resolve as state.npz (np.savez
    appends the suffix silently; save/report/load must agree)."""
    import jax.numpy as jnp

    from pvot.tracker.state import init_state
    from pvot.utils.checkpoint import load_state, save_state

    state = init_state(jnp.ones((4, 4), jnp.float32), (1, 2, 4, 4))
    raw = str(tmp_path / "state")  # no .npz suffix
    written = save_state(raw, state)
    assert written.endswith(".npz")
    import os

    assert os.path.exists(written)
    for p in (raw, written):  # both spellings load
        loaded = load_state(p)
        assert int(loaded.bbox_x) == 1 and int(loaded.bbox_y) == 2


def test_suite_merge_results_partial_run(tmp_path):
    """A partial suite run (--configs 7md) must refresh only its own rows
    in results.json — replacing matching (config, backend) rows in place,
    appending novel ones before _meta, never clobbering the rest (the
    round-3 regression: a 4-config sweep erased the whole committed
    table the docs are generated from)."""
    import json
    import os
    import sys

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    from benchmarks.suite import merge_results

    existing = [
        {"config": "a", "backend": "fast", "value": 1},
        {"config": "b", "backend": "xla_fast", "value": 2},
        {"_meta": "old"},
    ]
    path = tmp_path / "results.json"
    path.write_text(json.dumps(existing))
    merged = merge_results(str(path), [
        {"config": "b", "backend": "xla_fast", "value": 99},  # replace in place
        {"config": "c", "backend": "xla_fast", "value": 3},  # novel: append
        {"_meta": "new"},
    ])
    assert merged == [
        {"config": "a", "backend": "fast", "value": 1},
        {"config": "b", "backend": "xla_fast", "value": 99},
        {"config": "c", "backend": "xla_fast", "value": 3},
        {"_meta": "new"},
    ]
    # Same config under a DIFFERENT backend is a distinct row.
    merged2 = merge_results(str(path), [
        {"config": "a", "backend": "xla_fast", "value": 7},
    ])
    assert {"config": "a", "backend": "fast", "value": 1} in merged2
    assert {"config": "a", "backend": "xla_fast", "value": 7} in merged2
    # Missing file: new results pass through.
    assert merge_results(str(tmp_path / "none.json"), existing) == existing
    # Pre-merge-era duplicate keys collapse to the first occurrence
    # (replacement used to hit only the first; the second fossilized).
    path.write_text(json.dumps([
        {"config": "a", "backend": "fast", "value": 1},
        {"config": "a", "backend": "fast", "value": 0},
        {"_meta": "old"},
    ]))
    merged3 = merge_results(str(path), [
        {"config": "a", "backend": "fast", "value": 5},
    ])
    assert merged3 == [
        {"config": "a", "backend": "fast", "value": 5},
        {"_meta": "old"},
    ]
    # A successful re-run of suite key K drops K's fossil error row (the
    # error row is keyed "<config K>", the re-run's rows by real config
    # names, so in-place replacement alone never cleans it).
    path.write_text(json.dumps([
        {"config": "<config 4>", "error": "rc=1"},
        {"config": "b", "backend": "xla_fast", "value": 2},
        {"_meta": "old"},
    ]))
    merged4 = merge_results(str(path), [
        {"config": "r160", "backend": "xla_fast", "value": 9},
    ], succeeded={"4"})
    assert merged4 == [
        {"config": "b", "backend": "xla_fast", "value": 2},
        {"config": "r160", "backend": "xla_fast", "value": 9},
        {"_meta": "old"},
    ]
    # ...but a key that did NOT succeed keeps its error row.
    merged5 = merge_results(str(path), [], succeeded={"5"})
    assert {"config": "<config 4>", "error": "rc=1"} in merged5


@pytest.mark.parametrize("env_set", [True, False])
def test_jaxcache_enable_and_disable(tmp_path, monkeypatch, env_set):
    """With JAX_COMPILATION_CACHE_DIR set the cache goes there and the code
    sets no directory; without it, one fixed directory inside the checkout
    (the path is part of the cache key, so it never derives from a
    temporary name, a pid or the time)."""
    import os

    import jax

    from pvot.utils import jaxcache

    before = jax.config.jax_compilation_cache_dir
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
            jax.config.update("jax_compilation_cache_dir", None)
            assert jaxcache.enable_compilation_cache() == str(tmp_path / "c")
            assert jax.config.jax_compilation_cache_dir is None
            assert not (tmp_path / "c").exists()  # JAX creates it on write
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = jaxcache.enable_compilation_cache()
            assert got == os.path.join(repo, ".jax_cache") == jaxcache.CACHE_DIR
            assert os.path.isdir(got)
            assert jax.config.jax_compilation_cache_dir == got
            # Stable across calls and processes: no pid, time or temp name.
            assert jaxcache.enable_compilation_cache() == got
            assert str(os.getpid()) not in got
            assert not got.startswith(tempfile.gettempdir())
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_bench_smoke_tiny_geometry():
    """bench.run_bench end-to-end at a tiny geometry (CPU): guards the
    driver's headline entry against interface drift (round-3 regression
    class: a backend-contract change broke bench.py's unpack)."""
    from bench import run_bench

    r = run_bench(num_frames=16, width=256, height=192, templ=24,
                  chunk_size=8, passes=3)
    assert r["metric"] == "tracked_fps_720p_80px"
    assert r["value"] > 0
    assert r["max_l1_err_px"] <= 2
    assert (r["backend"], r["precision"]) == ("xla", "highest")
    assert r["platform"] == r["device_kind"] == "cpu"
    # elapsed_s covers the timed passes only (compilation is setup_s).
    assert r["elapsed_s"] == pytest.approx(sum(r["pass_times_s"]))
    assert len(r["pass_times_s"]) == 3
