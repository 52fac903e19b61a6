"""chip_smoke.py, bench.py and benchmarks/suite.py: they refuse to run
without a GPU, and every chip_smoke phase passes on virtual CPU devices at a
tiny geometry (the same code the card runs at 720p)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _last_line_is_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "ok" in json.loads(lines[-1])
    except ValueError:
        return False


@pytest.mark.parametrize("argv", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four-cards"],
                                  ["bench.py"],
                                  ["benchmarks/suite.py", "--configs", "2"]])
def test_refuses_without_gpu(argv):
    r = _run(argv)
    assert r.returncode != 0
    assert not _last_line_is_result(r.stdout)
    assert "GPU" in r.stdout + r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the rest of the repo it fails."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert not _last_line_is_result(r.stdout)


def test_suite_unknown_device_is_an_error():
    """Peak shares only against a device with published peaks."""
    from benchmarks import suite

    with pytest.raises(KeyError, match="no published peaks"):
        suite.device_info()


def test_suite_row_on_cpu_with_patched_peaks(monkeypatch):
    """A suite row end to end at a tiny geometry (peaks patched in for the
    CPU so the row's arithmetic runs): trajectory checked, fields named."""
    from benchmarks import suite

    monkeypatch.setitem(suite.PEAKS, "cpu", {"f32": 1e12, "tf32": 1e12})
    row = suite.bench_tracking("tiny", width=160, height=120, templ=24,
                               num_frames=8, chunk_size=4)
    assert row["max_l1_err_px"] <= 2 and row["value"] > 0
    assert row["peak_share_pct"] > 0


def test_fused_region_flops_counts_the_matmul():
    from benchmarks.suite import fused_region_flops

    # 720p/t80/r60: (121+79) rows x 121 columns x 80 x 80 MACs, x2 FLOPs.
    mm = 2.0 * 200 * 121 * 80 * 80
    assert mm < fused_region_flops(80, 60) < 1.01 * mm


@pytest.fixture(scope="module")
def chip_smoke_module():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("phase", [
    "engine", "cli", "global", "batch", "serving", "timing", "fanout",
    "sharded",
])
def test_chip_smoke_phase_tiny(phase, chip_smoke_module, tmp_path,
                               monkeypatch, need_devices):
    """Each phase at a tiny geometry on the CPU (4 virtual devices for the
    multi-device phases)."""
    cs = chip_smoke_module
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    small = dict(width=320, height=240)
    wd = str(tmp_path)
    if phase == "engine":
        cs.phase_engine_vs_reference(templ=24, radius=20, **small)
    elif phase == "cli":
        cs.phase_cli(num_frames=12, workdir=wd, **small)
    elif phase == "global":
        cs.phase_global(num_frames=24, **small)
    elif phase == "batch":
        cs.phase_batch(num_frames=10, workdir=wd, **small)
    elif phase == "serving":
        cs.phase_serving(num_frames=30, width=640, height=360, templ=48,
                         workdir=wd)
    elif phase == "timing":
        cs.phase_timing(num_frames=16, **small)
    elif phase == "fanout":
        need_devices(4)
        cs.phase_fanout(num_frames=12, **small)
    else:
        need_devices(4)
        cs.phase_sharded(num_frames=24, **small)


def test_same_track_reports_mismatch(chip_smoke_module):
    from pvot.tracker.state import StepOutput

    cs = chip_smoke_module
    a = StepOutput(np.zeros((2, 4), np.int32), np.zeros(2, np.float32),
                   np.zeros(2, bool), np.ones(2, bool))
    assert cs._same_track(a, a, "same") == (0.0, 0.0)
    b = a._replace(bbox=a.bbox + 1)
    with pytest.raises(AssertionError, match="bbox differs"):
        cs._same_track(a, b, "moved")
    c = a._replace(score=a.score + 1e-4)
    with pytest.raises(AssertionError, match="local-search"):
        cs._same_track(a, c, "score")
    # Global-search frames take the full-map bound.
    g = a._replace(used_global=np.ones(2, bool))
    g2 = g._replace(score=g.score + 1e-4)
    assert cs._same_track(g, g2, "global") == (0.0, pytest.approx(1e-4))
    with pytest.raises(AssertionError, match="global-search"):
        cs._same_track(g, g._replace(score=g.score + 1e-3), "global")
