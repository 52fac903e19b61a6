"""Engine selection and precision: every CLI mode name resolves by name to
one engine and its stated precision, with no compile, probe or fallback;
removed engines and options are refused; the "xla" engine agrees with a
float64 NumPy transcription of the reference kernel at odd shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pvot.config import TrackerConfig
from pvot.ops.backends import ENGINE_PRECISION, MODE_TO_BACKEND, get_backend, resolve

# Reference mode name -> (engine, precision of its local-search correlation).
EXPECTED = {
    "cuda": ("xla", "highest"),
    "naive": ("xla", "highest"),
    "xla": ("xla", "highest"),
    "batch": ("xla", "highest"),
    "shared": ("xla", "highest"),
    "const": ("xla", "highest"),
    "const_tiled": ("xla", "highest"),
    "auto": ("xla", "highest"),
    "cpu": ("cpu", "highest"),
    "fast": ("xla_fast", "high"),
    "xla_fast": ("xla_fast", "high"),
    "ref_conv": ("ref_conv", "highest"),
}


def test_registry_lists_exactly_the_expected_modes():
    assert set(MODE_TO_BACKEND) == set(EXPECTED)
    assert set(ENGINE_PRECISION) == {e for e, _ in EXPECTED.values()}


@pytest.mark.parametrize("mode", sorted(EXPECTED))
def test_mode_resolves_without_compiling(mode, monkeypatch):
    """Resolution is by name: get_backend builds closures and compiles,
    runs and probes nothing."""
    engine, precision = EXPECTED[mode]
    assert resolve(mode) == engine
    assert ENGINE_PRECISION[engine] == precision

    def no_compile(*a, **k):
        raise AssertionError("get_backend must not compile or run anything")

    monkeypatch.setattr(jax, "jit", no_compile)
    monkeypatch.setattr(jax, "device_put", no_compile)
    fns = get_backend(mode, (48, 64), (8, 8), TrackerConfig())
    assert len(fns) == 2 and all(callable(f) for f in fns)


@pytest.mark.parametrize("name", [
    "mega", "pallas", "pallas_shear", "pallas_fast", "shear", "triton", "",
])
def test_removed_engines_are_refused(name):
    with pytest.raises(ValueError, match="unknown NCC backend"):
        resolve(name)
    with pytest.raises(ValueError):
        get_backend(name, (48, 64), (8, 8), TrackerConfig())


@pytest.mark.parametrize("flag,mode", [
    ("--cpu", "cpu"), ("--shared", "shared"), ("--const", "const"),
    ("--const_tiled", "const_tiled"), ("--fast", "fast"), ("--host", "host"),
    ("--auto", "auto"),
])
def test_cli_mode_flags(flag, mode):
    from pvot.cli.main import parse_args

    args = parse_args(["clip.mp4", flag])
    assert args.mode == mode and args.engine == mode
    if mode != "host":
        assert resolve(mode) == EXPECTED[mode][0]


@pytest.mark.parametrize("flag", ["--mega", "--pallas_fast"])
def test_cli_removed_flags_are_errors(flag):
    from pvot.cli.main import parse_args

    with pytest.raises(SystemExit) as e:
        parse_args(["clip.mp4", flag])
    assert e.value.code == 2


@pytest.mark.parametrize("argv", [
    ["--score-passes", "1"], ["--scan-backend", "xla"], ["--no-prepad"],
    ["--pipeline-depth", "2"],
])
def test_serve_cli_removed_options_are_errors(argv):
    from pvot.cli.serve import parse_args

    with pytest.raises(SystemExit) as e:
        parse_args(["--synthetic", "64x48x4"] + argv)
    assert e.value.code == 2


@pytest.mark.parametrize("flags,engine", [([], "xla"), (["--fast"], "xla_fast")])
def test_serve_cli_names_its_engine(flags, engine, capsys):
    from pvot.cli.serve import main

    rc = main(["--synthetic", "160x120x5", "--streams", "2", "--roi",
               "60,40,24,24", "--chunk-size", "4", "--search-radius", "8"]
              + flags)
    assert rc == 0
    assert f"engine {engine}\n" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--shared", "--const_tiled", "--auto",
                                  "--fast", "--cpu"])
def test_cli_names_its_engine(flag, tmp_path, monkeypatch, capsys):
    from pvot.cli.main import main

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    rc = main(["--synthetic", "160x120x4", "--first", "--roi", "60,40,24,24",
               "--search-radius", "8", "--chunk-size", "4", flag])
    assert rc == 0
    mode = flag[2:]
    assert f"NCC engine: {EXPECTED[mode][0]}\n" in capsys.readouterr().out


def _ncc_f64(frame, templ, t_std_host):
    """The reference kernel's math (baseline_kernel.cu:17-47) in float64."""
    th, tw = templ.shape
    win = np.lib.stride_tricks.sliding_window_view(frame, (th, tw))
    n = th * tw
    mu = win.mean(axis=(2, 3))
    sd = np.sqrt(np.maximum((win * win).mean(axis=(2, 3)) - mu * mu, 1e-6))
    cov = np.einsum("yxij,ij->yx", win, templ - templ.mean())
    return cov / ((sd + 1e-6) * (t_std_host + 1e-6) * n)


@pytest.mark.parametrize("h,w,th,tw", [
    (37, 53, 9, 11), (64, 41, 13, 9), (29, 90, 7, 15), (50, 50, 17, 17),
    (33, 129, 9, 31), (140, 36, 31, 9), (30, 30, 22, 22), (71, 97, 11, 13),
])
@pytest.mark.parametrize("engine", ["xla", "xla_fast"])
def test_engine_matches_float64_oracle_odd_shapes(h, w, th, tw, engine):
    """Full map and candidate window at odd shapes vs float64 NumPy, within
    the oracle tests' 1e-5 (float32 accumulation order).  Windows hold at
    least ~100 pixels: below that the variance's cancellation, not the
    engine, sets the error.  On the CPU Precision.HIGH is float32 too; on
    an H100 it is TF32 (see pvot.ops.backends), which this bound does not
    cover."""
    from pvot.ops.ncc_reference import template_stats

    rng = np.random.default_rng(h * 1000 + w)
    frame = rng.random((h, w)).astype(np.float32)
    templ = rng.random((th, tw)).astype(np.float32)
    t_mean, t_std = template_stats(jnp.asarray(templ))
    want = _ncc_f64(frame.astype(np.float64), templ.astype(np.float64),
                    float(np.float64(templ).std()) + 1e-6)
    radius = max(1, min(h - th, w - tw) // 3)
    cfg = TrackerConfig(search_radius_x=radius, search_radius_y=radius)
    full_fn, region_fn = get_backend(engine, (h, w), (th, tw), cfg)
    got = np.asarray(full_fn(jnp.asarray(frame), jnp.asarray(templ), t_mean,
                             t_std))
    np.testing.assert_allclose(got, want, atol=1e-5)
    span = 2 * radius + 1
    x0, y0 = (w - tw + 1 - span) // 2, (h - th + 1 - span) // 2
    reg = np.asarray(region_fn(jnp.asarray(frame), jnp.asarray(templ), t_mean,
                               t_std, jnp.int32(x0), jnp.int32(y0)))
    np.testing.assert_allclose(reg, want[y0 : y0 + span, x0 : x0 + span],
                               atol=1e-5)


@pytest.mark.gpu
def test_engine_matches_oracle_on_gpu():
    """At the deployment geometry (720p, 80x80 template, radius 60) on the
    card: the chip smoke test's phase 1."""
    import chip_smoke

    chip_smoke.phase_engine_vs_reference()
