"""Entry-point contract: dryrun_multichip must work when invoked bare (no
env preparation) and always rehearses on virtual CPU devices."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_in_process():
    """Under the test env (8 CPU devices already initialized) the dry run
    executes in-process."""
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as g

        g.dryrun_multichip(8)
    finally:
        sys.path.remove(REPO)


@pytest.mark.slow
def test_dryrun_multichip_bare_subprocess():
    """A bare invocation: a fresh interpreter with no XLA_FLAGS or
    platform forcing.  The entry must self-configure the CPU mesh."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env.pop("JAX_PLATFORM_NAME", None)
    # Keep PYTHONPATH entries but make the repo importable.
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    result = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert result.returncode == 0, result.stderr
    assert "dryrun_multichip ok" in result.stdout
