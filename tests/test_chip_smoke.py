"""chip_smoke.py off the card: it must refuse to run without a GPU or
without the library beside it, and every phase's checks must hold when
rehearsed at tiny sizes on the CPU backend."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_gpu():
    r = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("phase,kw", [
    ("phase_config1", dict(n=64)),
    ("phase_config2", dict(n=64, batch=16)),
    ("phase_served", dict(n=64, batch=10, requests=2)),
    ("phase_config3", dict(n=1 << 12)),
    ("phase_config4", dict(n=64)),
    ("phase_any_length", dict(batch=2)),
    ("phase_gradient", dict(n=128, batch=4)),
])
def test_phase_rehearsal(phase, kw):
    import fft_wgpu_tpu as ftt

    getattr(chip_smoke, phase)(ftt, np.random.default_rng(0), **kw)


def test_pencil_phase_rehearsal():
    """The four-card phase on 4 of the virtual CPU devices: results are
    split over all four and match lax.fft 3-D on device 0."""
    chip_smoke.pencil_phase(n=16, ndev=4, card=None)
