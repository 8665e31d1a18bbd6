"""Checks that need an NVIDIA GPU: the phases of chip_smoke.py, each run
in a fresh interpreter (the test session itself is pinned to the CPU by
conftest). On the machine with the card:

    python -m pytest tests/test_gpu.py -m gpu

Elsewhere every test skips.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.gpu


def _gpu_count() -> int:
    if shutil.which("nvidia-smi") is None:
        return 0
    out = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True)
    return sum(line.startswith("GPU ") for line in out.stdout.splitlines())


@pytest.fixture(scope="module")
def gpus():
    n = _gpu_count()
    if n == 0:
        pytest.skip("no NVIDIA GPU on this machine")
    return n


def _run(code: str, timeout: float = 1200) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke as cs\n{code}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc.stdout


@pytest.mark.parametrize("phase", ["pipeline", "reference", "cli", "kernels"])
def test_chip_smoke_phase(gpus, phase):
    _run(f"cs.device_phase()\ncs.{phase}_phase()")


def test_chip_smoke_four_cards(gpus):
    if gpus < 4:
        pytest.skip("needs four GPUs")
    out = _run("cs.main(['--four-cards'])")
    assert out.strip().splitlines()[-1].startswith('{"ok": true')
