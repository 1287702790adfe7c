"""bench.py, and the published peak table of tools/mfu.py."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import mfu  # noqa: E402


def test_bench_refuses_to_run_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_peaks_known_for_h100():
    p = mfu.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_tflops"] == 989.0 and p["hbm_gbps"] == 3350.0
    assert p["f32_tflops"] < p["tf32_tflops"] < p["bf16_tflops"]


def test_peaks_unknown_device_is_an_error():
    with pytest.raises(KeyError, match="no published peaks"):
        mfu.peaks("cpu")
