"""chip_smoke.py rehearsed on the CPU: its phases at a tiny size (GPU and
reference both on the CPU device), the four-device path on virtual CPU
devices, its comparison, and its refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result_line(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            pass
    return False


def test_exits_nonzero_without_gpu():
    r = _run_script(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert not _has_result_line(r.stdout)
    assert "chip_smoke: needs a GPU" in r.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert not _has_result_line(r.stdout)


def test_phases_rehearsed_on_cpu(capsys):
    cpu = jax.devices("cpu")[0]
    assert chip_smoke.run_phases(chip_smoke.Sizes.tiny(), cpu, cpu) == []
    out = capsys.readouterr().out
    for phase in ("[wfm]", "[served]", "[stereo]", "[channelizer]",
                  "[isb]", "[morse_rf]", "[bw_meter]", "[wfm_tx]",
                  "[kernels]"):
        assert phase in out
    assert "precision highest" in out and "FAIL" not in out


def test_four_rehearsed_on_virtual_devices():
    devs = jax.devices()[:4]
    assert len(devs) == 4
    assert chip_smoke.run_four(chip_smoke.Sizes.tiny(), devs) == []


def test_compare_rejects_a_mismatch():
    rng = np.random.default_rng(0)
    want = rng.standard_normal((4, 2, 64)).astype(np.complex64)
    chip_smoke.compare("same", want.copy(), want, skip=1, tol=1e-6)
    got = want.copy()
    got[2] *= 1.01                     # 2% energy error in a steady chunk
    with pytest.raises(AssertionError):
        chip_smoke.compare("off", got, want, skip=1, tol=1e-3)
    got = want.copy()
    got[3, 0, 5] = np.nan
    with pytest.raises(AssertionError):
        chip_smoke.compare("nan", got, want, skip=1, tol=1e-3)


def test_compare_skips_warmup_chunks():
    rng = np.random.default_rng(1)
    want = rng.standard_normal((4, 2, 64)).astype(np.complex64)
    got = want.copy()
    got[0] *= 3.0                      # warmup chunk: not compared
    chip_smoke.compare("warmup", got, want, skip=1, tol=1e-6)


@pytest.mark.gpu
def test_kernels_phase_on_gpu(gpu_device):
    # The kernel phase at a small width: the slew kernel compiled for the
    # card against lax.scan on the CPU.
    chip_smoke.phase_kernels(chip_smoke.Sizes.tiny(), gpu_device,
                             jax.devices("cpu")[0])
