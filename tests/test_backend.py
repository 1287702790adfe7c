"""The backend policy (one owner of the kernel choice) and the compile
cache helper."""

import os
import subprocess
import sys

import jax
import pytest

from radiorust_tpu import backend
from radiorust_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,want", [("cpu", False), ("gpu", True)])
def test_use_kernels_by_platform(platform, want):
    assert backend.use_kernels(platform) is want


@pytest.mark.parametrize("platform", ["rocm", "neuron", "metal"])
def test_use_kernels_raises_on_other_platforms(platform):
    with pytest.raises(backend.UnsupportedPlatform, match=platform):
        backend.use_kernels(platform)


def test_platform_follows_default_backend_here():
    assert backend.platform() == "cpu"
    assert backend.use_kernels() is False


def test_platform_follows_default_device():
    # A process on the card runs its CPU reference inside
    # jax.default_device(cpu): the policy must see the CPU there.
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        assert backend.platform() == "cpu"
    with jax.default_device("gpu"):
        assert backend.platform() == "gpu"
        assert backend.use_kernels() is True


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="some_tool: needs a GPU, JAX "
                       "found 'cpu'"):
        backend.require_gpu("some_tool")


def test_require_gpu_counts_cards(monkeypatch):
    card = type("Dev", (), {"platform": "gpu"})()
    monkeypatch.setattr(jax, "devices", lambda *a: [card, card])
    assert backend.require_gpu("t", 2) == [card, card]
    with pytest.raises(SystemExit, match="needs 4 GPUs, found 2"):
        backend.require_gpu("t", 4)


def test_card_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(subprocess, "run", missing)
    assert backend.card().startswith("nvidia-smi unavailable")


@pytest.mark.parametrize("tool", ["bench_channelizer", "bench_configs",
                                  "bench_latency", "bench_serving",
                                  "exp_scan"])
def test_measuring_tools_refuse_to_run_without_gpu(tool):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                     f"{tool}.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert f"{tool}: needs a GPU" in r.stderr
    assert "{" not in r.stdout


def _cache_dir_in_child(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax\n"
            "from radiorust_tpu.utils.compile_cache import "
            "enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    return out.stdout.split()


def test_compile_cache_defaults_to_checkout(tmp_path):
    used, configured = _cache_dir_in_child(None)
    assert used == configured == str(compile_cache.CHECKOUT_CACHE)
    assert compile_cache.CHECKOUT_CACHE == \
        compile_cache.CHECKOUT_CACHE.parent / ".jax_cache"
    assert os.path.samefile(compile_cache.CHECKOUT_CACHE.parent, REPO)


def test_compile_cache_honours_env(tmp_path):
    used, configured = _cache_dir_in_child(str(tmp_path))
    assert used == configured == str(tmp_path)
