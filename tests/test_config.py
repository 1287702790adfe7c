"""The one owner of the matmul/convolution precision (config.py)."""

import jax
import pytest

from radiorust_tpu import config


def test_default_is_highest(monkeypatch):
    monkeypatch.delenv("RRTPU_MATMUL_PRECISION", raising=False)
    assert config.matmul_precision_name() == "highest"
    assert config.matmul_precision() == jax.lax.Precision.HIGHEST


def test_env_selects_mode(monkeypatch):
    monkeypatch.setenv("RRTPU_MATMUL_PRECISION", "High")
    assert config.matmul_precision() == jax.lax.Precision.HIGH


def test_unknown_env_mode_raises(monkeypatch):
    monkeypatch.setenv("RRTPU_MATMUL_PRECISION", "tf32")
    with pytest.raises(ValueError, match="RRTPU_MATMUL_PRECISION"):
        config.matmul_precision()


def test_override_and_restore(monkeypatch):
    monkeypatch.delenv("RRTPU_MATMUL_PRECISION", raising=False)
    config.set_matmul_precision("default")
    try:
        assert config.matmul_precision() == jax.lax.Precision.DEFAULT
    finally:
        config.set_matmul_precision(None)
    assert config.matmul_precision_name() == "highest"
    with pytest.raises(ValueError):
        config.set_matmul_precision("bf16")
