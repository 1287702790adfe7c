"""The one owner of the matmul/convolution precision.

Every ``dot_general`` and convolution on the device path (the polyphase
resamplers, the channelizer's branch DFT) takes its ``precision`` from
:func:`matmul_precision`, read at *trace* time:

- ``highest`` (the default): full float32.  The library, ``bench.py``
  and ``chip_smoke.py`` all run in it.
- ``high`` / ``default``: lets the backend trade accuracy for speed (on
  a GPU, TF32 tensor cores for float32 operands).

``RRTPU_MATMUL_PRECISION`` or :func:`set_matmul_precision` selects
another mode for measurement without code changes.
"""

from __future__ import annotations

import os

import jax

__all__ = ["matmul_precision", "matmul_precision_name",
           "set_matmul_precision"]

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}

_matmul_precision: str | None = None


def matmul_precision_name() -> str:
    """Name of the precision mode in force (``"highest"`` by default)."""
    if _matmul_precision is not None:
        return _matmul_precision
    name = os.environ.get("RRTPU_MATMUL_PRECISION", "highest").lower()
    if name not in _PRECISIONS:
        raise ValueError(f"RRTPU_MATMUL_PRECISION={name!r}: expected one "
                         f"of {sorted(_PRECISIONS)}")
    return name


def matmul_precision() -> jax.lax.Precision:
    """Precision for all device matmuls and convolutions (trace-time)."""
    return _PRECISIONS[matmul_precision_name()]


def set_matmul_precision(name: str | None) -> None:
    """Override the matmul precision (``None`` restores the env default)."""
    global _matmul_precision
    if name is not None and name.lower() not in _PRECISIONS:
        raise ValueError(f"unknown precision {name!r}")
    _matmul_precision = None if name is None else name.lower()
