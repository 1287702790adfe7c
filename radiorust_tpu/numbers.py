"""Numeric policy for the radio framework.

The reference (radiorust ``src/numbers.rs:23-42``) abstracts over f32/f64 via
a ``Float`` trait; streams run in complex f32 at every I/O boundary while
filter/IR design math runs in f64 (``src/blocks/filters.rs:165-166,188``).

This build fixes the same split as a *policy* instead of a generic
parameter:

- **Stream dtype**: ``complex64`` (f32 pairs) on device — matches the
  reference's I/O precision (``src/blocks/io/rf/soapysdr.rs:35``) and is the
  accelerator's fast path.
- **Design dtype**: ``float64`` / ``complex128`` on host (numpy) — filter
  responses, window tables, resampler taps are computed exactly like the
  reference's f64 design path and only then cast to the stream dtype.
"""

from __future__ import annotations

import os

import numpy as np

# Device (stream) dtypes — everything that flows per-sample on the device.
REAL_DTYPE = np.float32
COMPLEX_DTYPE = np.complex64

# Host (design) dtypes — filter design, window tables, tap generation.
DESIGN_REAL_DTYPE = np.float64
DESIGN_COMPLEX_DTYPE = np.complex128

TAU = 2.0 * np.pi

# ---------------------------------------------------------------------------
# Stream-dtype policy knob (f64 stream mode)
# ---------------------------------------------------------------------------
# The reference is generic over f32/f64 for the whole stream path
# (src/numbers.rs:23-42: every block is Flt: Float).  This build fixes
# streams to complex64 — the fast path — but offers ``c128`` as a
# *CPU-backend validation mode*: bind blocks under it and the compiled
# chain runs with complex128 streams, giving reference-class f64
# numerics for tight oracle twins.  Requirements and limits:
#
# - ``jax.config.update("jax_enable_x64", True)`` must be on in the
#   process (without it JAX silently truncates to f32).
# - Validated on the CPU backend.  The hand-written kernels stay
#   f32-only — blocks gate their kernel paths off under c128 and use
#   the XLA formulations (which are dtype-generic).
# - Read at BIND time (like config.py's trace-time knobs): set the mode
#   before constructing bound blocks.
_stream_mode: str | None = None

_MODES = {
    "c64": (np.float32, np.complex64),
    "c128": (np.float64, np.complex128),
}


def stream_mode() -> str:
    """``"c64"`` (default) or ``"c128"`` (f64 stream validation mode);
    env ``RRTPU_STREAM_DTYPE`` or :func:`set_stream_mode`."""
    if _stream_mode is not None:
        return _stream_mode
    mode = os.environ.get("RRTPU_STREAM_DTYPE", "c64").lower()
    if mode not in _MODES:
        raise ValueError(
            f"RRTPU_STREAM_DTYPE={mode!r}: expected one of "
            f"{sorted(_MODES)}")
    return mode


def set_stream_mode(mode: str | None) -> None:
    global _stream_mode
    if mode is not None and mode.lower() not in _MODES:
        raise ValueError(f"unknown stream mode {mode!r}")
    _stream_mode = None if mode is None else mode.lower()


def stream_real():
    """Real stream dtype under the current policy (np dtype class)."""
    return _MODES[stream_mode()][0]


def stream_complex():
    """Complex stream dtype under the current policy (np dtype class)."""
    return _MODES[stream_mode()][1]


def as_stream_complex(x):
    """Cast a host design-precision array to the device stream dtype."""
    return np.asarray(x).astype(stream_complex())


def as_stream_real(x):
    """Cast a host design-precision array to the device real stream dtype."""
    return np.asarray(x).astype(stream_real())
