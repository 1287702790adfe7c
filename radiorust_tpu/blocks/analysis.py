"""Spectral analysis blocks.

XLA equivalent of the reference's ``src/blocks/analysis.rs``:
:class:`Fourier` computes a windowed FFT per chunk.  Window values are
scaled so their energy sums to the chunk length (energy-preserving,
``src/blocks/analysis.rs:90-103``); ``center_dc`` rotates the DC bin to
index ``n//2`` (``src/blocks/analysis.rs:113-115``).  The per-chunk FFT
batches over all streams in one device call.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..numbers import as_stream_real
from ..windowing import Rectangular, Window, window_table
from .base import Block, BoundBlock, StreamSig

__all__ = ["Fourier"]


class _BoundFourier(BoundBlock):
    def __init__(self, sig: StreamSig, window: Window, center_dc: bool):
        self.in_sig = self.out_sig = sig
        self.center_dc = center_dc
        n = sig.chunk_len
        w = window_table(window, n)
        # Scale so sum(w^2) == n (src/blocks/analysis.rs:97).
        w = w * np.sqrt(n / np.sum(w * w))
        self.window_values = jnp.asarray(as_stream_real(w))
        self.params = ()

    def process(self, params, state, x, reset):
        y = jnp.fft.fft(x * self.window_values)
        if self.center_dc:
            y = jnp.roll(y, self.in_sig.chunk_len // 2, axis=-1)
        return state, y.astype(x.dtype)


class Fourier(Block):
    """Windowed FFT per chunk (``src/blocks/analysis.rs:26-133``)."""

    def __init__(self, window: Window = None, center_dc: bool = False):
        self.window = window if window is not None else Rectangular()
        self.center_dc = center_dc

    @classmethod
    def new_center_dc(cls) -> "Fourier":
        return cls(center_dc=True)

    @classmethod
    def with_window(cls, window: Window) -> "Fourier":
        return cls(window=window)

    @classmethod
    def with_window_center_dc(cls, window: Window) -> "Fourier":
        return cls(window=window, center_dc=True)

    def bind(self, sig: StreamSig) -> _BoundFourier:
        return _BoundFourier(sig, self.window, self.center_dc)
