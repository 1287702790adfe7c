"""Bandwidth meter pipeline.

Rebuilds ``examples/bandwidth_meter/main.rs:43-97``: tune, decimate to
102.4 kHz, low-pass to half the max bandwidth, overlap ``quality`` chunks,
windowed FFT, then occupied-bandwidth metering on each spectrum.
"""

from __future__ import annotations

import numpy as np

from ..blocks.analysis import Fourier
from ..blocks.base import Chain
from ..blocks.chunks import Overlapper
from ..blocks.filters import Filter
from ..blocks.resampling import Downsampler
from ..blocks.transform import FreqShifter
from ..metering import bandwidth_jax
from ..windowing import Kaiser

__all__ = ["bandwidth_meter_chain", "measure_bandwidth"]


def bandwidth_meter_chain(freq_offset: float = 0.0,
                          max_bandwidth: float = 50000.0,
                          quality: int = 4,
                          analysis_rate: float = 102400.0) -> Chain:
    """Spectrum chain; feed 1.024 Msps IQ, get overlapped Kaiser spectra.

    The literal block-for-block chain of the reference
    (``examples/bandwidth_meter/main.rs:43-55``).
    """

    def lp(bins, freqs):
        return np.where(np.abs(freqs) <= max_bandwidth / 2.0,
                        1.0 + 0.0j, 0.0j)

    return Chain(
        FreqShifter.with_shift(freq_offset),
        Downsampler(analysis_rate, max_bandwidth),
        Filter.new(lp),
        Overlapper(quality),
        Fourier.with_window(Kaiser.with_null_at_bin(float(quality))),
    )


def measure_bandwidth(spectra, sample_rate: float,
                      double_percentile: float = 0.01):
    """Occupied bandwidth per spectrum: [..., n] -> [...] hertz
    (``examples/bandwidth_meter/main.rs:76-94``)."""
    return bandwidth_jax(double_percentile, sample_rate, spectra)
