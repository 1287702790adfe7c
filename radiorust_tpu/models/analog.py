"""AM and SSB receive chains.

The reference library ships only FM demodulation
(``src/blocks/modulation.rs``), but its users build AM/SSB receivers from
the same primitives: tune with ``FreqShifter``, channel-select with
``Downsampler``, shape with ``Filter``, and demodulate with a ``MapSample``
closure (``src/blocks/transform.rs:108-187`` is exactly the "custom
demodulator" extension point its docs advertise).  These models are those
constructions as compiled chains — every stage is an existing block, so
they jit into one XLA program, batch across channels, and time-shard like
the WFM chain.

- :func:`am_receiver` — envelope detector: ``|x|`` is insensitive to
  residual carrier offset/phase, the audio band-pass removes the carrier's
  DC term.
- :func:`ssb_receiver` — filter-method SSB (USB/LSB): a one-sided
  ``Filter`` selects the sideband (gain 2 restores the half lost to the
  cut), then ``Re(x)`` collapses the analytic signal back to audio.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..blocks.base import Chain
from ..blocks.filters import Filter
from ..blocks.resampling import Downsampler
from ..blocks.transform import AgcControl, FreqShifter, GainControl, MapSample

__all__ = ["am_receiver", "ssb_receiver", "isb_receiver",
           "ANALOG_INPUT_RATE", "ANALOG_INPUT_CHUNK",
           "ANALOG_AUDIO_RATE", "ANALOG_AUDIO_CHUNK"]

ANALOG_INPUT_RATE = 256000.0
ANALOG_INPUT_CHUNK = 8192
ANALOG_AUDIO_RATE = 32000.0
ANALOG_AUDIO_CHUNK = 1024


def _envelope(x):
    mag = jnp.abs(x).astype(jnp.float32)
    return jax.lax.complex(mag, jnp.zeros_like(mag))


def _real_part(x):
    re = jnp.real(x).astype(jnp.float32)
    return jax.lax.complex(re, jnp.zeros_like(re))


def _audio_band(low: float, high: float):
    def resp(bins, freqs):
        keep = (np.abs(bins) >= 1) & (np.abs(freqs) >= low) \
            & (np.abs(freqs) <= high)
        return np.where(keep, 1.0 + 0.0j, 0.0j)
    return resp


def _sideband(low: float, high: float, lsb: bool):
    lo, hi = (-high, -low) if lsb else (low, high)

    def resp(bins, freqs):
        keep = (freqs >= lo) & (freqs <= hi)
        # Gain 2 restores the amplitude lost by discarding the conjugate
        # half of the (real) audio spectrum.
        return np.where(keep, 2.0 + 0.0j, 0.0j)
    return resp


def am_receiver(tune_shift: float = 0.0, volume: float = 1.0,
                audio_low: float = 20.0, audio_high: float = 5000.0,
                agc: bool = False) -> Chain:
    """AM broadcast receiver as one compiled chain.

    IQ at 256 ksps -> FreqShifter (center the carrier) -> Downsampler to
    32 ksps (bw 10 kHz channel) -> envelope ``|x|`` -> audio band-pass
    (DC block removes the carrier term) -> gain.  Output is the real
    audio stream at 32 ksps (``output_is_real`` propagates, so the audio
    filter runs its pair-packed real fast path).
    """
    return Chain(
        FreqShifter(tune_shift),
        Downsampler(ANALOG_AUDIO_RATE, 2.0 * audio_high),
        MapSample(_envelope, real_output=True),
        # Rectangular (exact bin-sampled) response like the reference's
        # deemphasis/DC-block stage (examples/relm_app/simple_receiver.rs:
        # 43-50): a windowed IR smears the one-bin DC notch and lets the
        # (large) carrier term leak into the audio.
        Filter.new_rectangular(_audio_band(audio_low, audio_high)),
        AgcControl(reference=volume, rate=1e-2) if agc
        else GainControl(volume),
    )


def ssb_receiver(tune_shift: float = 0.0, volume: float = 1.0,
                 lsb: bool = False, audio_low: float = 100.0,
                 audio_high: float = 3100.0, agc: bool = False) -> Chain:
    """Single-sideband receiver (filter method), USB by default.

    IQ at 256 ksps -> FreqShifter (suppressed carrier to DC) ->
    Downsampler to 32 ksps -> one-sided sideband Filter (selects
    ``[audio_low, audio_high]`` above — or below, for LSB — the carrier;
    the analytic-signal construction the stereo decoder's pilot filter
    also uses) -> ``Re(x)`` -> gain.
    """
    return Chain(
        FreqShifter(tune_shift),
        Downsampler(ANALOG_AUDIO_RATE, 2.0 * audio_high),
        Filter.new(_sideband(audio_low, audio_high, lsb)),
        MapSample(_real_part, real_output=True),
        AgcControl(reference=volume, rate=1e-2) if agc
        else GainControl(volume),
    )


def isb_receiver(tune_shift: float = 0.0, volume: float = 1.0,
                 audio_low: float = 100.0, audio_high: float = 3100.0,
                 agc: bool = False):
    """Independent-sideband (ISB) receiver: BOTH sidebands of one
    suppressed-carrier channel decoded simultaneously.

    ISB transmits two distinct programs on the upper and lower sidebands
    of a single carrier (a classic point-to-point HF mode); receiving it
    is two filter-method SSB receivers sharing everything up to the
    sideband split.  Here that split is ONE :class:`FilterBank` — the
    USB and LSB selection filters share a single forward transform and
    one previous-chunk state instead of running two full overlap-save
    filters.  Per-band outputs are identical to standalone
    :func:`ssb_receiver` chains tuned to each sideband.

    The reference library builds receivers as broadcast fan-outs of one
    tuned stream (``src/flow.rs:44-52``); this is that topology as a
    compiled DAG.  Returns a :class:`~radiorust_tpu.blocks.graph.Graph`
    with input ``"iq"`` (256 ksps) and real-audio outputs ``"usb"`` and
    ``"lsb"`` at 32 ksps.
    """
    from ..blocks.filters import FilterBank
    from ..blocks.graph import Graph

    g = Graph()
    iq = g.input("iq")
    common = g.chain([
        FreqShifter(tune_shift),
        Downsampler(ANALOG_AUDIO_RATE, 2.0 * audio_high),
    ], iq)
    usb_band = _sideband(audio_low, audio_high, lsb=False)
    lsb_band = _sideband(audio_low, audio_high, lsb=True)
    usb, lsb = g.bank(FilterBank([usb_band, lsb_band]), common)
    for name, node in (("usb", usb), ("lsb", lsb)):
        audio = g.add(MapSample(_real_part, real_output=True), node)
        audio = g.add(AgcControl(reference=volume, rate=1e-2) if agc
                      else GainControl(volume), audio)
        g.output(name, audio)
    return g
