#!/usr/bin/env python
"""WFM receiver with 44.1 kHz audio output — the arbitrary-ratio story.

The reference resamples to ANY rate pair at any chunking through its
phase-accumulator loop (``src/blocks/resampling.rs:103-133``); sound
cards overwhelmingly want the 44.1 kHz family, which shares no
convenient factors with SDR rates (1.024 Msps / 44.1 kHz reduces to
p = 10240 per q = 441 — far coarser than any practical chunk).

Here the demodulated 384 kHz audio is taken straight to 44.1 kHz by a
phase-mode :class:`~radiorust_tpu.blocks.resampling.Downsampler`
(fixed padded output chunks + a deterministic valid schedule; the
runtime actor trims them into the gapless stream a sound card needs —
see ``blocks/resampling.py``).  Chain:

    IQ 1.024 Msps -> shift -> decimate 384k -> LPF -> FM demod
      -> deemphasis -> Downsampler(44100)   [phase mode, p=1280/q=147]

Run: JAX_PLATFORMS=cpu python examples/audio_44k_receiver.py
"""

import asyncio
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from radiorust_tpu.blocks.base import Chain
from radiorust_tpu.blocks.resampling import Downsampler
from radiorust_tpu.models.wfm import (WFM_INPUT_RATE, _deemphasis_band,
                                      _lowpass_100k)
from radiorust_tpu.blocks.filters import Filter
from radiorust_tpu.blocks.modulation import FmDemod
from radiorust_tpu.blocks.transform import FreqShifter
from radiorust_tpu.runtime import (ArraySink, ArraySource, RuntimeBlock,
                                   wait_until)

AUDIO_RATE = 44100.0
CHUNK = 16384


def make_iq(total: int) -> np.ndarray:
    """FM carrier with a 1 kHz program tone."""
    t = np.arange(total) / WFM_INPUT_RATE
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * t)
    return np.exp(1j * (2 * np.pi * 150000.0 / WFM_INPUT_RATE
                        * np.cumsum(audio))).astype(np.complex64)


async def main():
    iq = make_iq(32 * CHUNK)
    chain = Chain(
        FreqShifter.with_shift(0.0),
        Downsampler(384000.0, 200000.0),
        Filter.new(_lowpass_100k),
        FmDemod(150000.0),
        Filter.new_rectangular(_deemphasis_band),
        Downsampler(AUDIO_RATE, 2.0 * 18000.0),   # 384000/44100 = 1280/147
    )
    src = ArraySource(iq, chunk_len=CHUNK, sample_rate=WFM_INPUT_RATE)
    rx = RuntimeBlock(chain)
    sink = ArraySink()
    rx.feed_from(src)
    sink.feed_from(rx)
    want = int(len(iq) * AUDIO_RATE / WFM_INPUT_RATE * 0.9)
    # Fail fast if any actor dies (and count without re-concatenating).
    await wait_until(lambda: sum(len(c) for c in sink.chunks) >= want,
                     src, rx, sink, timeout=300.0)
    audio = np.real(sink.samples)
    n = len(audio) // 2
    tail = audio[n:]
    spec = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
    freqs = np.fft.rfftfreq(len(tail), 1.0 / AUDIO_RATE)
    peak = freqs[int(np.argmax(spec))]
    print(f"audio: {sink.sample_rate:.0f} Hz, {len(audio)} samples, "
          f"dominant tone {peak:.0f} Hz")
    assert sink.sample_rate == AUDIO_RATE
    assert abs(peak - 1000.0) < 30.0, peak


if __name__ == "__main__":
    asyncio.run(main())
