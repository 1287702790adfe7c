#!/usr/bin/env python
"""WFM broadcast receiver (``examples/relm_app/simple_receiver.rs`` analog).

Feeds synthetic (or file) SDR IQ at 1.024 Msps through the compiled WFM
chain and writes demodulated 48 kHz audio to a sink, with an elastic
Buffer bounding latency before playback, exactly like the reference chain.
"""

import asyncio
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


import numpy as np

from radiorust_tpu.models.wfm import wfm_receiver
from radiorust_tpu.runtime import (ArraySink, Buffer, Rechunker,
                                   RuntimeBlock, wait_until)
from radiorust_tpu.runtime.io import SdrRx, SyntheticSdrDriver


class _FmToneDriver(SyntheticSdrDriver):
    """Synthesizes an FM carrier modulated with a 1 kHz tone."""

    _phase = 0.0

    def read(self, n):
        t = (np.arange(self._pos, self._pos + n)) / self.sample_rate
        self._pos += n
        audio = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
        phase = self._phase + np.cumsum(
            2 * np.pi * 150000.0 * audio / self.sample_rate)
        self._phase = float(phase[-1]) % (2 * np.pi)
        return np.exp(1j * phase).astype(np.complex64)


async def main():
    drv = _FmToneDriver(1024000.0, tones=(), noise=0.0)
    sdr = SdrRx(drv)
    rechunk = Rechunker(16384)
    chain = RuntimeBlock(wfm_receiver(volume=1.0), name="wfm")
    buffer = Buffer(0.0, 0.0, 0.5, max_age=10.0)
    sink = ArraySink()

    rechunk.feed_from(sdr)
    chain.feed_from(rechunk)
    buffer.feed_from(chain)
    sink.feed_from(buffer)

    await sdr.activate()
    await wait_until(  # 1 s of audio; fail fast if any actor failed
        lambda: sum(len(c) for c in sink.chunks) >= 48000,
        sdr, rechunk, chain, buffer, sink)
    await sdr.deactivate()

    audio = sink.samples.real
    spec = np.abs(np.fft.rfft(audio[4096:] * np.hanning(len(audio) - 4096)))
    freqs = np.fft.rfftfreq(len(audio) - 4096, 1 / 48000.0)
    print(f"output rate: {sink.sample_rate} Hz, "
          f"{len(audio)} samples, dominant tone "
          f"{freqs[np.argmax(spec)]:.0f} Hz")


if __name__ == "__main__":
    asyncio.run(main())
