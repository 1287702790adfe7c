#!/usr/bin/env python
"""WFM receiver with a live spectrum/bandwidth readout — one device program.

The radiorust way to get this shape is broadcasting the tuned stream to
two consumer chains (audio playback + analysis, ``src/flow.rs:44-52``,
``examples/bandwidth_meter/main.rs:54-94``).  Here the whole fan-out DAG —
shared tuned front end, audio tail, and Overlapper->Fourier spectrum tap —
compiles into ONE XLA program (``wfm_receiver_graph``), served by a
``RuntimeGraph`` actor that publishes "audio" and "spectrum" on separate
capacity-1 senders.  Occupied bandwidth is metered on each spectrum like
the reference's bandwidth_meter app.
"""

import asyncio
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


import numpy as np

from radiorust_tpu.metering import bandwidth
from radiorust_tpu.models.wfm import wfm_receiver_graph
from radiorust_tpu.runtime import (ArraySink, Rechunker, RuntimeGraph,
                                   wait_until)
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
    rx = RuntimeGraph(wfm_receiver_graph(quality=4), name="wfm_graph")
    audio_sink = ArraySink()
    spectrum_sink = ArraySink()

    rechunk.feed_from(sdr)
    rx.feed_from(rechunk)
    audio_sink.feed_from(rx.out("audio"))
    spectrum_sink.feed_from(rx.out("spectrum"))

    await sdr.activate()
    await wait_until(  # 0.5 s of audio; fail fast if any actor failed
        lambda: sum(len(c) for c in audio_sink.chunks) >= 24000,
        sdr, rechunk, rx, audio_sink, spectrum_sink)
    await sdr.deactivate()

    audio = audio_sink.samples.real
    spec = np.abs(np.fft.rfft(audio[4096:] * np.hanning(len(audio) - 4096)))
    freqs = np.fft.rfftfreq(len(audio) - 4096, 1 / 48000.0)
    # Occupied bandwidth from the newest spectrum chunk, like
    # examples/bandwidth_meter/main.rs:76-94.
    bw = bandwidth(0.01, spectrum_sink.sample_rate,
                   np.asarray(spectrum_sink.chunks[-1]))
    print(f"audio: {audio_sink.sample_rate} Hz, {len(audio)} samples, "
          f"dominant tone {freqs[np.argmax(spec)]:.0f} Hz; "
          f"occupied bandwidth {bw / 1000.0:.1f} kHz")


if __name__ == "__main__":
    asyncio.run(main())
