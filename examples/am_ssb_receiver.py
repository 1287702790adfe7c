#!/usr/bin/env python
"""AM and SSB receivers from the block library.

The reference ships FM-only demodulators and points users at ``MapSample``
for everything else (``src/blocks/transform.rs:108-187``); these chains are
that construction: an AM envelope detector and a filter-method USB/LSB
receiver built purely from existing blocks, served live by the runtime.

Synthesizes an AM station (1 kHz program tone, 30 kHz offset) and an SSB
station (1.5 kHz tone) into one 256 ksps IQ stream, then runs *both*
receivers off one SDR source in lock-step (the broadcast connector fans
the stream out like ``src/flow.rs:44-52``).
"""

import asyncio
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


import numpy as np

from radiorust_tpu.models.analog import (ANALOG_INPUT_CHUNK, am_receiver,
                                         ssb_receiver)
from radiorust_tpu.runtime import ArraySink, Rechunker, RuntimeBlock, wait_until
from radiorust_tpu.runtime.io import SdrRx, SyntheticSdrDriver

AM_OFFSET = 30000.0
SSB_OFFSET = -60000.0


class _TwoStationDriver(SyntheticSdrDriver):
    """One AM and one USB station sharing the passband."""

    def read(self, n):
        t = (np.arange(self._pos, self._pos + n)) / self.sample_rate
        self._pos += n
        program = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
        am = 0.8 * (1.0 + program) * np.exp(2j * np.pi * AM_OFFSET * t)
        usb = 0.5 * np.exp(2j * np.pi * (SSB_OFFSET + 1500.0) * t)
        return (am + usb).astype(np.complex64)


def dominant_tone(chunks, rate=32000.0):
    audio = np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).real
    audio = audio[len(audio) // 2:]
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    return float(np.fft.rfftfreq(len(audio), 1.0 / rate)[np.argmax(spec)])


async def main():
    sdr = SdrRx(_TwoStationDriver(256000.0, tones=(), noise=0.0))
    rechunk = Rechunker(ANALOG_INPUT_CHUNK)
    am = RuntimeBlock(am_receiver(tune_shift=-AM_OFFSET), name="am")
    ssb = RuntimeBlock(ssb_receiver(tune_shift=-SSB_OFFSET), name="ssb")
    am_sink, ssb_sink = ArraySink(), ArraySink()

    rechunk.feed_from(sdr)
    am.feed_from(rechunk)       # both receivers subscribe to the same
    ssb.feed_from(rechunk)      # connector -> lock-step broadcast delivery
    am_sink.feed_from(am)
    ssb_sink.feed_from(ssb)

    await sdr.activate()
    await wait_until(
        lambda: sum(len(c) for c in am_sink.chunks) >= 32000
        and sum(len(c) for c in ssb_sink.chunks) >= 32000,
        sdr, rechunk, am, ssb, am_sink, ssb_sink)
    await sdr.deactivate()

    print(f"AM  program tone: {dominant_tone(am_sink.chunks):.0f} Hz")
    print(f"SSB program tone: {dominant_tone(ssb_sink.chunks):.0f} Hz")


def isb_demo():
    """Independent-sideband reception: two programs on the two sidebands
    of ONE carrier, decoded simultaneously through a shared-transform
    FilterBank (`models.analog.isb_receiver` — both sideband filters run
    off one forward transform)."""
    import jax.numpy as jnp

    from radiorust_tpu.blocks.base import StreamSig
    from radiorust_tpu.blocks.graph import graph_scan
    from radiorust_tpu.models.analog import ANALOG_INPUT_RATE, isb_receiver

    rate, n, t_chunks, f_off = ANALOG_INPUT_RATE, ANALOG_INPUT_CHUNK, 8, 30e3
    t = np.arange(t_chunks * n) / rate
    iq = (0.5 * np.exp(2j * np.pi * (f_off + 1000.0) * t)      # USB: 1 kHz
          + 0.5 * np.exp(2j * np.pi * (f_off - 2000.0) * t)    # LSB: 2 kHz
          ).astype(np.complex64).reshape(t_chunks, 1, n)
    g = isb_receiver(tune_shift=-f_off).bind(
        {"iq": StreamSig(1, n, rate)})
    _, ys = graph_scan(g, g.params, g.init_state(), {"iq": jnp.asarray(iq)})
    for name in ("usb", "lsb"):
        audio = [np.asarray(ys[name])[c, 0] for c in range(t_chunks)]
        print(f"ISB {name} program tone: {dominant_tone(audio):.0f} Hz")


if __name__ == "__main__":
    asyncio.run(main())
    isb_demo()
