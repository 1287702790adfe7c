#!/usr/bin/env python
"""Morse transmitter (``examples/morse/main.rs`` analog).

Reads messages from stdin, keys them through the compiled morse audio
chain (slew limit -> 100 Hz low-pass -> gain -> +700 Hz tone), and plays
them through the audio driver (loopback driver here; swap in a real
sounddevice-backed driver on a workstation).
"""

import asyncio
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


from radiorust_tpu.blocks.filters import Filter, SlewRateLimiter
from radiorust_tpu.blocks.morse import EndOfMessages, Speed
from radiorust_tpu.blocks.transform import FreqShifter, GainControl
from radiorust_tpu.runtime import KeyerSource, RuntimeBlock
from radiorust_tpu.runtime.io import AudioPlayer, LoopbackAudioDriver


async def main():
    import numpy as np

    keyer = KeyerSource(4096, 48000.0, Speed.from_paris_wpm(16.0),
                        message="VVV")
    limiter = RuntimeBlock(SlewRateLimiter(100.0))
    filt = RuntimeBlock(Filter.new(
        lambda bins, freqs: np.where(np.abs(freqs) <= 100.0,
                                     1.0 + 0.0j, 0.0j)))
    volume = RuntimeBlock(GainControl(0.5))
    audio_mod = RuntimeBlock(FreqShifter.with_shift(700.0))
    driver = LoopbackAudioDriver(48000.0)
    playback = AudioPlayer(driver)

    limiter.feed_from(keyer)
    filt.feed_from(limiter)
    volume.feed_from(filt)
    audio_mod.feed_from(volume)
    playback.feed_from(audio_mod)

    await asyncio.wait_for(
        playback.wait_for_event(lambda e: isinstance(e, EndOfMessages)),
        60.0)
    total = sum(len(c) for c in driver.played)
    print(f"played {total} samples "
          f"({total / 48000.0:.2f}s of keyed audio)")


if __name__ == "__main__":
    asyncio.run(main())
