#!/usr/bin/env python
"""Interactive WFM tuner (``examples/relm_app/`` analog, terminal UI).

Runs the WFM receive pipeline live from a synthetic multi-station SDR
driver and accepts commands on stdin while streaming:

    f <hz>    retune the frequency shifter (phase-continuous)
    v <gain>  set volume
    b         print occupied bandwidth of the current pass band
    q         quit

This exercises the reference's control path while running: GUI FreqUp ->
``FreqShifter::set_shift`` -> watch channel -> phase-continuous table swap
(``examples/relm_app/main.rs:54-58``, ``src/blocks/transform.rs:384-390``)
becomes stdin -> ``RuntimeBlock.set_shift`` -> host retune of the traced
params + carried phase state, with no recompilation.

With ``--auto`` it runs a scripted session (used as a smoke test).
"""

import asyncio
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


import numpy as np

from radiorust_tpu.metering import bandwidth, level
from radiorust_tpu.models.wfm import wfm_receiver
from radiorust_tpu.runtime import ArraySink, Buffer, Rechunker, RuntimeBlock
from radiorust_tpu.runtime.io import SdrRx, SyntheticSdrDriver


class MultiStationDriver(SyntheticSdrDriver):
    """Two FM stations at +200 kHz and -150 kHz."""

    def __init__(self):
        super().__init__(1024000.0, tones=(), noise=0.002)
        self._phases = [0.0, 0.0]
        self._stations = [(200000.0, 800.0), (-150000.0, 2400.0)]

    def read(self, n):
        t = (np.arange(self._pos, self._pos + n)) / self.sample_rate
        self._pos += n
        out = np.zeros(n, np.complex64)
        for i, (carrier, audio_f) in enumerate(self._stations):
            audio = 0.5 * np.sin(2 * np.pi * audio_f * t)
            dphi = 2 * np.pi * (carrier + 150000.0 * audio) / self.sample_rate
            phase = self._phases[i] + np.cumsum(dphi)
            self._phases[i] = float(phase[-1]) % (2 * np.pi)
            out += np.exp(1j * phase).astype(np.complex64)
        out += (self.noise * self._rng.standard_normal(n)).astype(np.complex64)
        return out


async def main(auto: bool):
    drv = MultiStationDriver()
    sdr = SdrRx(drv)
    rechunk = Rechunker(16384)
    chain = RuntimeBlock(wfm_receiver(), name="wfm")
    sink = ArraySink()
    rechunk.feed_from(sdr)
    chain.feed_from(rechunk)
    sink.feed_from(chain)
    await sdr.activate()

    async def dominant_tone():
        while len(sink.chunks) < 4:
            await asyncio.sleep(0.05)
        audio = np.concatenate(sink.chunks[-4:]).real
        spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
        freqs = np.fft.rfftfreq(len(audio), 1.0 / sink.sample_rate)
        return freqs[np.argmax(spec)]

    async def handle(cmd: str) -> bool:
        cmd = cmd.strip()
        if not cmd:
            return True
        if cmd.startswith("f "):
            shift = float(cmd[2:])
            # Down-shift the wanted carrier to baseband.
            chain.set_shift(-shift)
            sink.chunks.clear()
            print(f"tuned to {shift:+.0f} Hz")
        elif cmd.startswith("v "):
            chain.set_gain(float(cmd[2:]))
            print("volume set")
        elif cmd == "b":
            audio = (np.concatenate(sink.chunks[-4:])
                     if len(sink.chunks) >= 4 else None)
            if audio is None:
                print("no audio yet")
            else:
                # Occupied bandwidth of the demodulated pass band, like
                # examples/bandwidth_meter/main.rs:76-94.
                bins = np.fft.fft(audio * np.hanning(len(audio)))
                bw = bandwidth(0.01, sink.sample_rate, bins)
                lvl = 10 * np.log10(max(level(audio), 1e-12))
                print(f"occupied bandwidth {bw:.0f} Hz "
                      f"(audio level {lvl:.1f} dB)")
        elif cmd == "q":
            return False
        return True

    if auto:
        await asyncio.sleep(0.2)
        t0 = await dominant_tone()
        print(f"untuned dominant audio tone: {t0:.0f} Hz")
        await handle("f 200000")
        await asyncio.sleep(0.2)
        t1 = await dominant_tone()
        print(f"tuned to +200 kHz station: {t1:.0f} Hz (expect ~800)")
        await handle("b")
        await handle("f -150000")
        await asyncio.sleep(0.2)
        t2 = await dominant_tone()
        print(f"tuned to -150 kHz station: {t2:.0f} Hz (expect ~2400)")
        assert abs(t1 - 800.0) < 40 and abs(t2 - 2400.0) < 60, (t1, t2)
        print("auto session OK")
    else:
        loop = asyncio.get_running_loop()
        print("commands: f <hz> | v <gain> | b | q")
        while True:
            line = await loop.run_in_executor(None, sys.stdin.readline)
            if not line or not await handle(line):
                break
    await sdr.deactivate()


if __name__ == "__main__":
    asyncio.run(main("--auto" in sys.argv))
