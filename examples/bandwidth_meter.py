#!/usr/bin/env python
"""Occupied-bandwidth meter (``examples/bandwidth_meter/main.rs`` analog).

Tunes into a synthetic SDR stream, decimates to 102.4 kHz, low-passes,
overlaps chunks, FFTs with a Kaiser window, and prints the maximum
occupied bandwidth over a sliding window — all analysis on device.
"""

import asyncio
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


import numpy as np

from radiorust_tpu.metering import bandwidth
from radiorust_tpu.models.bandwidth_meter import bandwidth_meter_chain
from radiorust_tpu.runtime import (ArraySink, Rechunker, RuntimeBlock,
                                   wait_until)
from radiorust_tpu.runtime.io import SdrRx, SyntheticSdrDriver


async def main():
    max_bandwidth = 50e3
    quality = 4
    drv = SyntheticSdrDriver(1024000.0,
                             tones=((5000.0, 1.0), (-4000.0, 0.7)),
                             noise=0.001)
    sdr = SdrRx(drv)
    rechunk = Rechunker(10240)
    chain = RuntimeBlock(
        bandwidth_meter_chain(max_bandwidth=max_bandwidth, quality=quality),
        name="bw_meter")
    sink = ArraySink()
    rechunk.feed_from(sdr)
    chain.feed_from(rechunk)
    sink.feed_from(chain)

    await sdr.activate()
    await wait_until(  # fail fast if any actor failed
        lambda: len(sink.chunks) >= 12, sdr, rechunk, chain, sink)
    await sdr.deactivate()

    values = [bandwidth(0.01, sink.sample_rate, c)
              for c in sink.chunks[quality + 1:]]
    print(f"analysis rate {sink.sample_rate} Hz; "
          f"max occupied bandwidth {max(values):.0f} Hz "
          f"(expect ~>9 kHz for tones at +5 kHz and -4 kHz)")


if __name__ == "__main__":
    asyncio.run(main())
