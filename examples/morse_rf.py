#!/usr/bin/env python
"""Morse RF transmitter (``examples/morse_rf/main.rs`` analog).

Keys a message, FM-modulates it, and transmits through an SDR TX block,
deactivating the transmitter when the keyer signals EndOfMessages — the
reference's event-driven TX lifecycle (``morse_rf/main.rs:72-98``).
"""

import asyncio
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


import numpy as np

from radiorust_tpu.blocks.morse import EndOfMessages, Speed
from radiorust_tpu.models.morse_tx import morse_rf_chain
from radiorust_tpu.runtime import KeyerSource, RuntimeBlock
from radiorust_tpu.runtime.io import LoopbackSdrDriver, SdrTx


async def main():
    rate = 128000.0
    keyer = KeyerSource(8192, rate, Speed.from_paris_wpm(20.0),
                        message="CQ CQ")
    chain = RuntimeBlock(morse_rf_chain(deviation=2500.0), name="morse_rf")
    drv = LoopbackSdrDriver(rate)
    tx = SdrTx(drv)
    chain.feed_from(keyer)
    tx.feed_from(chain)

    await tx.activate()
    await asyncio.wait_for(
        tx.wait_for_event(lambda e: isinstance(e, EndOfMessages)), 120.0)
    await tx.deactivate()
    print("message transmitted; TX deactivated on EndOfMessages")


if __name__ == "__main__":
    asyncio.run(main())
