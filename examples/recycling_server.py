#!/usr/bin/env python
"""Long-lived serving with checkpoint-based worker recycling.

``serve_recycling`` bounds each worker's lifetime: serve N chunks,
checkpoint the live stream state (:meth:`RuntimeBlock.save_checkpoint`),
exit; a fresh process resumes bit-exactly — no Warmup re-emission, no
seam in the audio.  Whatever a process accumulates (host memory above
all) resets at every recycle.

The supervisor (this process) never initializes a jax backend; worker
generations run strictly serially, so each owns the card alone.  The
``if __name__ == "__main__"`` guard is REQUIRED: workers are spawn
processes, which re-import this module.

Run: JAX_PLATFORMS=cpu python examples/recycling_server.py
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import os

import numpy as np

from radiorust_tpu.blocks.base import Chain
from radiorust_tpu.blocks.filters import Filter
from radiorust_tpu.blocks.modulation import FmDemod
from radiorust_tpu.blocks.transform import FreqShifter
from radiorust_tpu.runtime import serve_recycling

RATE = 256000.0
CHUNK = 2048


def spec():
    """Rebuilt by every worker generation; only the stream state rides
    the checkpoint."""
    return Chain(
        FreqShifter.with_shift(5000.0),
        Filter.new(lambda bins, f: np.where(np.abs(f) <= 50e3, 1.0, 0.0)),
        FmDemod(75000.0),
    )


def main():
    t = np.arange(12 * CHUNK) / RATE
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * (2 * np.pi * 75000.0 / RATE * np.cumsum(audio))
                - 1j * 2 * np.pi * 5000.0 * t).astype(np.complex64)
    chunks = list(iq.reshape(12, CHUNK))

    platform = "cpu" if os.environ.get("JAX_PLATFORMS") == "cpu" else None
    outs, gens, warmups = serve_recycling(
        spec, chunks, RATE, chunks_per_worker=4,
        ckpt_path="/tmp/recycling_server_ckpt.npz", jax_platform=platform)

    out = np.concatenate(outs)
    tail = np.real(out[len(out) // 2:])
    spectrum = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
    peak = np.fft.rfftfreq(len(tail), 1.0 / RATE)[int(np.argmax(spectrum))]
    print(f"served {len(out)} samples across {gens} worker generations "
          f"(warmups per gen: {warmups}), dominant tone {peak:.0f} Hz")
    assert gens == 3 and warmups == [1, 0, 0], (gens, warmups)
    assert abs(peak - 1000.0) < 5.0, peak


if __name__ == "__main__":
    main()
