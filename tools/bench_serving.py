#!/usr/bin/env python
"""Serving-path benchmark: host chunks through the asyncio runtime actor
(RuntimeBlock around the WFM chain) to a host sink, on the device.

``bench.py`` times the pure device loop: thousands of chunk steps inside
one jit program, the per-call dispatch amortized away.  A live receiver
doesn't get that luxury — each chunk arrives from
an SDR on the host, crosses the host->device boundary, and the audio must
come back.  This tool measures that *serving* path: wire packing,
host->device staging, per-chunk dispatch, device compute, device->host
fetch, and actor scheduling, for several chunk sizes and pipeline depths
(``RuntimeBlock(pipeline_depth=d)`` keeps d chunks of device work in
flight via JAX async dispatch — the analog of the reference's
task-per-block pipelining, src/blocks/mod.rs:27-34).

Prints one JSON line per variant.  Timing is trustworthy by construction:
the runtime's ``_fetch_send`` materializes every output chunk host-side
(np.asarray), so the measured wall time covers real, finished compute
(finiteness of the collected audio is asserted).  Refuses to run on
anything but a GPU.
"""

from __future__ import annotations

import asyncio
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np

from radiorust_tpu import backend
from radiorust_tpu.models.wfm import WFM_INPUT_RATE, wfm_receiver
from radiorust_tpu.runtime import ArraySink, RuntimeBlock
from radiorust_tpu.runtime.flow import new_sender
from radiorust_tpu.signal import Samples
from radiorust_tpu.utils.compile_cache import enable_compile_cache


async def _until(cond, timeout=900.0, interval=0.002):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError("pipeline did not drain")
        await asyncio.sleep(interval)


async def _run_variant(chunk_len: int, depth: int, n_chunks: int,
                       warm: int = 3, streams: int = 1) -> float:
    rng = np.random.default_rng(0)
    shape = (streams, chunk_len) if streams > 1 else (chunk_len,)
    data = (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sender, connector = new_sender()
    blk = RuntimeBlock(wfm_receiver(), pipeline_depth=depth)
    sink = ArraySink()
    blk.feed_from(type("P", (), {"sender_connector": connector})())
    sink.feed_from(blk)
    # Warm chunks compile the binding (persistent cache makes re-runs
    # cheap).
    for _ in range(warm):
        await sender.send(Samples(WFM_INPUT_RATE, data))
    await _until(lambda: len(sink.chunks) >= warm)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        await sender.send(Samples(WFM_INPUT_RATE, data))
    await _until(lambda: len(sink.chunks) >= warm + n_chunks)
    dt = time.perf_counter() - t0
    audio = np.concatenate(sink.chunks[warm:])
    assert audio.size and np.all(np.isfinite(audio)), "bad serving output"
    sender.close()
    await asyncio.sleep(0)  # let teardown cascade
    return dt


def main():
    n_chunks = int(os.environ.get("SERVE_CHUNKS", "64"))
    devs = backend.require_gpu("bench_serving")
    card = backend.card()
    enable_compile_cache()
    # (chunk_len, pipeline_depth, streams): 1-stream variants measure the
    # reference-shaped serving path; the batched variants serve many
    # streams per dispatch, amortizing the per-round-trip cost.
    variants = [(16384, 0, 1), (16384, 8, 1), (65536, 0, 1),
                (16384, 0, 64), (16384, 8, 64)]
    for chunk, depth, streams in variants:
        dt = asyncio.run(_run_variant(chunk, depth, n_chunks,
                                      streams=streams))
        msps = streams * chunk * n_chunks / dt / 1e6
        print(json.dumps({
            "variant": f"chunk{chunk}_depth{depth}_x{streams}",
            "msps_aggregate": round(msps, 2),
            "ms_per_chunk": round(dt / n_chunks * 1e3, 3),
            "chunks": n_chunks,
            "device_kind": devs[0].device_kind,
            "card": card,
        }), flush=True)


if __name__ == "__main__":
    main()
