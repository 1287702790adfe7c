#!/usr/bin/env python
"""Serving-runtime soak: the actor stack under sustained load.

Drives  SdrRx(SyntheticSdrDriver) -> Rechunker -> RuntimeBlock(WFM) ->
Buffer -> Blackhole  for >= SOAK_SECONDS wall-clock (default 330 s),
sampling every 5 s:

- cumulative audio samples delivered to the sink (throughput),
- host RSS (``/proc/self/statm``),
- the Buffer's queued duration and entry count,
- the actor's processed-chunk counter.

Failure criteria:

- THROUGHPUT DECAY: any post-warmup minute's sink throughput below
  ``DECAY_FRAC`` (default 0.7) of the best post-warmup minute;
- HOST-MEMORY CREEP: RSS growth from the end of the warmup to the end
  of the run above ``RSS_BUDGET_MB`` (default 300);
- QUEUE GROWTH: the Buffer's queued duration exceeding its configured
  ``max_capacity`` (the actor stack must hold the backpressure
  contract, not accumulate).

Prints the record (and writes it to ``SOAK_OUT`` when set); exits
nonzero on failure.  The reference's whole value is *continuous*
streaming (``src/blocks/mod.rs:27-34``) — this is the check that the
serving path is more than a bench loop.

CPU regression: ``JAX_PLATFORMS=cpu SOAK_SECONDS=8 python tools/soak.py``
exercises the same harness end-to-end (tests/test_soak.py).  It runs on
whatever platform JAX finds and names it in the record; its throughput
is a device figure only when that platform is ``gpu``.
"""

import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def rss_mb() -> float:
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e6


def main():
    duration = float(os.environ.get("SOAK_SECONDS", "330"))
    sample_every = min(5.0, max(1.0, duration / 8))
    import jax

    from radiorust_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    import asyncio

    import numpy as np

    from radiorust_tpu.models.wfm import WFM_INPUT_RATE, wfm_receiver
    from radiorust_tpu.runtime import (Blackhole, Buffer, Rechunker,
                                       RuntimeBlock)
    from radiorust_tpu.runtime.io import SdrRx, SyntheticSdrDriver

    chunk = int(os.environ.get("SOAK_CHUNK", "24576"))
    ir_len = int(os.environ.get("SOAK_IR", "6144"))
    depth = int(os.environ.get("SOAK_PIPELINE_DEPTH", "2"))
    max_cap = 2.0

    async def soak():
        # FM-modulated tone carrier inside the passband + light noise:
        # representative load, unthrottled (the source always outruns the
        # device block, so the measured rate is the serving path's own).
        driver = SyntheticSdrDriver(WFM_INPUT_RATE,
                                    tones=((57000.0, 0.7),), noise=0.05)
        src = SdrRx(driver)
        rechunk = Rechunker(chunk)
        # SdrRx serves ONE stream (1-D chunks -> the actor binds batch
        # 1).
        wfm = RuntimeBlock(wfm_receiver(filter_ir_len=ir_len),
                           name="soak_wfm", pipeline_depth=depth)
        buf = Buffer(initial_capacity=0.1, min_capacity=0.05,
                     max_capacity=max_cap, max_age=4.0)
        sink = Blackhole()
        rechunk.feed_from(src)
        wfm.feed_from(rechunk)
        buf.feed_from(wfm)
        sink.feed_from(buf)
        await src.activate()

        t0 = time.monotonic()
        samples = []
        while True:
            await asyncio.sleep(sample_every)
            now = time.monotonic() - t0
            samples.append({
                "t_s": round(now, 1),
                "sink_samples": int(sink.samples_seen),
                "chunks_processed": int(wfm.chunks_processed),
                "rss_mb": round(rss_mb(), 1),
                "queue_s": round(buf._queue.duration, 3),
                "queue_entries": len(buf._queue),
            })
            if wfm.failure is not None:
                raise wfm.failure
            if now >= duration:
                break
        await src.deactivate()
        await src.close()
        return samples

    t_start = time.monotonic()
    samples = asyncio.run(soak())
    wall = time.monotonic() - t_start

    # Per-minute throughput buckets (bucket = 60 s, or duration/4 for
    # short CPU regression runs so the decay check still has >= 3
    # buckets).
    bucket_s = 60.0 if duration >= 240 else max(duration / 4, 2.0)
    # Rate between consecutive probe points, grouped by bucket.
    rates = {}
    for a, b in zip(samples, samples[1:]):
        bk = int(b["t_s"] // bucket_s)
        d_samp = b["sink_samples"] - a["sink_samples"]
        d_t = b["t_s"] - a["t_s"]
        if d_t > 0:
            rates.setdefault(bk, []).append(d_samp / d_t)
    minute_msps = {str(k): round(sum(v) / len(v) / 1e6, 3)
                   for k, v in sorted(rates.items())}
    # Warmup exclusion: compile + initial Buffer fill ride the first
    # bucket(s) — 60 s on a full run, the first third of a short CPU
    # regression run.
    warmup_s = 60.0 if duration >= 240 else duration / 3
    k_min = int(np.ceil(warmup_s / bucket_s))
    post_warmup = [sum(v) / len(v) for k, v in sorted(rates.items())
                   if k >= k_min] or [sum(v) / len(v)
                                      for _, v in sorted(rates.items())]
    best = max(post_warmup)
    worst = min(post_warmup)
    decay_frac = float(os.environ.get("DECAY_FRAC", "0.7"))
    rss_budget = float(os.environ.get("RSS_BUDGET_MB", "300"))
    # Same warmup boundary as the throughput check — a hardcoded 60 s
    # index would clamp to the last sample on short (CPU regression)
    # runs and make the creep check vacuous.
    warm_idx = next((i for i, s in enumerate(samples)
                     if s["t_s"] >= warmup_s), len(samples) - 1)
    rss_after_warmup = samples[warm_idx]["rss_mb"]
    rss_growth = samples[-1]["rss_mb"] - rss_after_warmup
    window_chunks = (samples[-1]["chunks_processed"]
                     - samples[warm_idx]["chunks_processed"])
    max_queue = max(s["queue_s"] for s in samples)

    throughput_ok = best > 0 and worst >= decay_frac * best
    rss_ok = rss_growth <= rss_budget
    queue_ok = max_queue <= max_cap + 0.5
    chunks = samples[-1]["chunks_processed"]
    ok = bool(throughput_ok and rss_ok and queue_ok and chunks > 0)

    record = {
        "ok": ok,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "duration_s": round(wall, 1),
        "chunks_processed": chunks,
        "input_msamples": round(chunks * chunk / 1e6, 1),
        "sink_samples": samples[-1]["sink_samples"],
        "bucket_s": bucket_s,
        "bucket_sink_msps": minute_msps,
        "throughput_ok": bool(throughput_ok),
        "worst_over_best": round(worst / best, 3) if best else None,
        "rss_start_mb": samples[0]["rss_mb"],
        "rss_end_mb": samples[-1]["rss_mb"],
        "rss_growth_after_warmup_mb": round(rss_growth, 1),
        "rss_growth_per_chunk_kb": round(
            rss_growth * 1e3 / max(window_chunks, 1), 1),
        "rss_ok": bool(rss_ok),
        "max_queue_s": round(max_queue, 3),
        "queue_ok": bool(queue_ok),
        "pipeline_depth": depth,
        "chunk": chunk,
        "probes": samples if duration < 240 else samples[::3],
    }
    out = json.dumps(record, indent=1)
    if os.environ.get("SOAK_OUT"):
        pathlib.Path(os.environ["SOAK_OUT"]).write_text(out)
    print(out)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
