#!/usr/bin/env python
"""Batch-1 device-compute latency per real-time chunk.

The reference's operating point is one receiver consuming 16384-sample
chunks at 1.024 Msps — a chunk every 16 ms
(``examples/relm_app/simple_receiver.rs:15-62``).  This bench records the
*device compute* latency per chunk at batch 1: chunks are serially
dependent through the carried state, so a scan of N chunks inside one jit
program costs N x (per-chunk compute latency), and dividing amortizes the
per-call dispatch.  The f32 scalar fetch is the sync point.

Prints one JSON line per config with ``us_per_chunk`` and
``realtime_headroom`` (chunk budget / compute latency).  Refuses to run
on anything but a GPU.
"""

import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax
import jax.numpy as jnp
import numpy as np

from radiorust_tpu import backend
from radiorust_tpu.blocks.base import StreamSig, pack_wire, unpack_wire
from radiorust_tpu.utils.compile_cache import enable_compile_cache

T =int(os.environ.get("BENCH_T", "16"))
REPS = int(os.environ.get("BENCH_REPS", "256"))
BATCH = int(os.environ.get("BENCH_BATCH", "1"))


def build(name):
    from radiorust_tpu.models.wfm import (WFM_INPUT_CHUNK, WFM_INPUT_RATE,
                                          wfm_receiver)
    n, rate = WFM_INPUT_CHUNK, WFM_INPUT_RATE
    if name == "wfm":
        bound = wfm_receiver().bind(StreamSig(BATCH, n, rate))
        is_graph = False
    elif name == "wfm_wide":
        # The decoupled geometry: the chunk budget grows to 24 ms
        # (24576 samples @ 1.024 Msps) while the filters keep the
        # reference's 6144-tap responses.
        n = 24576
        bound = wfm_receiver(filter_ir_len=6144).bind(
            StreamSig(BATCH, n, rate))
        is_graph = False
    elif name == "stereo":
        from radiorust_tpu.models.stereo import wfm_stereo_receiver
        bound = wfm_stereo_receiver().bind(
            {"iq": StreamSig(BATCH, n, rate)})
        is_graph = True
    else:
        raise SystemExit(name)

    @jax.jit
    def bench(pp, ps, seed, reps):
        params = unpack_wire(pp)
        state = unpack_wire(ps)
        key = jax.random.key(seed)
        a = jax.random.normal(key, (T, BATCH, n), jnp.float32)
        b = jax.random.normal(jax.random.fold_in(key, 1), (T, BATCH, n),
                              jnp.float32)
        xs = jax.lax.complex(a, b)

        def sb(st, x):
            if is_graph:
                st, y = bound.process(params, st, {"iq": x})
                acc = sum(jnp.sum(jnp.abs(l) ** 2)
                          for l in jax.tree.leaves(y))
            else:
                st, y = bound.process(params, st, x,
                                      jnp.zeros((BATCH,), bool))
                acc = jnp.sum(jnp.abs(y) ** 2)
            return st, acc

        def rb(i, carry):
            st, acc = carry
            st, sums = jax.lax.scan(sb, st, xs)
            return st, acc + jnp.sum(sums)

        _, acc = jax.lax.fori_loop(0, reps, rb,
                                   (state, jnp.float32(0.0)))
        return acc

    return (bench, pack_wire(bound.params), pack_wire(bound.init_state()),
            n, rate)


def main():
    names = sys.argv[1:] or ["wfm", "wfm_wide", "stereo"]
    devs = backend.require_gpu("bench_latency")
    card = backend.card()
    enable_compile_cache()
    built = []
    for name in names:
        bench, pp, ps, n, rate = build(name)
        t0 = time.perf_counter()
        warm = float(bench(pp, ps, 0, 1))
        assert np.isfinite(warm) and warm > 0.0, (name, warm)
        print(f"# warm {name}: {time.perf_counter() - t0:.1f}s",
              flush=True)
        built.append((name, bench, pp, ps, n, rate))

    for name, bench, pp, ps, n, rate in built:
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            v = float(bench(pp, ps, 0, REPS))
            dt = time.perf_counter() - t0
            assert np.isfinite(v) and v > 0.0
            best = min(best, dt)
        us = best / (T * REPS) * 1e6
        budget_us = n / rate * 1e6
        print(json.dumps({
            "metric": f"{name}_batch{BATCH}_compute_latency",
            "device_kind": devs[0].device_kind,
            "card": card,
            "us_per_chunk": round(us, 1),
            "chunk_budget_us": round(budget_us, 1),
            "realtime_headroom": round(budget_us / us, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
