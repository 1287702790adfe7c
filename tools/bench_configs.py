#!/usr/bin/env python
"""Single-device throughput for every BASELINE.json config.

bench.py covers config 4 (WFM receive chain) and bench_channelizer.py
covers config 5 (64-channel PFB); this tool measures the remaining three:

1. morse:      SlewRateLimiter -> Filter LPF 100 Hz -> Gain -> FreqShifter
               (examples/morse/main.rs chain; keying envelope as input)
2. audiopipe:  freq_shift -> lowpass Filter -> downsample 2x at 2.4 Msps
3. bw_meter:   shift -> decimate to 102.4 k -> LPF -> Overlapper(4) ->
               Fourier -> occupied-bandwidth metering
               (examples/bandwidth_meter/main.rs)

Same measurement discipline as bench.py: on-device input, the full
T x reps workload inside one jit program, f32-scalar fetch as the sync
point.  Prints one JSON line per config, naming the card.  Refuses to
run on anything but a GPU.
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

BATCH = int(os.environ.get("BENCH_BATCH", "64"))
T = int(os.environ.get("BENCH_T", "16"))
REPS = int(os.environ.get("BENCH_REPS", "256"))


def build(name):
    if name == "morse":
        from radiorust_tpu.models.morse_tx import morse_audio_chain
        chain, n, rate = morse_audio_chain(), 4096, 48000.0
        post = None
    elif name == "morse_rf":
        from radiorust_tpu.models.morse_tx import morse_rf_chain
        chain, n, rate = morse_rf_chain(), 4096, 128000.0
        post = None
    elif name == "audiopipe":
        from radiorust_tpu.blocks.base import Chain
        from radiorust_tpu.blocks.filters import Filter
        from radiorust_tpu.blocks.resampling import Downsampler
        from radiorust_tpu.blocks.transform import FreqShifter

        def lp(bins, freqs):
            return np.where(np.abs(freqs) <= 500000.0, 1.0 + 0.0j, 0.0j)

        chain = Chain(FreqShifter.with_shift(-100000.0), Filter.new(lp),
                      Downsampler(1200000.0, 1000000.0))
        n, rate, post = 16384, 2400000.0, None
    elif name == "bw_meter":
        from radiorust_tpu.models.bandwidth_meter import (
            bandwidth_meter_chain, measure_bandwidth)
        chain = bandwidth_meter_chain()
        n, rate = 10240, 1024000.0
        post = lambda y, out_rate: jnp.sum(  # noqa: E731
            measure_bandwidth(y, out_rate))
    elif name in ("stereo", "stereo_wide"):
        # Full stereo WFM receiver (graph: bank decode + fan-in) — _wide
        # runs the decoupled overlap-save geometry (input chunk 24576,
        # filter IRs at the reference 6144-tap design).
        from radiorust_tpu.models.stereo import wfm_stereo_receiver
        wide = name.endswith("wide")
        n, rate = (24576 if wide else 16384), 1024000.0
        chain = wfm_stereo_receiver(filter_ir_len=6144 if wide else None)
        post = None
    else:
        raise SystemExit(f"unknown config {name}")

    is_graph = hasattr(chain, "input")  # Graph spec, not Chain
    if is_graph:
        bound = chain.bind({"iq": StreamSig(BATCH, n, rate)})
    else:
        bound = chain.bind(StreamSig(BATCH, n, rate))

    @jax.jit
    def bench(pp, ps, seed, reps):
        params = unpack_wire(pp)
        state = unpack_wire(ps)
        key = jax.random.key(seed)
        a = jax.random.normal(key, (T, BATCH, n), jnp.float32)
        b = jax.random.normal(jax.random.fold_in(key, 1), (T, BATCH, n),
                              jnp.float32)
        xs = jax.lax.complex(a, b)
        reset = jnp.zeros((BATCH,), bool)

        def sb(st, x):
            if is_graph:
                st, ys = bound.process(params, st, {"iq": x})
                acc = sum(jnp.sum(jnp.abs(l) ** 2)
                          for l in jax.tree.leaves(ys))
                return st, acc
            st, y = bound.process(params, st, x, reset)
            acc = jnp.sum(jnp.abs(y) ** 2)
            if post is not None:
                acc = acc + post(y, bound.out_sig.sample_rate)
            return st, acc

        def rb(i, carry):
            st, acc = carry
            st, sums = jax.lax.scan(sb, st, xs)
            return st, acc + jnp.sum(sums)

        _, acc = jax.lax.fori_loop(0, reps, rb, (state, jnp.float32(0.0)))
        return acc

    return bench, pack_wire(bound.params), pack_wire(bound.init_state()), n


def main():
    names = sys.argv[1:] or ["morse", "audiopipe", "bw_meter"]
    devs = backend.require_gpu("bench_configs")
    card = backend.card()
    enable_compile_cache()
    built = []
    for name in names:
        bench, pp, ps, n = build(name)
        t0 = time.perf_counter()
        warm = float(bench(pp, ps, 0, 1))
        assert np.isfinite(warm) and warm > 0.0, f"{name}: bad warmup {warm}"
        print(f"# warm {name}: {time.perf_counter() - t0:.1f}s", flush=True)
        built.append((name, bench, pp, ps, n))

    for name, bench, pp, ps, n in built:
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            v = float(bench(pp, ps, 0, REPS))
            best = min(best, time.perf_counter() - t0)
            assert np.isfinite(v) and v > 0.0, f"{name}: bad checksum {v}"
        msps = BATCH * n * T * REPS / best / 1e6
        rec = {
            "metric": f"{name}_input_throughput",
            "value": round(msps, 2),
            "unit": "Msamples/s/device",
            "device_kind": devs[0].device_kind,
            "card": card,
            "us_per_step": round(best / (T * REPS) * 1e6, 1),
        }
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
