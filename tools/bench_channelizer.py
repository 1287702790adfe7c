#!/usr/bin/env python
"""Benchmark the 64-channel channelized receiver (BASELINE.json config 5).

One wideband stream -> 64-channel polyphase FFT filterbank -> per-channel
FM demod, all in one compiled program.  Prints a JSON line with the input
throughput; same measurement discipline as bench.py (on-device input,
scalar-fetch sync).  Refuses to run on anything but a GPU.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

BASELINE_FILE = REPO / "CHANNELIZER_BASELINE.json"


def get_cpu_baseline():
    """Reference-style CPU rate: 64 per-sample mixer+decimator+demod chains
    in lock-step broadcast (native/baseline/channelizer_baseline.cpp)."""
    if BASELINE_FILE.exists():
        try:
            return json.loads(BASELINE_FILE.read_text())
        except json.JSONDecodeError:
            pass
    src = REPO / "native" / "baseline" / "channelizer_baseline.cpp"
    exe = REPO / "native" / "baseline" / "channelizer_baseline"
    if not exe.exists() or exe.stat().st_mtime < src.stat().st_mtime:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-o", str(exe),
             str(src), "-lm"], check=True)
    out = subprocess.run([str(exe), "16"], check=True, capture_output=True,
                         text=True).stdout
    data = json.loads(out.strip().splitlines()[-1])
    BASELINE_FILE.write_text(json.dumps(data, indent=1))
    return data


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from radiorust_tpu import backend
    from radiorust_tpu.blocks.base import StreamSig, pack_wire, unpack_wire
    from radiorust_tpu.models.channelizer import channelized_receiver
    from radiorust_tpu.utils.compile_cache import enable_compile_cache

    devs = backend.require_gpu("bench_channelizer")
    baseline = get_cpu_baseline()
    baseline_msps = float(baseline["channelizer_pipelined_msps"])
    enable_compile_cache()

    batch = int(os.environ.get("BENCH_BATCH", "4"))
    n = int(os.environ.get("BENCH_CHUNK", "65536"))
    T = int(os.environ.get("BENCH_T", "8"))
    reps = int(os.environ.get("BENCH_REPS", "256"))
    rate = 16384000.0
    chain = channelized_receiver(num_channels=64, input_rate=rate)
    bound = chain.bind(StreamSig(batch, n, rate))

    @jax.jit
    def bench(pp, ps, seed, reps):
        params = unpack_wire(pp)
        state = unpack_wire(ps)
        key = jax.random.key(seed)
        a = jax.random.normal(key, (T, batch, n), jnp.float32)
        b = jax.random.normal(jax.random.fold_in(key, 1), (T, batch, n),
                              jnp.float32)
        xs = jax.lax.complex(a, b)
        reset = jnp.zeros((batch,), bool)

        def sb(st, x):
            st, y = bound.process(params, st, x, reset)
            return st, jnp.sum(jnp.abs(y) ** 2)

        def rb(i, carry):
            st, acc = carry
            st, sums = jax.lax.scan(sb, st, xs)
            return st, acc + jnp.sum(sums)

        _, acc = jax.lax.fori_loop(0, reps, rb, (state, jnp.float32(0.0)))
        return acc

    pp = pack_wire(bound.params)
    ps = pack_wire(bound.init_state())
    warm = float(bench(pp, ps, 0, 1))
    assert np.isfinite(warm) and warm > 0.0, f"bad checksum {warm}"
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        v = float(bench(pp, ps, 0, reps))
        best = min(best, time.perf_counter() - t0)
        assert np.isfinite(v) and v > 0.0
    samples = batch * n * T * reps
    msps = samples / best / 1e6
    print(json.dumps({
        "metric": "channelizer64_input_throughput",
        "value": round(msps, 2),
        "unit": "Msamples/s/device",
        "device_kind": devs[0].device_kind,
        "card": backend.card(),
        "channels": 64,
        "vs_baseline": round(msps / baseline_msps, 2),
    }))


if __name__ == "__main__":
    main()
