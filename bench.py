#!/usr/bin/env python
"""Benchmark: WFM receive chain throughput on one GPU.

Metric: complex IQ input Msamples/s through the full
shift -> decimate -> filter -> FM demod -> deemphasis -> decimate -> gain
chain (BASELINE.md), 64 streams x 24576-sample chunks with the filters at
the reference's 6144-tap design.  ``vs_baseline`` compares against the
*pipelined* CPU reference rate (one core per block, bounded by the
slowest stage — the most favorable reading of the reference's Tokio
task-per-block runtime), measured by the native C++ per-sample
implementation in ``native/baseline/wfm_baseline.cpp`` and cached in
BASELINE_MEASURED.json.

Measurement:
- input data is generated on the device inside the jitted program,
- the timed region runs T chunks x reps inside one jitted program,
- timing is closed by fetching an f32 scalar reduced over every output
  sample, so the measured time covers the whole computation.

Refuses to run on anything but a GPU.  Prints the card on stderr and
exactly one JSON line on stdout.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
BASELINE_FILE = REPO / "BASELINE_MEASURED.json"
sys.path.insert(0, str(REPO))


def measure_cpu_baseline():
    src = REPO / "native" / "baseline" / "wfm_baseline.cpp"
    exe = REPO / "native" / "baseline" / "wfm_baseline"
    if not exe.exists() or exe.stat().st_mtime < src.stat().st_mtime:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-o", str(exe),
             str(src), "-lm"], check=True)
    out = subprocess.run([str(exe), "192"], check=True,
                         capture_output=True, text=True).stdout
    data = json.loads(out.strip().splitlines()[-1])
    BASELINE_FILE.write_text(json.dumps(data, indent=1))
    return data


def get_cpu_baseline():
    if BASELINE_FILE.exists():
        try:
            return json.loads(BASELINE_FILE.read_text())
        except json.JSONDecodeError:
            pass
    return measure_cpu_baseline()


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from radiorust_tpu import backend, config
    from radiorust_tpu.blocks.base import StreamSig
    from radiorust_tpu.models.wfm import WFM_INPUT_RATE, wfm_receiver
    from radiorust_tpu.utils.compile_cache import enable_compile_cache

    devs = backend.require_gpu("bench.py")
    card = backend.card()
    sys.stderr.write(f"platform={devs[0].platform} kind={devs[0].device_kind}"
                     f" count={len(devs)} card={card}\n")

    enable_compile_cache()
    baseline_msps = float(get_cpu_baseline()["pipelined_msps"])

    batch = int(os.environ.get("BENCH_BATCH", "64"))
    T = int(os.environ.get("BENCH_T", "16"))
    # Input chunk 24576 with the filters' impulse responses held at the
    # reference's 6144-tap design (decoupled overlap-save geometry: mid
    # chunk 9216 over 15360-point transforms).  BENCH_CHUNK=16384
    # reproduces the reference-coupled layout bit for bit.
    chunk = int(os.environ.get("BENCH_CHUNK", "24576"))
    ir_len = int(os.environ.get("BENCH_IR", "6144"))
    sig = StreamSig(batch, chunk, WFM_INPUT_RATE)
    bound = wfm_receiver(filter_ir_len=ir_len).bind(sig)

    @jax.jit
    def bench(params, state, seed, reps):
        key = jax.random.key(seed)
        a = jax.random.normal(key, (T, batch, chunk), jnp.float32)
        b = jax.random.normal(jax.random.fold_in(key, 1),
                              (T, batch, chunk), jnp.float32)
        xs = jax.lax.complex(a, b)
        reset = jnp.zeros((batch,), bool)

        def scan_body(st, x):
            st, y = bound.process(params, st, x, reset)
            return st, jnp.sum(jnp.abs(y) ** 2)

        def rep_body(i, carry):
            st, acc = carry
            st, sums = jax.lax.scan(scan_body, st, xs)
            return st, acc + jnp.sum(sums)

        _, acc = jax.lax.fori_loop(
            0, reps, rep_body, (state, jnp.float32(0.0)))
        return acc

    params = jax.device_put(bound.params)
    state = jax.device_put(bound.init_state())
    warm = float(bench(params, state, 0, 1))
    assert np.isfinite(warm) and warm > 0.0, f"bad warmup checksum {warm}"

    reps = int(os.environ.get("BENCH_REPS", "64"))
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        v = float(bench(params, state, 0, reps))
        best = min(best, time.perf_counter() - t0)
        assert np.isfinite(v) and v > 0.0, f"bad checksum {v}"

    # Optional device trace for a per-stage breakdown.
    trace_dir = os.environ.get("BENCH_TRACE")
    if trace_dir:
        from radiorust_tpu.utils.profiling import device_trace
        with device_trace(trace_dir):
            float(bench(params, state, 0, 1))

    msps = batch * chunk * T * reps / best / 1e6
    record = {
        "metric": "wfm_chain_input_throughput",
        "value": round(msps, 2),
        "unit": "Msamples/s/device",
        "vs_baseline": round(msps / baseline_msps, 2),
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card,
        "matmul_precision": config.matmul_precision_name(),
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
