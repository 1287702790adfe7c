#!/usr/bin/env python
"""A/B of the slew-rate limiter's two formulations on the GPU.

``SlewRateLimiter`` runs its per-sample recurrence either in the Pallas
kernel (``ops/pallas_scan.py``, what the backend policy picks on the
GPU) or as ``lax.scan`` (the plain formulation).  This tool times both,
in one process on one card, on the block alone and on the two chains
that carry it (morse, morse_rf), at batch 64 x 4096-sample chunks, and
checks that both give the same samples.

    python tools/exp_scan.py          # on a machine with a GPU

Prints one JSON line per case, and refuses to run without a GPU.
"""

import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax
import jax.numpy as jnp
import numpy as np

from radiorust_tpu import backend
from radiorust_tpu.blocks.base import Chain, StreamSig, scan
from radiorust_tpu.blocks.filters import SlewRateLimiter
from radiorust_tpu.models.morse_tx import morse_audio_chain, morse_rf_chain
from radiorust_tpu.utils.compile_cache import enable_compile_cache

BATCH, CHUNK, T, REPS = 64, 4096, 8, 10


def keyed(batch, n, t, period=1536):
    s = np.arange(t * n)
    env = ((s // period) % 2).astype(np.float32)
    amp = np.linspace(0.6, 1.0, batch).astype(np.float32)
    x = (amp[:, None] * env[None, :]).astype(np.complex64)
    return np.moveaxis(x.reshape(batch, t, n), 1, 0)


def timed(bound, xs, kernels: bool):
    orig = backend.use_kernels
    backend.use_kernels = lambda on=None: kernels
    try:
        run = jax.jit(lambda p, s, x: scan(bound, p, s, x)[1])
        p, s = jax.device_put(bound.params), jax.device_put(bound.init_state())
        t0 = time.perf_counter()
        ys = jax.block_until_ready(run(p, s, xs))
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(run(p, s, xs))
            best = min(best, time.perf_counter() - t0)
    finally:
        backend.use_kernels = orig
    return best / xs.shape[0], compile_s, np.asarray(ys)


def main():
    dev = backend.require_gpu("exp_scan")[0]
    card = backend.card()
    enable_compile_cache()
    cases = {
        "slew": (Chain(SlewRateLimiter(100.0)), 48000.0),
        "morse": (morse_audio_chain(), 48000.0),
        "morse_rf": (morse_rf_chain(), 128000.0),
    }
    xs = jax.device_put(jnp.asarray(keyed(BATCH, CHUNK, T)))
    for name, (chain, rate) in cases.items():
        bound = chain.bind(StreamSig(BATCH, CHUNK, rate))
        k_s, k_c, yk = timed(bound, xs, True)
        s_s, s_c, ys = timed(bound, xs, False)
        scale = max(float(np.abs(ys).max()), 1e-30)
        print(json.dumps({
            "case": name, "batch": BATCH, "chunk": CHUNK,
            "kernel_us_per_chunk": k_s * 1e6,
            "scan_us_per_chunk": s_s * 1e6,
            "kernel_msps": BATCH * CHUNK / k_s / 1e6,
            "scan_msps": BATCH * CHUNK / s_s / 1e6,
            "kernel_compile_s": k_c, "scan_compile_s": s_c,
            "max_rel_diff": float(np.abs(yk - ys).max()) / scale,
            "device_kind": dev.device_kind, "card": card}), flush=True)


if __name__ == "__main__":
    main()
