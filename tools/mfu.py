#!/usr/bin/env python
"""Modeled FLOP / memory-byte accounting per chain, and the published
device peaks (:func:`peaks`, keyed by ``device_kind``).

A model, not a device measurement.  FLOPs are XLA's cost analysis of the
program compiled for the *CPU*; the GPU program is a different compile
(cuFFT and cuDNN custom calls the CPU cost model does not describe), so
the counts are not the card's.  Bytes per step use the kernel-boundary
model: each stage reads its input chunk + carried state + params and
writes its output + new state, a lower bound wherever XLA splits a stage
into several kernels.  Shares of a device's peak need FLOPs and bytes
taken from a trace of the GPU program instead.

    python tools/mfu.py                 # all configs, markdown tables
    python tools/mfu.py --json-only wfm # one config, one JSON line
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

# Published dense peaks, keyed by jax's ``device_kind``.  Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM5 part (rates at the 700 W power
# limit, without sparsity).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "f32_tflops": 67.0,
        "hbm_gbps": 3350.0,
    },
}


def peaks(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def _configs():
    import numpy as np

    from radiorust_tpu.blocks.base import Chain
    from radiorust_tpu.blocks.filters import Filter
    from radiorust_tpu.blocks.resampling import Downsampler
    from radiorust_tpu.blocks.transform import FreqShifter
    from radiorust_tpu.models.bandwidth_meter import bandwidth_meter_chain
    from radiorust_tpu.models.channelizer import channelized_receiver
    from radiorust_tpu.models.morse_tx import (morse_audio_chain,
                                               morse_rf_chain)
    from radiorust_tpu.models.stereo import wfm_stereo_receiver
    from radiorust_tpu.models.wfm import (WFM_INPUT_CHUNK, WFM_INPUT_RATE,
                                          wfm_receiver)

    def lp(bins, freqs):
        return np.where(np.abs(freqs) <= 500000.0, 1.0 + 0.0j, 0.0j)

    # "wfm" follows bench.py's geometry knobs, so it models the chain
    # bench.py times.
    wfm_chunk = int(os.environ.get("BENCH_CHUNK", "24576"))
    wfm_ir = int(os.environ.get("BENCH_IR", "6144"))
    return {
        "wfm": (wfm_receiver(filter_ir_len=wfm_ir), wfm_chunk,
                WFM_INPUT_RATE),
        "stereo": (wfm_stereo_receiver(), WFM_INPUT_CHUNK,
                   WFM_INPUT_RATE),
        "wfm_coupled": (wfm_receiver(), WFM_INPUT_CHUNK, WFM_INPUT_RATE),
        "morse": (morse_audio_chain(), 4096, 48000.0),
        "morse_rf": (morse_rf_chain(), 4096, 128000.0),
        "audiopipe": (Chain(FreqShifter.with_shift(-100000.0),
                            Filter.new(lp),
                            Downsampler(1200000.0, 1000000.0)),
                      16384, 2400000.0),
        "bw_meter": (bandwidth_meter_chain(), 10240, 1024000.0),
        "channelizer": (channelized_receiver(), 65536, 8192000.0),
    }


def _nbytes(tree) -> int:
    import jax
    import numpy as np
    return int(sum(np.asarray(leaf).nbytes
                   for leaf in jax.tree.leaves(tree)))


def _flops(fn, *args) -> float:
    import jax
    c = jax.jit(fn).lower(*args).compile()
    ca = c.cost_analysis()
    if isinstance(ca, list):  # older jax returns one dict per device
        ca = ca[0]
    return float(ca.get("flops", 0.0))


def analyze(name, chain, n, rate, batch):
    import jax
    import numpy as np

    from radiorust_tpu import config
    from radiorust_tpu.blocks.base import StreamSig
    from radiorust_tpu.blocks.graph import Graph
    is_graph = isinstance(chain, Graph)
    sig = StreamSig(batch, n, rate)
    bound = chain.bind({"iq": sig} if is_graph else sig)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((batch, n))
         + 1j * rng.standard_normal((batch, n))).astype(np.complex64)
    in_samples = batch * n
    head = {"config": name, "batch": batch, "chunk": n,
            "matmul_precision": config.matmul_precision_name()}

    if is_graph:
        # DAG models (stereo): whole-graph totals only (fan-out reuse
        # makes per-node IO accounting double-count shared values).
        total_flops = _flops(lambda p, st, xs: bound.process(p, st, xs),
                             bound.params, bound.init_state(), {"iq": x})
        st = bound.init_state()
        _, y = jax.jit(bound.process)(bound.params, st, {"iq": x})
        total_bytes = (_nbytes(x) + _nbytes(st) * 2
                       + _nbytes(bound.params) + _nbytes(y))
        stages = []
    else:
        stages = []
        blocks = getattr(bound, "blocks", None)
        if blocks is None:
            blocks, params = (bound,), (bound.params,)
        else:
            params = bound.params
        xcur = x
        for blk, p in zip(blocks, params):
            st = blk.init_state()
            # Blocks that fold channels into the batch axis (Channelizer)
            # change the stream count mid-chain — reset tracks it.
            reset = np.zeros((xcur.shape[0],), bool)
            fl = _flops(blk.process, p, st, xcur, reset)
            io = (_nbytes(xcur) + _nbytes(st) * 2 + _nbytes(p))
            new_st, y = jax.jit(blk.process)(p, st, xcur, reset)
            io += _nbytes(y)
            stages.append({"stage": type(blk).__name__.lstrip("_"),
                           "flops": fl, "hbm_bytes": io})
            xcur = np.asarray(y)
        total_flops = _flops(bound.process, bound.params,
                             bound.init_state(), x,
                             np.zeros((batch,), bool))
        total_bytes = sum(s["hbm_bytes"] for s in stages)
    return {**head,
            "flops_per_step": total_flops,
            "flops_per_input_sample": total_flops / in_samples,
            "hbm_bytes_per_step": total_bytes,
            "hbm_bytes_per_input_sample": total_bytes / in_samples,
            "arithmetic_intensity": total_flops / max(total_bytes, 1),
            "stages": stages}


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update("jax_platforms", "cpu")

    batch = int(os.environ.get("BENCH_BATCH", "64"))
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    json_only = "--json-only" in sys.argv
    cfgs = _configs()
    for name in args or list(cfgs):
        chain, n, rate = cfgs[name]
        r = analyze(name, chain, n, rate, batch)
        if json_only:
            print(json.dumps(r))
            continue
        print(f"\n## {name}  (batch {r['batch']}, chunk {r['chunk']}, "
              f"{r['matmul_precision']} matmuls)")
        print(f"total: {r['flops_per_input_sample']:.1f} FLOP/sample, "
              f"{r['hbm_bytes_per_input_sample']:.1f} B/sample, "
              f"intensity {r['arithmetic_intensity']:.1f} FLOP/B")
        print("| stage | MFLOP/step | FLOP/sample | kB/step |")
        print("|---|---|---|---|")
        for s in r["stages"]:
            print(f"| {s['stage']} | {s['flops'] / 1e6:.2f} | "
                  f"{s['flops'] / (r['batch'] * r['chunk']):.1f} | "
                  f"{s['hbm_bytes'] / 1e3:.1f} |")


if __name__ == "__main__":
    main()
