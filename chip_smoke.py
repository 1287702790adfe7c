#!/usr/bin/env python
"""Smoke test of the receive chains on a GPU, checked against XLA's CPU
backend in the same process.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the multi-device paths only

Phases of the one-GPU run (each prints its comparison, tolerance and
matmul precision; any failure exits non-zero without the result line):

1. device  -- refuse anything but a GPU; print the card (JAX's view and
   ``nvidia-smi``'s name and power limit) and the precision mode.
2. wfm     -- the WFM receive chain (``wfm_receiver(filter_ir_len=6144)``)
   at 64 streams x 24576-sample chunks of 1.024 Msps IQ, scanned on the
   GPU, against the same bound chain on the CPU device.
3. served  -- the same chain as a ``RuntimeBlock`` actor fed by a sender
   and drained to an ``ArraySink``; equal to phase 2's GPU scan.
4. models  -- every other chain (stereo, channelizer, AM/SSB/ISB, morse,
   bandwidth meter, audio pipe, WFM transmitter) at batch 64, GPU vs CPU.
5. kernels -- each hand-written kernel compiled for the card at real
   widths, against the plain formulation on the CPU.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from radiorust_tpu import backend, config  # noqa: E402
from radiorust_tpu.blocks.base import Chain, StreamSig, scan  # noqa: E402
from radiorust_tpu.utils.compile_cache import enable_compile_cache  # noqa


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of one run.  ``full()`` is the deployment shape; the tests
    rehearse the same phases with ``tiny()`` on the CPU."""
    batch: int = 64
    wfm_chunk: int = 24576
    wfm_ir: int = 6144
    wfm_chunks: int = 8          # >= 8: phase 3 serves the same inputs
    model_chunks: int = 4
    scale: int = 1               # divides every model chunk length
    fleet_per_device: int = 64

    @classmethod
    def full(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(batch=2, wfm_chunk=4096, wfm_ir=512, wfm_chunks=4,
                   model_chunks=3, scale=4, fleet_per_device=2)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- comparison ---------------------------------------------------------------

def checksums(leaves, t_axis_len):
    """Per-chunk energy and a +-1 (Rademacher) fingerprint of every output
    leaf ``[T, ...]``: |fingerprint| ~ sqrt(E * N), so a fingerprint error
    is normalized by the signal's own scale (tones cancel in plain sums)."""
    e = np.zeros(t_axis_len)
    fr = np.zeros(t_axis_len)
    fi = np.zeros(t_axis_len)
    cnt = 0
    for i, leaf in enumerate(leaves):
        a = np.asarray(leaf).reshape(t_axis_len, -1).astype(np.complex128)
        w = np.random.default_rng(100 + i).choice([-1.0, 1.0], a.shape[1])
        e += np.sum(np.abs(a) ** 2, axis=1)
        f = a @ w
        fr += f.real
        fi += f.imag
        cnt += a.shape[1]
    return e, fr, fi, cnt


def compare(name, got, want, skip, tol):
    """Steady-chunk relative error of energy and fingerprint (chunks from
    ``skip`` on); raises when it exceeds ``tol``."""
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    t = np.asarray(wl[0]).shape[0]
    e_g, fr_g, fi_g, _ = checksums(gl, t)
    e_w, fr_w, fi_w, n = checksums(wl, t)
    scale = np.sqrt(np.maximum(e_w * n, 1e-30))
    rel = np.stack([np.abs(e_g - e_w) / np.maximum(e_w, 1e-30),
                    np.abs(fr_g - fr_w) / scale,
                    np.abs(fi_g - fi_w) / scale])[:, skip:]
    steady = float(rel.max())
    finite = all(np.isfinite(np.asarray(g)).all() for g in gl)
    peak = max(float(np.abs(np.asarray(w)[skip:]).max()) for w in wl)
    diff = max(float(np.abs(np.asarray(g)[skip:] - np.asarray(w)[skip:])
                     .max()) for g, w in zip(gl, wl))
    ok = finite and steady < tol
    log(f"[{name}] steady chunks {skip}..{t - 1}: energy/fingerprint max "
        f"rel {steady:.3e} (tol {tol:g}), max|diff|/peak "
        f"{diff / max(peak, 1e-30):.3e}, finite={finite}, precision "
        f"{config.matmul_precision_name()} -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: rel {steady:.3e} >= tol {tol:g} "
                             f"or non-finite output")
    return steady


# -- running a bound chain on one device --------------------------------------

def run_scan(bound, xs, device, is_graph=False, post=None):
    """Scan ``bound`` over ``xs [T, batch, n]`` on ``device``; returns the
    outputs (and ``post(ys)`` leaves) as host arrays."""
    def body(params, state, xs):
        if is_graph:
            def step(st, x):
                return bound.process(params, st, {"iq": x})
            _, ys = jax.lax.scan(step, state, xs)
        else:
            _, ys = scan(bound, params, state, xs)
        return ys if post is None else (ys, post(ys))

    with jax.default_device(device):
        args = jax.device_put((bound.params, bound.init_state(),
                               jnp.asarray(xs)), device)
        out = jax.block_until_ready(jax.jit(body)(*args))
    return jax.tree.map(np.asarray, out)


# -- inputs (host numpy, identical for both devices) -------------------------

def fm_tone(t, batch, n, rate, deviation=150000.0, audio=1000.0):
    """FM tone with a closed-form phase (no cumsum: both sides demodulate
    the same samples)."""
    s = np.arange(t * n) / rate
    theta = 0.3 * deviation / audio * (1.0 - np.cos(2 * np.pi * audio * s))
    ph = np.exp(1j * np.linspace(0.0, 1.0, batch))
    x = np.exp(1j * theta)[None, :] * ph[:, None]
    return _chunked(x, t)


def _chunked(x, t):
    b = x.shape[0]
    return np.moveaxis(x.astype(np.complex64).reshape(b, t, -1), 1, 0)


def noise(t, batch, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, batch, n))
            + 1j * rng.standard_normal((t, batch, n))).astype(np.complex64)


def keyed_envelope(t, batch, n, period=1536):
    s = np.arange(t * n)
    env = ((s // period) % 2).astype(np.float64)
    amp = np.linspace(0.6, 1.0, batch)
    return _chunked(amp[:, None] * env[None, :], t)


def stereo_mpx(t, batch, n, rate=1024000.0, dev=150000.0):
    """Stereo MPX (mono + 19 kHz pilot + 38 kHz DSB-SC), FM-modulated with
    a closed-form phase."""
    s = np.arange(t * n) / rate
    theta = np.zeros_like(s)
    for amp, f in ((0.45, 1000.0), (0.1, 19000.0), (0.225, 39200.0),
                   (-0.225, 36800.0)):
        theta += amp * dev / f * (1.0 - np.cos(2 * np.pi * f * s))
    ph = np.exp(1j * np.linspace(0.0, 1.0, batch))
    return _chunked(np.exp(1j * theta)[None, :] * ph[:, None], t)


def carriers(t, batch, n, rate, tones, k_div, dev):
    """FM tones on exact integer carrier phases (channel k advances
    k/k_div cycles per sample)."""
    idx = np.arange(t * n)
    s = idx / rate
    x = np.zeros(t * n, np.complex128)
    for k, audio, amp in tones:
        carrier = ((idx * k) % k_div) / k_div
        fm = 0.3 * dev / audio * (1.0 - np.cos(2 * np.pi * audio * s))
        x += amp * np.exp(1j * (2 * np.pi * carrier + fm))
    ph = np.exp(1j * np.linspace(0.0, 0.5, batch))
    return _chunked(x[None, :] * ph[:, None], t)


# -- phases ------------------------------------------------------------------

def phase_device(devs):
    d = devs[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    log(f"[device] nvidia-smi: {backend.card()}")
    log(f"[device] matmul precision: {config.matmul_precision_name()}")


def wfm_bound(sz):
    from radiorust_tpu.models.wfm import WFM_INPUT_RATE, wfm_receiver
    sig = StreamSig(sz.batch, sz.wfm_chunk, WFM_INPUT_RATE)
    return wfm_receiver(filter_ir_len=sz.wfm_ir), sig


def phase_wfm(sz, dev, ref):
    chain, sig = wfm_bound(sz)
    bound = chain.bind(sig)
    xs = fm_tone(sz.wfm_chunks, sig.batch, sig.chunk_len, sig.sample_rate)
    t0 = time.perf_counter()
    got = run_scan(bound, xs, dev)
    log(f"[wfm] {sig.batch} streams x {sig.chunk_len} samples x "
        f"{sz.wfm_chunks} chunks on {dev.platform}: "
        f"{time.perf_counter() - t0:.1f} s incl. compile")
    want = run_scan(bound, xs, ref)
    # Tone input keeps the demodulator away from its chaotic zero-amplitude
    # region; from chunk valid_from on (two cascaded overlap-save warmups)
    # the two backends differ only by FFT/conv summation order in f32.
    compare("wfm", got, want, skip=bound.valid_from, tol=1e-4)
    with jax.default_device(dev):
        reset = np.zeros((sig.batch,), bool)
        step = jax.jit(lambda p, s, x: bound.process(p, s, x, reset))
        mem = step.lower(bound.params, bound.init_state(),
                         xs[0]).compile().memory_analysis()
    log(f"[wfm] step memory_analysis: {mem}")
    return xs, got


def phase_served(sz, dev, xs, scanned):
    from radiorust_tpu.runtime import ArraySink, RuntimeBlock, wait_until
    from radiorust_tpu.runtime.flow import new_sender
    from radiorust_tpu.signal import Samples

    chain, sig = wfm_bound(sz)

    async def serve():
        sender, connector = new_sender()
        blk = RuntimeBlock(chain, name="wfm")
        sink = ArraySink()
        blk.feed_from(type("Source", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        for x in xs:
            await sender.send(Samples(sig.sample_rate, x))
        await wait_until(lambda: len(sink.chunks) >= len(xs), blk, sink,
                         timeout=600)
        return np.stack(sink.chunks[:len(xs)])

    with jax.default_device(dev):
        got = asyncio.run(serve())
    assert got.shape[0] >= 8 or got.shape[0] == len(xs)
    diff = float(np.abs(got - scanned).max())
    peak = float(np.abs(scanned).max())
    tol = 1e-5
    ok = np.isfinite(got).all() and diff <= tol * peak
    log(f"[served] {len(xs)} chunks source -> RuntimeBlock -> sink vs the "
        f"scan: max|diff|/peak {diff / peak:.3e} (tol {tol:g}, precision "
        f"{config.matmul_precision_name()}) -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"served: {diff / peak:.3e} >= {tol:g}")


def model_cases(sz):
    """(name, chain spec, StreamSig, inputs, is_graph, post, skip, tol).

    Tolerances are on the steady-chunk energy/fingerprint relative error
    at the ``highest`` precision, where both backends compute in float32
    and differ only in summation order (FFT, convolution, prefix sums).
    Linear and envelope chains get 1e-5; chains that demodulate (atan2
    amplifies ulps near small amplitudes) or carry a phase across chunks
    (FmMod) get 1e-4.  Both are over 20x the largest error measured on
    an H100 (4.6e-7, stereo)."""
    from radiorust_tpu.blocks.filters import Filter
    from radiorust_tpu.blocks.resampling import Downsampler
    from radiorust_tpu.blocks.transform import FreqShifter
    from radiorust_tpu.models.analog import (ANALOG_INPUT_CHUNK,
                                             ANALOG_INPUT_RATE, am_receiver,
                                             isb_receiver, ssb_receiver)
    from radiorust_tpu.models.bandwidth_meter import (bandwidth_meter_chain,
                                                      measure_bandwidth)
    from radiorust_tpu.models.channelizer import channelized_receiver
    from radiorust_tpu.models.morse_tx import morse_audio_chain, morse_rf_chain
    from radiorust_tpu.models.stereo import wfm_stereo_receiver
    from radiorust_tpu.models.wfm import wfm_transmitter

    b, t, k = sz.batch, sz.model_chunks, sz.scale

    def lp(bins, freqs):
        return np.where(np.abs(freqs) <= 500000.0, 1.0 + 0.0j, 0.0j)

    def analog_input(kind, n, rate):
        s = np.arange(t * n) / rate
        if kind == "am":
            base = 1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * s)
        elif kind == "ssb":
            base = np.exp(2j * np.pi * 1500.0 * s)
        else:
            base = (0.5 * np.exp(2j * np.pi * 1000.0 * s)
                    + 0.5 * np.exp(-2j * np.pi * 2000.0 * s))
        amp = np.linspace(0.5, 1.0, b)
        return _chunked(base[None, :] * amp[:, None], t)

    an, ar = ANALOG_INPUT_CHUNK // k, ANALOG_INPUT_RATE
    cases = [
        ("stereo", wfm_stereo_receiver(), 16384 // k, 1024000.0,
         lambda n, r: stereo_mpx(t, b, n, r), True, None, 2, 1e-4),
        ("stereo_wide", wfm_stereo_receiver(filter_ir_len=6144 // k),
         24576 // k, 1024000.0, lambda n, r: stereo_mpx(t, b, n, r), True,
         None, 2, 1e-4),
        ("channelizer", channelized_receiver(), 65536 // k, 16384000.0,
         lambda n, r: carriers(t, b, n, r, [(c, 300.0 + 23.0 * c, 1.0)
                                           for c in range(64)], 64,
                               0.25 * r / 64), False, None, 1, 1e-4),
        ("am", am_receiver(), an, ar,
         lambda n, r: analog_input("am", n, r), False, None, 1, 1e-5),
        ("ssb", ssb_receiver(), an, ar,
         lambda n, r: analog_input("ssb", n, r), False, None, 1, 1e-5),
        ("isb", isb_receiver(), an, ar,
         lambda n, r: analog_input("isb", n, r), True, None, 1, 1e-5),
        ("morse", morse_audio_chain(), 4096 // k, 48000.0,
         lambda n, r: keyed_envelope(t, b, n), False, None, 1, 1e-5),
        ("morse_rf", morse_rf_chain(), 4096 // k, 128000.0,
         lambda n, r: keyed_envelope(t, b, n), False, None, 1, 1e-4),
        ("bw_meter", bandwidth_meter_chain(), 10240 // k, 1024000.0,
         lambda n, r: carriers(t, b, n, r, [(5, 150.0, 1.0),
                                           (1024 - 4, 230.0, 0.7)], 1024,
                               1000.0), False,
         lambda ys: measure_bandwidth(ys, 102400.0), 2, 1e-4),
        ("audiopipe", Chain(FreqShifter.with_shift(-100000.0),
                            Filter.new(lp),
                            Downsampler(1200000.0, 1000000.0)),
         16384 // k, 2400000.0, lambda n, r: noise(t, b, n, seed=1), False,
         None, 1, 1e-5),
        ("wfm_tx", wfm_transmitter(), 768, 48000.0,
         lambda n, r: _wfm_tx_audio(t, b, n), False, None, 1, 1e-4),
    ]
    return cases


def _wfm_tx_audio(t, b, n):
    idx = np.arange(t * n)
    a = (0.4 * np.sin(2 * np.pi * (idx % 48) / 48.0)
         + 0.2 * np.sin(2 * np.pi * (idx % 16) / 16.0))
    amp = np.linspace(0.6, 1.0, b)
    return _chunked(amp[:, None] * a[None, :], t)


def phase_models(sz, dev, ref):
    failures = []
    for name, spec, n, rate, gen, is_graph, post, skip, tol in \
            model_cases(sz):
        sig = StreamSig(sz.batch, n, rate)
        bound = spec.bind({"iq": sig} if is_graph else sig)
        xs = gen(n, rate)
        try:
            got = run_scan(bound, xs, dev, is_graph, post)
            want = run_scan(bound, xs, ref, is_graph, post)
            compare(name, got, want, skip=skip, tol=tol)
        except AssertionError as e:
            failures.append(str(e))
    if failures:
        raise AssertionError("; ".join(failures))


def phase_kernels(sz, dev, ref):
    """The slew-rate limiter at the morse_rf rate: the GPU kernel (what
    the backend policy picks on the card) vs ``lax.scan`` on the CPU."""
    from radiorust_tpu.blocks.filters import SlewRateLimiter
    n = 4096 // sz.scale
    bound = Chain(SlewRateLimiter(100.0)).bind(StreamSig(sz.batch, n,
                                                         128000.0))
    rng = np.random.default_rng(5)
    xs = keyed_envelope(2, sz.batch, n) + 0.05 * noise(2, sz.batch, n)
    xs = xs.astype(np.complex64) + (
        0.01 * rng.standard_normal(xs.shape)).astype(np.complex64)
    got = run_scan(bound, xs, dev)
    want = run_scan(bound, xs, ref)
    diff = float(np.abs(got - want).max())
    # An f32 recurrence: the kernel's rsqrt clamp and the scan's
    # sqrt/divide differ by a few ulps per clamped step, and the clamp
    # does not amplify them (|y| <= 1.2 here).
    tol = 1e-5
    ok = np.isfinite(got).all() and diff <= tol
    log(f"[kernels] slew_scan {sz.batch} x {n} @ 128 kHz on "
        f"{dev.platform} vs lax.scan on {ref.platform}: max|diff| "
        f"{diff:.3e} (tol {tol:g}) -> {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernels: slew {diff:.3e} > {tol:g}")


def run_phases(sz, dev, ref):
    """Phases 2-5; returns the names of the phases that failed."""
    failed = []
    xs = scanned = None
    for name, fn in (("wfm", lambda: phase_wfm(sz, dev, ref)),
                     ("served", lambda: phase_served(sz, dev, xs, scanned)),
                     ("models", lambda: phase_models(sz, dev, ref)),
                     ("kernels", lambda: phase_kernels(sz, dev, ref))):
        t0 = time.perf_counter()
        try:
            if name == "served" and scanned is None:
                raise AssertionError("needs phase wfm's scan")
            out = fn()
            if name == "wfm":
                xs, scanned = out
        except Exception as e:  # report every phase, then fail the run
            failed.append(name)
            log(f"[{name}] FAILED: {type(e).__name__}: {e}")
        log(f"[{name}] {time.perf_counter() - t0:.1f} s")
    return failed


# -- four devices -------------------------------------------------------------

def run_four(sz, devs):
    """The multi-device paths: time/channel sharding, pipeline stages and
    the fan-in DAG (``dryrun_multichip``), and a data-parallel fleet
    ``RuntimeBlock(mesh=...)`` of 4 x ``fleet_per_device`` WFM streams,
    each against the single-device sequential scan."""
    from jax.sharding import Mesh

    from __graft_entry__ import dryrun_multichip
    from radiorust_tpu.runtime import ArraySink, RuntimeBlock, wait_until
    from radiorust_tpu.runtime.flow import new_sender
    from radiorust_tpu.signal import Samples

    failed = []
    t0 = time.perf_counter()
    try:
        dryrun_multichip(len(devs))
        log(f"[four] dryrun_multichip({len(devs)}) on "
            f"{devs[0].platform}: every case matches the sequential scan")
    except Exception as e:
        failed.append("dryrun")
        log(f"[four] dryrun FAILED: {type(e).__name__}: {e}")
    log(f"[four] dryrun {time.perf_counter() - t0:.1f} s")

    chain, sig = wfm_bound(sz)
    streams = len(devs) * sz.fleet_per_device
    sig = StreamSig(streams, sig.chunk_len, sig.sample_rate)
    xs = fm_tone(4, streams, sig.chunk_len, sig.sample_rate)
    mesh = Mesh(np.array(devs), ("streams",))

    async def serve():
        sender, connector = new_sender()
        blk = RuntimeBlock(chain, mesh=mesh, name="fleet")
        sink = ArraySink()
        blk.feed_from(type("Source", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        for x in xs:
            await sender.send(Samples(sig.sample_rate, x))
        await wait_until(lambda: len(sink.chunks) >= len(xs), blk, sink,
                         timeout=600)
        return np.stack(sink.chunks[:len(xs)])

    t0 = time.perf_counter()
    tol = 1e-4
    try:
        got = asyncio.run(serve())
        if not np.isfinite(got).all():
            raise AssertionError("fleet output is not finite")
        # Every chunk, warmup included, against the one-device scan at the
        # per-device batch: a shard's initial state or reset shows here.
        per = sz.fleet_per_device
        local = chain.bind(StreamSig(per, sig.chunk_len, sig.sample_rate))
        diff = peak = 0.0
        for s in range(0, streams, per):
            want = run_scan(local, xs[:, s:s + per], devs[0])
            diff = max(diff, float(np.abs(got[:, s:s + per] - want).max()))
            peak = max(peak, float(np.abs(want).max()))
        ok = diff <= tol * peak
        log(f"[four] fleet {streams} streams over {len(devs)} devices vs "
            f"one-device scans of {per} streams, chunks 0..3: max|diff|/peak "
            f"{diff / peak:.3e} (tol {tol:g}) -> {'OK' if ok else 'FAIL'}")
        # Against one scan of all streams from the first valid chunk on;
        # in the warmup chunks the demod's arctan2 amplifies the filters'
        # batch-dependent rounding on near-zero samples, so those are
        # printed, not gated.
        bound = chain.bind(sig)
        want = run_scan(bound, xs, devs[0])
        skip = bound.valid_from
        warm = float(np.abs(got[:skip] - want[:skip]).max())
        diff = float(np.abs(got[skip:] - want[skip:]).max())
        peak = float(np.abs(want[skip:]).max())
        ok_all = diff <= tol * peak
        log(f"[four] fleet vs one-device scan of {streams} streams, chunks "
            f"{skip}..3: max|diff|/peak {diff / peak:.3e} (tol {tol:g}) -> "
            f"{'OK' if ok_all else 'FAIL'}; warmup chunks 0..{skip - 1}: "
            f"max|diff|/peak {warm / peak:.3e} (not gated)")
        if not (ok and ok_all):
            raise AssertionError("fleet differs from the one-device scans")
    except Exception as e:
        failed.append("fleet")
        log(f"[four] fleet FAILED: {type(e).__name__}: {e}")
    log(f"[four] fleet {time.perf_counter() - t0:.1f} s")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on four GPUs")
    args = ap.parse_args(argv)
    devs = backend.require_gpu("chip_smoke", 4 if args.four else 1)
    enable_compile_cache()
    phase_device(devs)
    sz = Sizes.full()
    t0 = time.perf_counter()
    if args.four:
        devs = devs[:4]
        failed = run_four(sz, devs)
    else:
        failed = run_phases(sz, devs[0], jax.devices("cpu")[0])
    log(f"total {time.perf_counter() - t0:.1f} s")
    if failed:
        log(f"FAILED phases: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
