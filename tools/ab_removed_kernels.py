#!/usr/bin/env python
"""A/B, on a GPU, of the formulations the H100 bring-up removed.

The removed code (the fused Pallas filter, front-end and channelizer
kernels, the matmul four-step FFT, the triangular-matmul prefix sum) no
longer exists in this tree, so the tool runs against a checkout of the
last commit that still had it.  It imports ``radiorust_tpu`` from that
checkout and times, in one process on one card:

- ``wfm:*``    the WFM chain at 64 x 24576 (IR 6144) with the plain XLA
               blocks, under each matmul precision and with the four-step
               FFT or ``jnp.fft``; each against the ``jnp.fft``/``highest``
               output;
- ``fft:N``    the four-step FFT and ``jnp.fft``, forward + inverse, at
               the transform sizes the chains use, with the error of each
               against float64;
- ``cumsum:S`` the triangular-matmul prefix sum and ``jnp.cumsum``;
- ``kern:*``   each removed kernel as the GPU ran it in that commit (the
               Pallas interpreter: its kernels were written for another
               accelerator and never compiled for the GPU) against the
               plain XLA blocks at the chains' shapes;
- ``wfm:interp_*`` the whole chain as that commit ran it on the GPU.

Times are ms per chunk (best of several calls of a jitted scan over T
chunks) or per call.  Run it like this:

    old=$(git log -1 --format=%H --diff-filter=D -- \\
          radiorust_tpu/ops/pallas_filter.py)^
    mkdir -p build/parent && git archive "$old" | tar -x -C build/parent
    python tools/ab_removed_kernels.py --tree build/parent \\
        --out ab_removed_kernels.jsonl [case-prefix ...]

One JSON line per case goes to stdout (and is appended to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback

import numpy as np

B = 64  # streams per chunk; --batch overrides it


def fm_tone(t, b, n, rate, dev=150000.0, fa=1000.0, seed=0):
    s = np.arange(t * n) / rate
    iq = np.exp(1j * 0.3 * dev / fa * (1 - np.cos(2 * np.pi * fa * s)))
    ph = np.exp(1j * np.linspace(0, 1, b))
    rng = np.random.default_rng(seed)
    x = iq[None] * ph[:, None] + 0.01 * (
        rng.standard_normal((b, t * n)) + 1j * rng.standard_normal((b, t * n)))
    return np.moveaxis(x.astype(np.complex64).reshape(b, t, n), 1, 0)


def best_of(f, reps):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None):
    global jax, jnp, B
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, type=pathlib.Path,
                    help="checkout of the commit that still has the kernels")
    ap.add_argument("--out", type=pathlib.Path, help="append JSON lines here")
    ap.add_argument("--batch", type=int, default=B,
                    help=f"streams per chunk (default {B})")
    ap.add_argument("only", nargs="*", help="case prefixes to run (wfm, "
                    "fft, cumsum, kern); default all")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))

    B = args.batch
    import jax
    import jax.numpy as jnp

    import radiorust_tpu
    import radiorust_tpu.blocks.analysis as ba
    import radiorust_tpu.blocks.filters as bf
    import radiorust_tpu.ops.fft as offt
    import radiorust_tpu.ops.pallas_filter as pfl
    from radiorust_tpu import config
    from radiorust_tpu.blocks.base import Chain, StreamSig, scan
    from radiorust_tpu.blocks.filters import Filter, FilterBank, \
        SlewRateLimiter
    from radiorust_tpu.blocks.frontend import (FilterDemodFilter,
                                               FmDemodFilter, MixerDecimator)
    from radiorust_tpu.blocks.modulation import FmDemod
    from radiorust_tpu.blocks.resampling import Downsampler, _BoundResampler
    from radiorust_tpu.blocks.transform import FreqShifter
    from radiorust_tpu.models.channelizer import channelized_receiver
    from radiorust_tpu.models.wfm import (WFM_INPUT_RATE, _deemphasis_band,
                                          _lowpass_100k, wfm_receiver)
    from radiorust_tpu.ops.cumsum import matmul_cumsum

    tree = pathlib.Path(radiorust_tpu.__file__).resolve().parents[1]
    if tree != args.tree.resolve():
        raise SystemExit(f"imported radiorust_tpu from {tree}, not --tree")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {dev.platform!r}")
    print("device", dev.device_kind, jax.__version__, flush=True)

    use_fused, use_pallas = pfl.use_fused_filter, _BoundResampler._use_pallas

    def setmode(kernels, matfft, prec):
        pfl.use_fused_filter = (use_fused if kernels
                                else lambda *a, **k: False)
        _BoundResampler._use_pallas = (use_pallas if kernels
                                       else lambda self: False)
        config.set_pallas_scan(kernels)
        fft, ifft = ((offt.fft, offt.ifft) if matfft
                     else (jnp.fft.fft, jnp.fft.ifft))
        bf._fft, bf._ifft, ba._fft = fft, ifft, fft
        config.set_matmul_precision(prec)

    def emit(rec):
        rec["device"] = dev.device_kind
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(line + "\n")

    def case(name, fn):
        if args.only and name.split(":")[0] not in args.only:
            return
        try:
            t0 = time.perf_counter()
            rec = fn()
            rec["case"] = name
            rec["wall_s"] = round(time.perf_counter() - t0, 2)
            emit(rec)
        except Exception as e:  # one failed case must not hide the rest
            emit({"case": name, "error": f"{type(e).__name__}: {e}"[:400]})
            traceback.print_exc()

    def chain_case(spec, sig, kernels, matfft, prec, xs, reps=5, ref=None):
        setmode(kernels, matfft, prec)
        bound = spec().bind(sig)
        p = jax.device_put(bound.params)
        s = jax.device_put(bound.init_state())
        x = jax.device_put(jnp.asarray(xs))
        run = jax.jit(lambda p, s, x: scan(bound, p, s, x)[1])
        t0 = time.perf_counter()
        ys = np.asarray(jax.block_until_ready(run(p, s, x)))
        compile_s = time.perf_counter() - t0
        ms = best_of(lambda: run(p, s, x), reps) / xs.shape[0] * 1e3
        rec = {"ms_per_chunk": ms, "compile_s": round(compile_s, 1),
               "prec": prec, "kernels": kernels, "matfft": matfft,
               "finite": bool(np.isfinite(ys).all())}
        if ref is not None:
            r = ref[1:]
            rec["rel_err_vs_ref"] = float(
                np.abs(ys[1:] - r).max() / max(np.abs(r).max(), 1e-30))
        return rec, ys

    # -- the WFM chain: precision and FFT formulation, plain XLA blocks --
    wsig = StreamSig(B, 24576, WFM_INPUT_RATE)
    xs_w = fm_tone(4, B, 24576, WFM_INPUT_RATE)
    ref = {}

    def wfm(**kw):
        return lambda: wfm_receiver(filter_ir_len=6144, **kw)

    def wfm_plain(matfft, prec):
        def run():
            rec, ys = chain_case(wfm(), wsig, False, matfft, prec, xs_w,
                                 ref=ref.get("ys"))
            if not matfft and prec == "highest":
                ref["ys"] = ys
            return rec
        return run

    for matfft, prec in ((False, "highest"), (False, "high"),
                         (False, "default"), (True, "highest"),
                         (True, "high")):
        name = f"wfm:plain_{'matfft' if matfft else 'jnpfft'}_{prec}"
        case(name, wfm_plain(matfft, prec))

    # -- FFT alone: forward + inverse at batch 64 --
    def fft_case(n):
        rng = np.random.default_rng(n)
        x = (rng.standard_normal((B, n))
             + 1j * rng.standard_normal((B, n))).astype(np.complex64)
        want = np.fft.fft(x.astype(np.complex128))
        x = jax.device_put(x)
        res = {}
        for nm, f, fi, precs in (("matmul", offt.fft, offt.ifft,
                                  ("highest", "high")),
                                 ("jnp", jnp.fft.fft, jnp.fft.ifft,
                                  ("highest",))):
            for prec in precs:
                config.set_matmul_precision(prec)
                both = jax.jit(lambda a: fi(f(a) * 1.0001))
                fwd = jax.jit(f)
                jax.block_until_ready(both(x))
                res[f"{nm}_{prec}_ms_fwd_inv"] = best_of(
                    lambda: both(x), 10) * 1e3
                res[f"{nm}_{prec}_max_rel_err"] = float(
                    np.abs(np.asarray(fwd(x)) - want).max()
                    / np.abs(want).max())
        config.set_matmul_precision(None)
        return res

    for n in (8192, 12288, 15360, 32768):
        case(f"fft:{n}", lambda n=n: fft_case(n))

    # -- prefix sums --
    def cumsum_case(shape):
        x = np.random.default_rng(1).standard_normal(shape).astype(
            np.float32)
        want = np.cumsum(x.astype(np.float64), -1)
        x = jax.device_put(x)
        res = {}
        for nm, f in (("matmul_highest",
                       lambda a: matmul_cumsum(a, "highest")),
                      ("matmul_high", lambda a: matmul_cumsum(a, "high")),
                      ("jnp", lambda a: jnp.cumsum(a, -1))):
            g = jax.jit(f)
            jax.block_until_ready(g(x))
            res[f"{nm}_us"] = best_of(lambda: g(x), 20) * 1e6
            res[f"{nm}_max_rel_err"] = float(
                np.abs(np.asarray(g(x)) - want).max() / np.abs(want).max())
        return res

    for shape in ((64, 4096), (64, 16384), (256, 2048)):
        case(f"cumsum:{shape}", lambda shape=shape: cumsum_case(shape))

    # -- each removed kernel (interpreted) against the plain blocks --
    msig = StreamSig(B, 9216, 384000.0)
    xs_m = fm_tone(4, B, 9216, 384000.0)

    def pair(name, kernel_spec, plain_spec, sig, xs):
        def run():
            rk, yk = chain_case(kernel_spec, sig, True, True, "highest", xs,
                                reps=2)
            rp, yp = chain_case(plain_spec, sig, False, False, "highest", xs)
            r = yp[1:]
            return {"kernel_interp_ms": rk["ms_per_chunk"],
                    "kernel_compile_s": rk["compile_s"],
                    "plain_ms": rp["ms_per_chunk"],
                    "plain_compile_s": rp["compile_s"],
                    "rel_diff": float(np.abs(yk[1:] - r).max()
                                      / max(np.abs(r).max(), 1e-30))}
        case(name, run)

    def bank3():
        # A 3-band FilterBank (the stereo decoder's shape) as a one-output
        # block, so chain_case can scan it.
        bands = [lambda b, f, lo=lo: np.where(
            (np.abs(f) >= lo) & (np.abs(f) <= lo + 15000.0), 1.0 + 0j, 0j)
            for lo in (0.0, 18000.0, 23000.0)]
        bank = FilterBank(bands, ir_len=6144)

        class Stacked:
            def __init__(self, b):
                self.b, self.params, self.in_sig = b, b.params, b.in_sig

            def init_state(self):
                return self.b.init_state()

            def process(self, p, s, x, reset):
                s, ys = self.b.process(p, s, x, reset)
                return s, jnp.stack(ys)

        class Spec:
            def bind(self, sig):
                return Stacked(bank.bind(sig))
        return Spec()

    def lowpass():
        return Filter.new(_lowpass_100k, ir_len=6144)

    def deemph():
        return Filter.new_rectangular(_deemphasis_band, ir_len=6144)

    pair("kern:fused_overlap_save", lambda: Chain(lowpass()),
         lambda: Chain(lowpass()), msig, xs_m)
    pair("kern:fused_filter_bank", bank3, bank3, msig, xs_m)
    pair("kern:fused_demod_filter",
         lambda: Chain(FmDemodFilter(150000.0, _deemphasis_band,
                                     ir_len=6144)),
         lambda: Chain(FmDemod(150000.0), deemph()), msig, xs_m)
    pair("kern:fused_filter_demod_filter",
         lambda: Chain(FilterDemodFilter(_lowpass_100k, 150000.0,
                                         _deemphasis_band, ir_len=6144)),
         lambda: Chain(lowpass(), FmDemod(150000.0), deemph()), msig, xs_m)
    pair("kern:fused_mix_decimate",
         lambda: Chain(MixerDecimator(-57000.0, 384000.0, 200000.0)),
         lambda: Chain(FreqShifter.with_shift(-57000.0),
                       Downsampler(384000.0, 200000.0)), wsig, xs_w)
    pair("kern:pallas_decimate_stage1",
         lambda: Chain(Downsampler(384000.0, 200000.0)),
         lambda: Chain(Downsampler(384000.0, 200000.0)), wsig, xs_w)
    pair("kern:pallas_decimate_tail",
         lambda: Chain(Downsampler(48000.0, 40000.0)),
         lambda: Chain(Downsampler(48000.0, 40000.0)), msig, xs_m)
    csig = StreamSig(B, 65536, 16384000.0)
    xs_c = fm_tone(2, B, 65536, 16384000.0, dev=64000.0)
    pair("kern:fused_pfb_demod", lambda: channelized_receiver(fuse=True),
         lambda: channelized_receiver(fuse=False), csig, xs_c)
    ssig = StreamSig(B, 4096, 48000.0)
    rng = np.random.default_rng(3)
    xs_s = (rng.standard_normal((4, B, 4096))
            + 1j * rng.standard_normal((4, B, 4096))).astype(np.complex64)
    pair("kern:slew_scan", lambda: Chain(SlewRateLimiter(300.0)),
         lambda: Chain(SlewRateLimiter(300.0)), ssig, xs_s)

    # -- the whole chain as that commit ran it on the GPU --
    case("wfm:interp_kernels_literal_highest",
         lambda: chain_case(wfm(), wsig, True, True, "highest", xs_w,
                            reps=2, ref=ref.get("ys"))[0])
    case("wfm:interp_bench_fused_high",
         lambda: chain_case(wfm(fuse_frontend=True, fuse_demod=True), wsig,
                            True, True, "high", xs_w, reps=2,
                            ref=ref.get("ys"))[0])


if __name__ == "__main__":
    main()
