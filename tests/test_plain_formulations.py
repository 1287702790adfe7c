"""The plain XLA formulations of the receive chains' stages, at the
geometries and rates of the WFM, stereo and bandwidth-meter chains:
overlap-save filters and banks (coupled and decoupled geometry) against
the per-sample oracles or a direct float64 convolution, and the rational
decimators (alone and behind the mixer) against the reference loops."""

import jax.numpy as jnp
import numpy as np
import pytest

import oracles
from radiorust_tpu.blocks.base import Chain, StreamSig, scan
from radiorust_tpu.blocks.filters import (Filter, FilterBank,
                                          design_impulse_response)
from radiorust_tpu.blocks.resampling import Downsampler
from radiorust_tpu.blocks.transform import FreqShifter
from radiorust_tpu.windowing import Kaiser

RATE = 384000.0


def _lowpass(cut):
    def resp(bins, freqs):
        return np.where(np.abs(freqs) <= cut, 1.0 + 0.0j, 0.0j)
    return resp


def _noise(t, batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, batch, n))
            + 1j * rng.standard_normal((t, batch, n))).astype(np.complex64)


def _run(bound, xs):
    _, ys = scan(bound, bound.params, bound.init_state(), jnp.asarray(xs))
    return ys


def _stream(xs, b):
    return xs[:, b].reshape(-1)


def _convolve(x, freq_resp, m):
    """Causal convolution of a stream with the designed m-tap impulse
    response (zero history), in float64."""
    ir = design_impulse_response(freq_resp, Kaiser.with_null_at_bin(2.0), m,
                                 RATE).astype(np.complex64)
    return np.convolve(x.astype(np.complex128), ir)[:len(x)]


@pytest.mark.parametrize("n,batch", [(6144, 4), (2048, 8), (6144, 3)])
def test_filter_coupled_geometry_matches_oracle(n, batch):
    xs = _noise(3, batch, n, seed=n + batch)
    ys = np.asarray(_run(Filter.new(_lowpass(100000.0)).bind(
        StreamSig(batch, n, RATE)), xs))

    def scalar_resp(bin_idx, freq):
        return 1.0 + 0.0j if abs(freq) <= 100000.0 else 0.0j

    for b in range(batch):
        want = oracles.oracle_filter_chunks(
            list(xs[:, b]), RATE, scalar_resp, Kaiser.with_null_at_bin(2.0))
        for k in range(1, 3):
            np.testing.assert_allclose(ys[k, b], want[k - 1], atol=2e-4)


@pytest.mark.parametrize("m,n,batch", [(512, 1536, 4), (1024, 3072, 3),
                                       (6144, 9216, 2)])
def test_filter_decoupled_geometry_matches_convolution(m, n, batch):
    # (6144, 9216): the WFM mid chunk at the bench's 24576-sample input
    # with the reference's 6144-tap filter design.
    xs = _noise(3, batch, n, seed=m + n + batch)
    bound = Filter.new(_lowpass(100000.0), ir_len=m).bind(
        StreamSig(batch, n, RATE))
    ys = np.asarray(_run(bound, xs))
    for b in range(batch):
        want = _convolve(_stream(xs, b), _lowpass(100000.0), m)
        np.testing.assert_allclose(_stream(ys, b), want, atol=2e-4)


def test_filter_bank_decoupled_geometry_matches_convolution():
    m, n, batch = 512, 1536, 4
    bands = [_lowpass(15000.0), _lowpass(53000.0)]
    bank = FilterBank(bands, ir_len=m).bind(StreamSig(batch, n, RATE))
    xs = _noise(3, batch, n, seed=77)
    state, outs = bank.init_state(), []
    reset = np.zeros((batch,), bool)
    for x in xs:
        state, ys = bank.process(bank.params, state, jnp.asarray(x), reset)
        outs.append(np.stack([np.asarray(y) for y in ys]))
    got = np.stack(outs)                                  # [t, K, b, n]
    for j, band in enumerate(bands):
        for b in range(batch):
            want = _convolve(_stream(xs, b), band, m)
            np.testing.assert_allclose(got[:, j, b].reshape(-1), want,
                                       atol=2e-4)


def test_filter_bank_matches_oracle_per_band():
    n, batch = 2048, 4
    cuts = (15000.0, 53000.0, 100000.0)
    bank = FilterBank([_lowpass(c) for c in cuts]).bind(
        StreamSig(batch, n, RATE))
    xs = _noise(3, batch, n, seed=5)
    state, outs = bank.init_state(), []
    reset = np.zeros((batch,), bool)
    for x in xs:
        state, ys = bank.process(bank.params, state, jnp.asarray(x), reset)
        outs.append(np.stack([np.asarray(y) for y in ys]))
    got = np.stack(outs)
    for j, cut in enumerate(cuts):
        def scalar_resp(bin_idx, freq, cut=cut):
            return 1.0 + 0.0j if abs(freq) <= cut else 0.0j
        for b in range(batch):
            want = oracles.oracle_filter_chunks(
                list(xs[:, b]), RATE, scalar_resp,
                Kaiser.with_null_at_bin(2.0))
            for k in range(1, 3):
                np.testing.assert_allclose(got[k, j, b], want[k - 1],
                                           atol=2e-4)


@pytest.mark.parametrize("rates,n", [
    ((384000.0, 48000.0, 40000.0), 6144),      # WFM tail: 295-tap window
    ((1024000.0, 384000.0, 200000.0), 2048),   # WFM front end, 8:3
    ((1024000.0, 102400.0, 50000.0), 10240),   # bandwidth meter, 10:1
])
def test_downsampler_matches_oracle_at_chain_rates(rates, n):
    in_rate, out_rate, bw = rates
    xs = _noise(2, 2, n, seed=int(out_rate))
    ys = np.asarray(_run(Downsampler(out_rate, bw).bind(
        StreamSig(2, n, in_rate)), xs))
    for b in range(2):
        want = oracles.oracle_downsample(_stream(xs, b), in_rate, out_rate,
                                         bw)
        np.testing.assert_allclose(_stream(ys, b), want, atol=2e-4)


@pytest.mark.parametrize("out_rate,bw,n", [
    (384000.0, 200000.0, 2048),     # WFM front end
    (102400.0, 50000.0, 10240),     # bandwidth meter front end
])
def test_shift_then_decimate_matches_oracles(out_rate, bw, n):
    in_rate, shift = 1024000.0, 100000.0
    xs = _noise(2, 2, n, seed=n)
    # A 1 kHz phase-table precision keeps the oracle's table short.
    chain = Chain(FreqShifter.with_precision_and_shift(1000.0, shift),
                  Downsampler(out_rate, bw))
    ys = np.asarray(_run(chain.bind(StreamSig(2, n, in_rate)), xs))
    for b in range(2):
        mixed, _ = oracles.oracle_freq_shift(_stream(xs, b), in_rate, shift,
                                             precision=1000.0)
        want = oracles.oracle_downsample(mixed, in_rate, out_rate, bw)
        np.testing.assert_allclose(_stream(ys, b), want, atol=2e-4)
