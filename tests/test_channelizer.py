"""Polyphase channelizer tests: tone routing, amplitude preservation,
aliasing rejection, streaming continuity."""

import numpy as np
import pytest

import jax.numpy as jnp

from radiorust_tpu.blocks.base import StreamSig, scan
from radiorust_tpu.blocks.channelize import Channelizer


def run(chan, chunks, sig):
    b = chan.bind(sig)
    state, ys = scan(b, b.params, b.init_state(), jnp.asarray(chunks))
    return np.asarray(ys), b


def test_out_signature():
    b = Channelizer(64).bind(StreamSig(2, 8192, 1024000.0))
    assert b.out_sig.batch == 128
    assert b.out_sig.chunk_len == 128
    assert b.out_sig.sample_rate == 16000.0


@pytest.mark.parametrize("channel", [0, 1, 7, 13, 31])
def test_tone_lands_in_its_channel(channel):
    m, n, rate = 32, 2048, 320000.0
    t_chunks = 4
    t = np.arange(t_chunks * n) / rate
    f = channel * rate / m
    x = np.exp(2j * np.pi * f * t).astype(np.complex64)
    chunks = x.reshape(t_chunks, 1, n)
    ys, b = run(Channelizer(m), chunks, StreamSig(1, n, rate))
    # ys: [T, m, n/m]; after warmup the tone channel carries ~unit DC.
    settled = ys[2:]
    power = np.mean(np.abs(settled) ** 2, axis=(0, 2))  # per channel
    assert np.argmax(power) == channel
    np.testing.assert_allclose(power[channel], 1.0, rtol=0.05)
    others = np.delete(power, channel)
    assert others.max() < 1e-3


def test_offset_tone_frequency_in_channel():
    # A tone at channel center + delta appears at delta in that channel.
    m, n, rate = 16, 1024, 160000.0
    ch, delta = 5, 1000.0
    t = np.arange(6 * n) / rate
    f = ch * rate / m + delta
    x = np.exp(2j * np.pi * f * t).astype(np.complex64)
    ys, b = run(Channelizer(m), x.reshape(6, 1, n), StreamSig(1, n, rate))
    out_rate = rate / m
    seg = ys[3:, ch, :].reshape(-1)
    steps = np.angle(seg[1:] * np.conj(seg[:-1]))
    np.testing.assert_allclose(np.mean(steps), 2 * np.pi * delta / out_rate,
                               atol=2e-3)


def test_streaming_continuity():
    # Chunked processing equals one-shot processing (history carry).
    m, n, rate = 8, 256, 8000.0
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4 * n) + 1j * rng.standard_normal(4 * n)
         ).astype(np.complex64)
    ys_chunked, _ = run(Channelizer(m), x.reshape(4, 1, n),
                        StreamSig(1, n, rate))
    ys_oneshot, _ = run(Channelizer(m), x.reshape(1, 1, 4 * n),
                        StreamSig(1, 4 * n, rate))
    got = np.concatenate([ys_chunked[i] for i in range(4)], axis=-1)
    np.testing.assert_allclose(got, ys_oneshot[0], atol=1e-4)


def test_batch_folding():
    # Two streams with tones in different channels stay separated.
    m, n, rate = 8, 512, 80000.0
    t = np.arange(2 * n) / rate
    x1 = np.exp(2j * np.pi * (2 * rate / m) * t)
    x2 = np.exp(2j * np.pi * (6 * rate / m) * t)
    chunks = np.stack([x1.reshape(2, n), x2.reshape(2, n)], axis=1
                      ).astype(np.complex64)
    ys, b = run(Channelizer(m), chunks, StreamSig(2, n, rate))
    # ys: [T, 2*m, n/m]; stream 0 rows 0..m, stream 1 rows m..2m.
    power = np.mean(np.abs(ys[1:]) ** 2, axis=(0, 2))
    assert np.argmax(power[:m]) == 2
    assert np.argmax(power[m:]) == 6


def test_pfb_channel_matches_shift_downsample_chain():
    """Parity oracle: PFB channel c equals the construction it replaces —
    FreqShifter(-c*rate/M) -> Downsampler(rate/M) — up to one fixed complex
    gain (the two anti-alias filters differ in shape/delay inside the
    passband; for a steady in-band tone that is a constant complex scalar).
    Residual after the scalar fit must be < -30 dB; cross-channel leakage
    < -30 dB."""
    from radiorust_tpu.blocks.base import Chain, StreamSig, scan
    from radiorust_tpu.blocks.channelize import Channelizer
    from radiorust_tpu.blocks.resampling import Downsampler
    from radiorust_tpu.blocks.transform import FreqShifter

    m, rate, n, c = 8, 80000.0, 2048, 3
    sig = StreamSig(1, n, rate)
    steps = 6
    df = 0.12 * rate / m          # in-band offset from the channel center
    f = c * rate / m + df
    t = np.arange(steps * n) / rate
    x = np.exp(2j * np.pi * f * t).astype(np.complex64)
    xs = x.reshape(steps, 1, n)

    pfb = Channelizer(m, taps_per_branch=16).bind(sig)
    _, y_pfb = scan(pfb, pfb.params, pfb.init_state(), jnp.asarray(xs))
    # [T, m, n/m]: channel c, steady-state chunks only.
    got = np.asarray(y_pfb)[2:, c, :].ravel()

    chain = Chain(FreqShifter.with_shift(-c * rate / m),
                  Downsampler(rate / m, 0.5 * rate / m)).bind(sig)
    _, y_ch = scan(chain, chain.params, chain.init_state(), jnp.asarray(xs))
    want = np.asarray(y_ch)[2:, 0, :].ravel()

    # Complex least-squares gain between the two outputs.  The PFB is
    # unit-gain at a channel center; the reference-style Downsampler has
    # energy-normalized taps (resampling.rs:97-101), whose passband gain is
    # the tap sum — so the fixed gain between the two is sum(taps).
    a = np.vdot(got, want) / np.vdot(got, got)
    expected_gain = float(np.sum(chain.blocks[1].plan.kernel[0]))
    resid = want - a * got
    sig_e = float(np.sum(np.abs(want) ** 2))
    res_e = float(np.sum(np.abs(resid) ** 2))
    assert abs(abs(a) - expected_gain) < 0.05 * expected_gain, (
        f"gain {abs(a)} vs designed {expected_gain}")
    assert res_e < 1e-3 * sig_e, (
        f"residual {10 * np.log10(res_e / sig_e):.1f} dB")

    # Rejection: the tone leaks into other channels far below channel c.
    main_e = float(np.sum(np.abs(np.asarray(y_pfb)[2:, c, :]) ** 2))
    for other in range(m):
        if other in (c, (c - 1) % m, (c + 1) % m):
            continue  # adjacent channels see transition-band energy
        leak = float(np.sum(np.abs(np.asarray(y_pfb)[2:, other, :]) ** 2))
        assert leak < 1e-3 * main_e, (other, leak / main_e)
