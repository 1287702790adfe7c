"""End-to-end pipeline tests for the model families."""

import numpy as np
import pytest

import jax.numpy as jnp

from radiorust_tpu.blocks.base import StreamSig, scan
from radiorust_tpu.blocks.morse import Keyer, Speed
from radiorust_tpu.models.bandwidth_meter import (bandwidth_meter_chain,
                                                  measure_bandwidth)
from radiorust_tpu.models.morse_tx import morse_audio_chain
from radiorust_tpu.models.wfm import (WFM_INPUT_CHUNK, WFM_INPUT_RATE,
                                      wfm_receiver)


def run_chain(chain, sig, chunks):
    b = chain.bind(sig)
    xs = jnp.asarray(chunks)
    state, ys = scan(b, b.params, b.init_state(), xs)
    return np.asarray(ys), b


def synth_wfm_iq(audio_freq, t_chunks, deviation=150000.0,
                 rate=WFM_INPUT_RATE, n=WFM_INPUT_CHUNK, amp=0.5):
    """FM-modulate an audio tone at the full input rate (float64 synth)."""
    total = t_chunks * n
    t = np.arange(total) / rate
    audio = amp * np.sin(2 * np.pi * audio_freq * t)
    phase = 2 * np.pi * deviation / rate * np.cumsum(audio)
    iq = np.exp(1j * phase).astype(np.complex64)
    return iq.reshape(t_chunks, 1, n), audio


def test_wfm_receiver_end_to_end():
    # A 1 kHz audio tone FM-modulated at 1.024 Msps comes out of the chain
    # as a 1 kHz tone at 48 kHz.
    t_chunks = 6
    iq, _ = synth_wfm_iq(1000.0, t_chunks)
    sig = StreamSig(1, WFM_INPUT_CHUNK, WFM_INPUT_RATE)
    ys, bound = run_chain(wfm_receiver(), sig, iq)
    assert bound.out_sig.sample_rate == 48000.0
    assert bound.out_sig.chunk_len == 768
    audio_out = ys[:, 0, :].reshape(-1).real
    # Skip pipeline warmup (filters, resampler history, 1-chunk latency).
    settled = audio_out[2 * 768:]
    spec = np.abs(np.fft.fft(settled * np.hanning(len(settled))))
    freqs = np.fft.fftfreq(len(settled), 1 / 48000.0)
    peak = abs(freqs[np.argmax(spec)])
    assert abs(peak - 1000.0) < 30.0, f"peak at {peak} Hz"
    # Carrier-to-noise sanity: the peak dominates.
    others = spec.copy()
    keep = np.abs(np.abs(freqs) - 1000.0) < 100.0
    others[keep] = 0.0
    assert spec.max() > 5.0 * others.max()


def test_wfm_receiver_batch():
    # Two channels with different tones through one compiled program.
    iq1, _ = synth_wfm_iq(800.0, 4)
    iq2, _ = synth_wfm_iq(2500.0, 4)
    iq = np.concatenate([iq1, iq2], axis=1)  # [T, 2, n]
    sig = StreamSig(2, WFM_INPUT_CHUNK, WFM_INPUT_RATE)
    ys, _ = run_chain(wfm_receiver(), sig, iq)
    for ch, expect in [(0, 800.0), (1, 2500.0)]:
        audio = ys[2:, ch, :].reshape(-1).real
        spec = np.abs(np.fft.fft(audio * np.hanning(len(audio))))
        freqs = np.fft.fftfreq(len(audio), 1 / 48000.0)
        peak = abs(freqs[np.argmax(spec)])
        assert abs(peak - expect) < 40.0, f"ch{ch}: peak at {peak} Hz"


def test_morse_audio_chain():
    # Keyer 'E' through the audio chain produces a 700 Hz burst.
    rate, n = 48000.0, 4096
    speed = Speed.from_paris_wpm(16.0)
    keyer = Keyer(n, rate, speed, message="EEE")
    t_chunks = 10
    env = keyer.envelope(t_chunks)[:, None, :]  # [T, 1, n]
    sig = StreamSig(1, n, rate)
    ys, _ = run_chain(morse_audio_chain(), sig, env)
    out = ys[:, 0, :].reshape(-1)
    # During a dit the output is a 700 Hz tone at amplitude ~0.5.
    # Dit at 16 wpm = 3600 samples starting after 3.5 dits padding; the
    # filter adds its linear-phase group delay (n/2 = 2048) and the slew
    # limiter a ~480-sample rise.
    start = int(3.5 * 3600) + 2048 + 600
    seg = out[start: start + 2000]
    assert np.abs(seg).mean() > 0.4
    steps = np.angle(seg[1:] * np.conj(seg[:-1]))
    np.testing.assert_allclose(steps.mean(), 2 * np.pi * 700.0 / rate,
                               atol=1e-3)
    # During silence (before keying), output is ~0.
    quiet = out[4096 + 100: 4096 + 1000]
    assert np.abs(quiet).max() < 1e-3


def test_bandwidth_meter_chain():
    # A carrier at +10 kHz inside the analysis band measures a narrow
    # bandwidth; the chain output rate is 102.4 kHz.
    rate, n = 1024000.0, 10240  # -> 1024-sample analysis chunks at 102.4 k
    t_chunks = 8
    t = np.arange(t_chunks * n) / rate
    iq = np.exp(2j * np.pi * 10000.0 * t).astype(np.complex64)
    chunks = iq.reshape(t_chunks, 1, n)
    chain = bandwidth_meter_chain(max_bandwidth=50000.0, quality=4)
    sig = StreamSig(1, n, rate)
    ys, bound = run_chain(chain, sig, chunks)
    assert bound.out_sig.sample_rate == 102400.0
    # Analysis chunks: 8192/10 per chunk... (1024000/102400 = 10).
    spectra = ys[bound.blocks[-2].valid_from + 2:, 0, :]
    bws = np.asarray(measure_bandwidth(jnp.asarray(spectra), 102400.0))
    # Occupied bandwidth of a clean carrier is a small fraction of the band.
    assert np.all(bws < 5000.0)
    assert np.all(bws > 0.0)


def test_wfm_fused_deemphasis_matches_unfused():
    # Folding the deemphasis filter into the final decimator is an exact
    # LTI composition: outputs match the literal chain sample-for-sample
    # (past the overlap-save warmup chunk).
    t_chunks = 4
    iq, _ = synth_wfm_iq(1000.0, t_chunks)
    sig = StreamSig(1, WFM_INPUT_CHUNK, WFM_INPUT_RATE)
    ys_ref, _ = run_chain(wfm_receiver(fuse_deemphasis=False), sig, iq)
    ys_fused, _ = run_chain(wfm_receiver(fuse_deemphasis=True), sig, iq)
    np.testing.assert_allclose(ys_fused[1:], ys_ref[1:], atol=2e-4)


def test_real_pair_packing_matches_generic():
    # The real-stream pair-packing filter path is exact: force the hint
    # off and compare.
    t_chunks = 3
    iq1, _ = synth_wfm_iq(900.0, t_chunks)
    iq2, _ = synth_wfm_iq(2100.0, t_chunks)
    iq = np.concatenate([iq1, iq2], axis=1)
    sig = StreamSig(2, WFM_INPUT_CHUNK, WFM_INPUT_RATE)
    ys_opt, b_opt = run_chain(wfm_receiver(), sig, iq)
    chain = wfm_receiver()
    b = chain.bind(sig)
    for blk in b.blocks:
        blk.input_is_real = False  # disable realness optimizations
    state, ys = scan(b, b.params, b.init_state(), jnp.asarray(iq))
    np.testing.assert_allclose(ys_opt, np.asarray(ys), atol=1e-5)


def test_wfm_tx_rx_roundtrip():
    """wfm_transmitter -> wfm_receiver recovers the audio tone: TX
    preemphasis cancels RX deemphasis, FmMod/FmDemod invert, and the
    resamplers return to 48 kHz."""
    from radiorust_tpu.models.wfm import (WFM_AUDIO_CHUNK, WFM_AUDIO_RATE,
                                          wfm_transmitter)

    t_chunks = 8
    n = WFM_AUDIO_CHUNK
    t = np.arange(t_chunks * n) / WFM_AUDIO_RATE
    amp = 0.3
    audio = amp * np.sin(2 * np.pi * 1000.0 * t)
    chunks = (audio.astype(np.complex64)).reshape(t_chunks, 1, n)

    sig = StreamSig(1, n, WFM_AUDIO_RATE)
    iq, tx = run_chain(wfm_transmitter(), sig, chunks)
    assert tx.out_sig.sample_rate == WFM_INPUT_RATE
    assert tx.out_sig.chunk_len == WFM_INPUT_CHUNK
    # FM has constant envelope (steady state; FmMod output is e^{j.phase}).
    env = np.abs(iq[2:, 0, :])
    np.testing.assert_allclose(env, 1.0, atol=1e-3)

    ys, rx = run_chain(wfm_receiver(), StreamSig(1, WFM_INPUT_CHUNK,
                                                 WFM_INPUT_RATE), iq)
    out = ys[:, 0, :].reshape(-1).real
    settled = out[3 * n:]
    win = np.hanning(len(settled))
    spec = np.abs(np.fft.rfft(settled * win))
    freqs = np.fft.rfftfreq(len(settled), 1 / WFM_AUDIO_RATE)
    peak = freqs[np.argmax(spec)]
    assert abs(peak - 1000.0) < 30.0, f"peak at {peak} Hz"
    # The tone dominates everything else by > 20 dB (spectral purity of
    # the whole TX->RX path).
    mask = np.abs(freqs - 1000.0) > 100.0
    assert spec[mask].max() < 0.1 * spec.max()
    # Amplitude survives within resampler passband-gain factors.
    tone_amp = 2 * np.abs(np.fft.rfft(settled * win))[np.argmax(spec)] \
        / np.sum(win)
    assert 0.05 < tone_amp / amp < 20.0, tone_amp


def test_wfm_receiver_graph_audio_and_spectrum():
    """The DAG model's audio output equals the linear chain's, and the
    spectrum tap puts its energy peak at the (shifted) carrier bin."""
    from radiorust_tpu.blocks.graph import graph_scan
    from radiorust_tpu.models.wfm import wfm_receiver_graph

    t_chunks = 4
    iq, _ = synth_wfm_iq(1000.0, t_chunks)
    sig = StreamSig(1, WFM_INPUT_CHUNK, WFM_INPUT_RATE)
    bg = wfm_receiver_graph().bind(sig)
    assert bg.out_sigs["audio"].sample_rate == 48000.0
    assert bg.out_sigs["spectrum"].chunk_len == 4 * 6144
    _, ys = graph_scan(bg, bg.params, bg.init_state(),
                       {"iq": jnp.asarray(iq)})
    want, _ = run_chain(wfm_receiver(), sig, iq)
    np.testing.assert_allclose(np.asarray(ys["audio"]), want, atol=5e-4)
    # Steady-state spectrum: an FM carrier centered at DC spreads around
    # bin 0; energy in the +-150 kHz band dominates the out-of-band tail.
    spec = np.abs(np.asarray(ys["spectrum"])[-1, 0]) ** 2
    n = spec.shape[-1]
    freqs = np.fft.fftfreq(n, 1.0 / 384000.0)
    inband = spec[np.abs(freqs) <= 150000.0].sum()
    outband = spec[np.abs(freqs) > 150000.0].sum()
    assert inband > 50.0 * outband
