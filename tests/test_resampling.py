"""Resampler tests: rational polyphase conv vs the reference's ring-buffer
loop oracle, across ratio classes (integer, fractional, upsampling)."""

import numpy as np
import pytest

import jax.numpy as jnp

from radiorust_tpu.blocks.base import StreamSig, scan
from radiorust_tpu.blocks.resampling import Downsampler, Upsampler

import oracles


def run(block, chunks, rate):
    n = chunks.shape[1]
    b = block.bind(StreamSig(1, n, rate))
    xs = jnp.asarray(chunks[:, None, :])
    state, ys = scan(b, b.params, b.init_state(), xs)
    return np.asarray(ys)[:, 0, :].reshape(-1), b


def make_input(t, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, n)) + 1j * rng.standard_normal((t, n))
            ).astype(np.complex64)


@pytest.mark.parametrize("in_rate,out_rate,bw,n", [
    (1024.0, 384.0, 200.0, 64),   # 8/3 fractional (WFM first stage, scaled)
    (384.0, 48.0, 40.0, 64),      # 8/1 integer (WFM second stage, scaled)
    (1000.0, 400.0, 150.0, 60),   # 5/2
    (441.0, 147.0, 50.0, 63),     # exact 3x with odd rates
])
def test_downsample_matches_oracle(in_rate, out_rate, bw, n):
    chunks = make_input(3, n, seed=int(in_rate))
    got, b = run(Downsampler(out_rate, bw), chunks, in_rate)
    want = oracles.oracle_downsample(chunks.reshape(-1), in_rate, out_rate, bw)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("in_rate,out_rate,bw,n", [
    (48.0, 384.0, 40.0, 64),      # 1/8 integer upsample
    (384.0, 1024.0, 300.0, 63),   # 3/8 fractional upsample
    (400.0, 1000.0, 350.0, 64),   # 2/5
])
def test_upsample_matches_oracle(in_rate, out_rate, bw, n):
    chunks = make_input(3, n, seed=int(out_rate))
    got, b = run(Upsampler(out_rate, bw), chunks, in_rate)
    want = oracles.oracle_upsample(chunks.reshape(-1), in_rate, out_rate, bw)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_downsample_tone_preserved():
    # A tone inside the bandwidth survives decimation with the gain of the
    # unit-energy prototype FIR (the reference normalizes tap *energy*, not
    # DC gain: src/blocks/resampling.rs:97-98), and its frequency is
    # preserved.
    in_rate, out_rate, bw = 8000.0, 1000.0, 400.0
    f = 125.0
    t = np.arange(8 * 128) / in_rate
    x = np.exp(2j * np.pi * f * t).astype(np.complex64).reshape(8, 128)
    got, b = run(Downsampler(out_rate, bw), x, in_rate)
    from radiorust_tpu.ops.polyphase import design_ir
    ir = design_ir(in_rate, out_rate, (out_rate - bw) / 2.0, 3.0)
    n_ir = np.arange(len(ir))
    expected_gain = abs(np.sum(ir * np.exp(-2j * np.pi * f / in_rate * n_ir)))
    mid = got[len(got) // 2:]
    np.testing.assert_allclose(np.abs(mid), expected_gain, rtol=1e-3)
    # Frequency preserved: phase step per output sample = 2*pi*f/out_rate.
    steps = np.angle(mid[1:] * np.conj(mid[:-1]))
    np.testing.assert_allclose(steps, 2 * np.pi * f / out_rate, atol=1e-2)


def run_ragged(block, chunks, rate):
    """Scan a (possibly phase-mode) resampler and concatenate each output
    chunk's schedule-valid prefix — the gapless stream the runtime actor
    layer emits."""
    n = chunks.shape[1]
    b = block.bind(StreamSig(1, n, rate))
    xs = jnp.asarray(chunks[:, None, :])
    state, ys = scan(b, b.params, b.init_state(), xs)
    ys = np.asarray(ys)[:, 0, :]
    if not getattr(b, "ragged_output", False):
        return ys.reshape(-1), b
    vc = b.valid_counts(0, chunks.shape[0])
    # Padding behind the valid prefix must be exact zeros.
    for k, v in enumerate(vc):
        assert np.all(ys[k, v:] == 0)
    return np.concatenate([ys[k, :v] for k, v in enumerate(vc)]), b


@pytest.mark.parametrize("out_rate", [44100.0, 22050.0, 11025.0])
def test_downsample_any_chunk_audio_rates(out_rate):
    """The arbitrary-chunk contract: the reference's own 1.024 Msps
    input binds to standard audio rates at a power-of-two chunk
    (resampling.rs:103-133 handles any ratio/chunk; here phase mode).
    p = 10240/20480/40960 per 441 — for the lower rates p exceeds the
    chunk, so whole steps emit zero valid samples."""
    in_rate = 1024000.0
    chunks = make_input(6, 16384, seed=int(out_rate))
    b = Downsampler(out_rate, 0.4 * out_rate).bind(
        StreamSig(1, 16384, in_rate))
    assert b.phase_mode and b.ragged_output
    got, _ = run_ragged(Downsampler(out_rate, 0.4 * out_rate), chunks,
                        in_rate)
    want = oracles.oracle_downsample(chunks.reshape(-1), in_rate, out_rate,
                                     0.4 * out_rate)
    assert len(got) <= len(want) and len(got) > 0
    np.testing.assert_allclose(got, want[:len(got)], atol=2e-4)


@pytest.mark.parametrize("n", [60, 100, 7])
def test_downsample_phase_mode_matches_oracle(n):
    # 8/3 ratio at chunk lengths that are not multiples of 8, including
    # a chunk smaller than one period.
    chunks = make_input(8, n, seed=n)
    got, b = run_ragged(Downsampler(384.0, 200.0), chunks, 1024.0)
    assert b.phase_mode
    want = oracles.oracle_downsample(chunks.reshape(-1), 1024.0, 384.0,
                                     200.0)
    np.testing.assert_allclose(got, want[:len(got)], atol=2e-4)


def test_upsample_phase_mode_matches_oracle():
    # 3/8 upsample (p=3) at a chunk length not divisible by 3.
    chunks = make_input(5, 64, seed=5)
    got, b = run_ragged(Upsampler(1024.0, 300.0), chunks, 384.0)
    assert b.phase_mode
    want = oracles.oracle_upsample(chunks.reshape(-1), 384.0, 1024.0, 300.0)
    np.testing.assert_allclose(got, want[:len(got)], atol=2e-4)


def test_phase_mode_equals_aligned_rechunked():
    """The same stream resampled through phase mode (chunk 60) and the
    aligned formulation (chunk 64) must produce the identical output
    stream — the two modes share the window grid exactly."""
    total = 960  # divisible by both 60 and 64
    x = make_input(1, total, seed=9).reshape(-1)
    got_p, bp = run_ragged(Downsampler(384.0, 200.0), x.reshape(-1, 60),
                           1024.0)
    got_a, ba = run_ragged(Downsampler(384.0, 200.0), x.reshape(-1, 64),
                           1024.0)
    assert bp.phase_mode and not ba.phase_mode
    np.testing.assert_allclose(got_p, got_a[:len(got_p)], atol=1e-6)


def test_phase_mode_must_be_last_in_chain():
    from radiorust_tpu.blocks.base import Chain
    from radiorust_tpu.blocks.transform import GainControl
    with pytest.raises(ValueError, match="LAST block"):
        Chain(Downsampler(384.0, 200.0),
              GainControl(0.5)).bind(StreamSig(1, 100, 1024.0))
    # As the last block it binds fine.
    Chain(GainControl(0.5),
          Downsampler(384.0, 200.0)).bind(StreamSig(1, 100, 1024.0))


def test_downsample_output_sig():
    b = Downsampler(384000.0, 200000.0).bind(StreamSig(2, 16384, 1024000.0))
    assert b.out_sig.chunk_len == 6144
    assert b.out_sig.sample_rate == 384000.0
    assert b.out_sig.batch == 2
