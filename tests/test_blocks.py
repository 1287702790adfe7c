"""Block tests: golden values from the reference's unit tests plus
oracle equivalence for the vectorized XLA formulations."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radiorust_tpu.blocks.base import Chain, StreamSig, scan
from radiorust_tpu.blocks.analysis import Fourier
from radiorust_tpu.blocks.filters import (Filter, SlewRateLimiter,
                                          deemphasis_factor)
from radiorust_tpu.blocks.modulation import FmDemod, FmMod
from radiorust_tpu.blocks.transform import FreqShifter, GainControl, MapSample
from radiorust_tpu.windowing import Kaiser

import oracles


def sig(batch=1, chunk_len=8, rate=48000.0):
    return StreamSig(batch, chunk_len, rate)


def run_chunks(bound, chunks, params=None, resets=None):
    """Feed a [T, chunk] single-stream series through a bound block."""
    xs = jnp.asarray(np.asarray(chunks, np.complex64)[:, None, :])
    state, ys = scan(bound, params if params is not None else bound.params,
                     bound.init_state(), xs, resets)
    return np.asarray(ys)[:, 0, :], state


# ---------------------------------------------------------------------------
# GainControl (golden: src/blocks/transform.rs:396-416)
# ---------------------------------------------------------------------------

def test_gain_control_golden():
    b = GainControl(0.25).bind(sig(chunk_len=2))
    ys, _ = run_chunks(b, [[32.0 - 1.0j, 15.0 - 2.0j]])
    np.testing.assert_array_equal(ys[0], [8.0 - 0.25j, 3.75 - 0.5j])


def test_gain_control_retune_without_rebind():
    b = GainControl(1.0).bind(sig(chunk_len=4))
    x = np.arange(4).astype(np.complex64)
    ys, _ = run_chunks(b, [x], params=jnp.float32(2.0))
    np.testing.assert_array_equal(ys[0], 2.0 * x)


def test_map_sample():
    b = MapSample(lambda x: x / 2.0).bind(sig(chunk_len=4))
    x = np.arange(4).astype(np.complex64)
    ys, _ = run_chunks(b, [x])
    np.testing.assert_array_equal(ys[0], x / 2.0)


def test_map_sample_real_output_enforced():
    # real_output=True is enforced, not trusted: a fn that violates the
    # promise gets its imaginary plane truncated on EVERY path, so
    # downstream pair-packed realness optimizations can't silently see
    # different data than the unoptimized path.
    b = MapSample(lambda x: x * (1.0 + 1.0j), real_output=True).bind(
        sig(chunk_len=4))
    x = (np.arange(4) + 1.0).astype(np.complex64)
    ys, _ = run_chunks(b, [x])
    np.testing.assert_allclose(np.asarray(ys[0]), (x * (1 + 1j)).real,
                               atol=1e-6)
    assert float(np.abs(np.asarray(ys[0]).imag).max()) == 0.0


# ---------------------------------------------------------------------------
# Fourier (golden: src/blocks/analysis.rs:139-209)
# ---------------------------------------------------------------------------

def test_fourier_golden_3pt():
    x = np.array([1.0, 1.0, 1.0], np.complex64)
    b1 = Fourier().bind(sig(chunk_len=3))
    b2 = Fourier.new_center_dc().bind(sig(chunk_len=3))
    y1, _ = run_chunks(b1, [x])
    y2, _ = run_chunks(b2, [x])
    np.testing.assert_allclose(y1[0], [3, 0, 0], atol=1e-5)
    np.testing.assert_allclose(y2[0], [0, 3, 0], atol=1e-5)


def test_fourier_golden_4pt():
    x = np.array([1.0, 1.5, 1.0, 0.5], np.complex64)
    b1 = Fourier().bind(sig(chunk_len=4))
    b2 = Fourier.new_center_dc().bind(sig(chunk_len=4))
    y1, _ = run_chunks(b1, [x])
    y2, _ = run_chunks(b2, [x])
    np.testing.assert_allclose(y1[0], [4, -1j, 0, 1j], atol=1e-5)
    np.testing.assert_allclose(y2[0], [0, 1j, 4, -1j], atol=1e-5)


def test_fourier_window_energy():
    # Windowed FFT of white-ish input preserves total energy on average;
    # simple sanity: window values satisfy sum(w^2) = n.
    b = Fourier.with_window(Kaiser.with_beta(5.0)).bind(sig(chunk_len=64))
    w = np.asarray(b.window_values)
    np.testing.assert_allclose(np.sum(w * w), 64.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# FreqShifter vs oracle
# ---------------------------------------------------------------------------

def test_freq_shifter_matches_oracle():
    rng = np.random.default_rng(1)
    rate, shift, n = 1000.0, 123.0, 50
    chunks = (rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
              ).astype(np.complex64)
    b = FreqShifter.with_shift(shift).bind(sig(chunk_len=n, rate=rate))
    ys, _ = run_chunks(b, chunks)
    want, _ = oracles.oracle_freq_shift(chunks.reshape(-1), rate, shift)
    np.testing.assert_allclose(ys.reshape(-1), want, atol=2e-5)


def test_freq_shifter_zero_drift():
    # After denom samples the phase index must return exactly to start.
    rate, shift, n = 100.0, 7.0, 20
    b = FreqShifter.with_shift(shift).bind(sig(chunk_len=n, rate=rate))
    chunks = np.ones((10, n), np.complex64)  # 200 samples = 2*denom
    ys, state = run_chunks(b, chunks)
    assert int(np.asarray(state["k0"])[0]) == 0
    np.testing.assert_allclose(ys[0], ys[5], atol=1e-6)


def test_freq_shifter_retune_phase_continuous():
    rate, n = 1000.0, 40
    b = FreqShifter.with_shift(100.0).bind(sig(chunk_len=n, rate=rate))
    x = np.ones((1, n), np.complex64)
    state = b.init_state()
    state, y1 = b(jnp.asarray(x), state=state)
    params2, state2 = b.retune(b.params, state, 250.0)
    state2, y2 = b.process(params2, state2, jnp.asarray(x),
                           jnp.zeros((1,), bool))
    # Phase continuity (src/blocks/transform.rs:322-328): the first sample
    # after a retune lands on the phase the old oscillator was about to
    # produce; subsequent samples advance with the new frequency step.
    last = np.angle(np.asarray(y1)[0, -1])
    first = np.angle(np.asarray(y2)[0, 0])
    old_step = 2 * np.pi * 100.0 / rate
    new_step = 2 * np.pi * 250.0 / rate
    assert abs((first - last - old_step + np.pi) % (2 * np.pi) - np.pi) < 1e-3
    deltas = np.angle(np.asarray(y2)[0, 1:] * np.conj(np.asarray(y2)[0, :-1]))
    np.testing.assert_allclose(deltas, new_step, atol=1e-3)


# ---------------------------------------------------------------------------
# FM mod/demod vs oracle
# ---------------------------------------------------------------------------

def test_fm_mod_matches_oracle():
    rng = np.random.default_rng(2)
    rate, dev, n = 48000.0, 5000.0, 64
    chunks = rng.standard_normal((3, n)).astype(np.complex64)
    b = FmMod(dev).bind(sig(chunk_len=n, rate=rate))
    ys, _ = run_chunks(b, chunks)
    want, _ = oracles.oracle_fm_mod(chunks.reshape(-1), rate, dev)
    np.testing.assert_allclose(ys.reshape(-1), want, atol=1e-3)


def test_fm_demod_matches_oracle():
    rng = np.random.default_rng(3)
    rate, dev, n = 48000.0, 5000.0, 64
    x = (rng.standard_normal(3 * n) + 1j * rng.standard_normal(3 * n))
    x = x.astype(np.complex64)
    chunks = x.reshape(3, n)
    b = FmDemod(dev).bind(sig(chunk_len=n, rate=rate))
    ys, _ = run_chunks(b, chunks)
    want, _, _ = oracles.oracle_fm_demod(x, rate, dev)
    np.testing.assert_allclose(ys.reshape(-1).real, want.real, atol=1e-4)
    np.testing.assert_allclose(ys.reshape(-1).imag, 0.0, atol=1e-6)


def test_fm_roundtrip():
    # Modulate a tone, demodulate, recover the tone (mid-stream).
    rate, dev, n = 48000.0, 75000.0 / 10, 256
    t = np.arange(4 * n) / rate
    audio = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    chunks = audio.reshape(4, n).astype(np.complex64)
    s = sig(chunk_len=n, rate=rate)
    mod = FmMod(dev).bind(s)
    dem = FmDemod(dev).bind(s)
    ys, _ = run_chunks(mod, chunks)
    zs, _ = run_chunks(dem, ys)
    got = np.asarray(zs).reshape(-1).real
    np.testing.assert_allclose(got[1:], audio[1:], atol=2e-3)


def test_fm_demod_reset_on_interrupt():
    rate, dev, n = 48000.0, 5000.0, 16
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
         ).astype(np.complex64)
    b = FmDemod(dev).bind(sig(chunk_len=n, rate=rate))
    resets = jnp.asarray(np.array([[False], [True]]))
    ys, _ = run_chunks(b, x, resets=resets)
    # After the interrupt, the first output repeats the last emitted value
    # instead of differencing across the break.
    assert ys[1][0] == ys[0][-1]


# ---------------------------------------------------------------------------
# SlewRateLimiter vs oracle
# ---------------------------------------------------------------------------

def test_slew_rate_limiter_matches_oracle():
    rng = np.random.default_rng(5)
    rate, slew, n = 1000.0, 500.0, 32
    x = (rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n)
         ).astype(np.complex64)
    b = SlewRateLimiter(slew).bind(sig(chunk_len=n, rate=rate))
    ys, _ = run_chunks(b, x.reshape(2, n))
    want, _ = oracles.oracle_slew_rate_limiter(x, rate, slew)
    np.testing.assert_allclose(ys.reshape(-1), want, atol=1e-5)


def test_chain_flattens_nested_chains():
    # Composing a block with a prebuilt model chain yields a flat block
    # list, so per-block machinery (setters, shard handlers, checkpoints)
    # sees the constituents.
    inner = Chain(GainControl(2.0), FreqShifter.with_shift(100.0))
    outer = Chain(MapSample(lambda x: x), inner, GainControl(0.5))
    assert len(outer.specs) == 4
    assert not any(isinstance(s, Chain) for s in outer.specs)


# ---------------------------------------------------------------------------
# Squelch vs oracle
# ---------------------------------------------------------------------------

def test_squelch_matches_oracle():
    from radiorust_tpu.blocks.transform import Squelch
    rng = np.random.default_rng(12)
    n = 64
    # Alternate loud and quiet stretches so the gate toggles mid-stream.
    loud = (rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n))
    quiet = 1e-3 * (rng.standard_normal(2 * n)
                    + 1j * rng.standard_normal(2 * n))
    x = np.concatenate([loud, quiet]).astype(np.complex64)
    b = Squelch(threshold=1e-2, alpha=0.9).bind(sig(chunk_len=n))
    ys, state = run_chunks(b, x.reshape(4, n))
    want, env = oracles.oracle_squelch(x, 1e-2, 0.9)
    np.testing.assert_allclose(ys.reshape(-1), want, atol=1e-5)
    np.testing.assert_allclose(np.asarray(state["env"])[0], env, rtol=1e-4)


def test_squelch_gates_noise_floor():
    from radiorust_tpu.blocks.transform import Squelch
    n = 128
    t = np.arange(4 * n)
    carrier = np.where((t >= n) & (t < 3 * n), 1.0, 0.0)
    x = (carrier * np.exp(2j * np.pi * 0.05 * t)
         + 1e-4 * np.cos(0.3 * t)).astype(np.complex64)
    b = Squelch(threshold=1e-2, alpha=0.9).bind(sig(chunk_len=n))
    ys, _ = run_chunks(b, x.reshape(4, n))
    out = np.abs(ys.reshape(-1))
    assert out[:n].max() == 0.0              # noise floor muted
    assert out[n + 64:3 * n].min() > 0.9     # carrier passes once converged
    assert out[3 * n + 64:].max() == 0.0     # muted again after carrier drop


def test_squelch_reset_closes_gate():
    from radiorust_tpu.blocks.transform import Squelch
    n = 32
    x = np.ones(2 * n, np.complex64)
    b = Squelch(threshold=0.5, alpha=0.5).bind(sig(chunk_len=n))
    resets = jnp.asarray(np.array([[False], [True]]))
    ys, _ = run_chunks(b, x.reshape(2, n), resets=resets)
    # After the interrupt the envelope restarts from zero: the first
    # post-reset sample sits below threshold again.
    assert np.abs(ys[1, 0]) == 0.0
    assert np.abs(ys[1, -1]) > 0.9


# ---------------------------------------------------------------------------
# AgcControl vs oracle
# ---------------------------------------------------------------------------

def test_agc_matches_oracle():
    from radiorust_tpu.blocks.transform import AgcControl
    rng = np.random.default_rng(11)
    n = 64
    x = (0.2 * (rng.standard_normal(4 * n) + 1j * rng.standard_normal(4 * n))
         ).astype(np.complex64)
    b = AgcControl(reference=1.0, rate=5e-3, max_gain=100.0).bind(
        sig(chunk_len=n))
    ys, state = run_chunks(b, x.reshape(4, n))
    want, g = oracles.oracle_agc(x, 1.0, 5e-3, 100.0)
    np.testing.assert_allclose(ys.reshape(-1), want, atol=2e-4)
    # The carried loop gain matches the per-sample oracle too.
    np.testing.assert_allclose(np.asarray(state["gain"])[0], g, atol=2e-3)


def test_agc_converges_and_holds_level():
    from radiorust_tpu.blocks.transform import AgcControl
    n, steps = 256, 12
    t = np.arange(steps * n)
    # A weak tone whose amplitude drops midway: the loop re-converges.
    amp = np.where(t < steps * n // 2, 0.05, 0.04)
    x = (amp * np.exp(2j * np.pi * 0.01 * t)).astype(np.complex64)
    b = AgcControl(reference=1.0, rate=1e-1).bind(sig(chunk_len=n))
    ys, _ = run_chunks(b, x.reshape(steps, n))
    out = np.abs(ys.reshape(-1))
    # Settled windows before and after the level step both sit at the
    # reference envelope.
    assert abs(out[steps * n // 2 - n:steps * n // 2].mean() - 1.0) < 0.05
    assert abs(out[-n:].mean() - 1.0) < 0.05


def test_agc_realness_and_reset_keep_gain():
    from radiorust_tpu.blocks.transform import AgcControl
    b = AgcControl().bind(sig(chunk_len=16))
    b.input_is_real = True
    assert b.output_is_real
    n = 16
    x = (0.1 * np.ones(2 * n)).astype(np.complex64)
    resets = jnp.asarray(np.array([[False], [True]]))
    ys, state = run_chunks(b, x.reshape(2, n), resets=resets)
    # Gain is receiver tuning state: a stream discontinuity does not
    # re-seed it (chunk 2 starts from chunk 1's adapted gain).
    assert np.abs(ys[1, 0]) > np.abs(ys[0, 0])


# ---------------------------------------------------------------------------
# Filter vs oracle
# ---------------------------------------------------------------------------

def lowpass(cut):
    def resp(bins, freqs):
        return np.where(np.abs(freqs) <= cut, 1.0 + 0.0j, 0.0j)
    return resp


def test_filter_matches_oracle():
    rng = np.random.default_rng(6)
    rate, n = 48000.0, 64
    chunks = (rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
              ).astype(np.complex64)
    b = Filter.new(lowpass(8000.0)).bind(sig(chunk_len=n, rate=rate))
    ys, _ = run_chunks(b, chunks)

    def scalar_resp(bin_idx, freq):
        return 1.0 + 0.0j if abs(freq) <= 8000.0 else 0.0j

    want = oracles.oracle_filter_chunks(
        list(chunks), rate, scalar_resp, Kaiser.with_null_at_bin(2.0))
    # Reference emits from the second chunk; ours emits a zero-primed first
    # chunk then identical values.
    for k in range(1, 4):
        np.testing.assert_allclose(ys[k], want[k - 1], atol=2e-4)


@pytest.mark.parametrize("n", [1023, 4095])
def test_filter_matches_oracle_odd_n(n):
    # Odd chunk lengths run the reference design pipeline unchanged
    # (filters.rs:184-239): the half-swap at :201-203 is well-defined for
    # odd n (block swap of the floor-halves, last element fixed) and the
    # 2n-point overlap-save transform is even regardless.
    rng = np.random.default_rng(11)
    rate = 48000.0
    chunks = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
              ).astype(np.complex64)
    b = Filter.new(lowpass(8000.0)).bind(sig(chunk_len=n, rate=rate))
    ys, _ = run_chunks(b, chunks)

    def scalar_resp(bin_idx, freq):
        return 1.0 + 0.0j if abs(freq) <= 8000.0 else 0.0j

    want = oracles.oracle_filter_chunks(
        list(chunks), rate, scalar_resp, Kaiser.with_null_at_bin(2.0))
    for k in range(1, 3):
        np.testing.assert_allclose(ys[k], want[k - 1], atol=2e-4)


def test_filter_ir_len_decoupled_matches_coupled():
    """Filter(ir_len=m) at a larger chunk computes the same filtering as
    the coupled filter at chunk m: same designed IR, same linear
    convolution, different step geometry."""
    rng = np.random.default_rng(21)
    rate, m, X = 48000.0, 256, 768
    total = 4 * X                     # = 12 coupled chunks
    x = (rng.standard_normal(total)
         + 1j * rng.standard_normal(total)).astype(np.complex64)
    coupled = Filter.new(lowpass(8000.0)).bind(sig(chunk_len=m, rate=rate))
    yc, _ = run_chunks(coupled, x.reshape(-1, m))
    dec = Filter.new(lowpass(8000.0), ir_len=m).bind(
        sig(chunk_len=X, rate=rate))
    assert dec.ir_len == m and dec.init_state()["prev"].shape == (1, m)
    yd, _ = run_chunks(dec, x.reshape(-1, X))
    # Both valid from their own second chunk; compare from sample X on.
    got = yd.reshape(-1)[X:]
    want = yc.reshape(-1)[X:]
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_filter_ir_len_update_params():
    # A live retune under the decoupled geometry redesigns at ir_len and
    # keeps the chunk-padded wire layout (response length stays n + m).
    rate, m, X = 48000.0, 256, 768
    b = Filter.new(lowpass(8000.0), ir_len=m).bind(
        sig(chunk_len=X, rate=rate))
    new = b.update_params(lowpass(4000.0))
    assert new["response"].shape == (X + m,)
    fresh = Filter.new(lowpass(4000.0), ir_len=m).bind(
        sig(chunk_len=X, rate=rate))
    np.testing.assert_allclose(new["response"], fresh.params["response"],
                               atol=1e-6)


def test_filter_ir_len_reset_isolated():
    # A reset under the decoupled geometry clears exactly the m-sample
    # history: chunk k with reset equals a fresh filter's first chunk.
    rng = np.random.default_rng(22)
    rate, m, X = 48000.0, 256, 768
    chunks = (rng.standard_normal((2, X)) + 1j * rng.standard_normal((2, X))
              ).astype(np.complex64)
    b = Filter.new(lowpass(8000.0), ir_len=m).bind(
        sig(chunk_len=X, rate=rate))
    resets = jnp.asarray(np.array([[False], [True]]))
    ys, _ = run_chunks(b, chunks, resets=resets)
    b2 = Filter.new(lowpass(8000.0), ir_len=m).bind(
        sig(chunk_len=X, rate=rate))
    ys2, _ = run_chunks(b2, chunks[1:])
    np.testing.assert_allclose(ys[1], ys2[0], atol=1e-6)


def test_filter_passband_tone():
    rate, n = 48000.0, 256
    freq = 1500.0  # on-bin: 1500/48000*256 = 8
    t = np.arange(4 * n) / rate
    x = np.exp(2j * np.pi * freq * t).astype(np.complex64)
    b = Filter.new(lowpass(6000.0)).bind(sig(chunk_len=n, rate=rate))
    ys, _ = run_chunks(b, x.reshape(4, n))
    got = ys.reshape(-1)[2 * n: 3 * n]
    np.testing.assert_allclose(np.abs(got), 1.0, atol=5e-3)


def test_filter_stopband_tone():
    rate, n = 48000.0, 256
    freq = 18000.0
    t = np.arange(4 * n) / rate
    x = np.exp(2j * np.pi * freq * t).astype(np.complex64)
    b = Filter.new(lowpass(6000.0)).bind(sig(chunk_len=n, rate=rate))
    ys, _ = run_chunks(b, x.reshape(4, n))
    got = ys.reshape(-1)[2 * n: 3 * n]
    assert np.max(np.abs(got)) < 1e-3


def test_filter_reset_on_interrupt():
    rng = np.random.default_rng(7)
    rate, n = 48000.0, 32
    chunks = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
              ).astype(np.complex64)
    b = Filter.new(lowpass(8000.0)).bind(sig(chunk_len=n, rate=rate))
    resets = jnp.asarray(np.array([[False], [True]]))
    ys, _ = run_chunks(b, chunks, resets=resets)
    # With reset, chunk 1 is filtered as if chunk 0 never existed.
    b2 = Filter.new(lowpass(8000.0)).bind(sig(chunk_len=n, rate=rate))
    ys2, _ = run_chunks(b2, chunks[1:])
    np.testing.assert_allclose(ys[1], ys2[0], atol=1e-6)


def test_deemphasis_factor():
    # 1/(1 + j*2*pi*f*tau): at f = 1/(2*pi*tau) the magnitude is 1/sqrt(2).
    tau = 50e-6
    f = 1.0 / (2 * np.pi * tau)
    np.testing.assert_allclose(abs(deemphasis_factor(tau, f)),
                               1 / np.sqrt(2), rtol=1e-12)
    assert deemphasis_factor(tau, 0.0) == 1.0


# ---------------------------------------------------------------------------
# Chain composition
# ---------------------------------------------------------------------------

def test_chain_compose():
    s = sig(chunk_len=16, rate=48000.0)
    chain = Chain(GainControl(2.0), GainControl(0.25)).bind(s)
    x = np.ones((1, 16), np.complex64)
    state, y = chain(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), 0.5)


def test_make_scan_wire_safe():
    from radiorust_tpu.blocks.base import make_scan, pack_wire, unpack_wire
    s = sig(batch=2, chunk_len=16, rate=48000.0)
    bound = Chain(GainControl(0.5), FreqShifter.with_shift(1000.0)).bind(s)
    run = make_scan(bound)
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((3, 2, 16)) + 1j * rng.standard_normal((3, 2, 16))).astype(np.complex64)
    resets = np.zeros((3, 2), bool)
    pstate, pys = run(pack_wire(bound.params), pack_wire(bound.init_state()),
                      pack_wire(jnp.asarray(xs)), resets)
    ys = np.asarray(unpack_wire(jax.tree.map(np.asarray, pys)))
    # Same as the plain scan path.
    from radiorust_tpu.blocks.base import scan as plain_scan
    _, want = plain_scan(bound, bound.params, bound.init_state(), jnp.asarray(xs))
    np.testing.assert_allclose(ys, np.asarray(want), atol=1e-6)


def test_fm_demod_set_deviation_traced():
    """FmDemod deviation retune swaps a traced scalar (no rebind),
    matching semantics of rebinding with the new deviation."""
    import numpy as np
    from radiorust_tpu.blocks.base import StreamSig
    from radiorust_tpu.blocks.modulation import FmDemod

    sig = StreamSig(2, 512, 384000.0)
    b1 = FmDemod(150000.0).bind(sig)
    b2 = FmDemod(75000.0).bind(sig)
    p_retuned = np.float32(sig.sample_rate / 75000.0 / (2 * np.pi))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 512))
         + 1j * rng.standard_normal((2, 512))).astype(np.complex64)
    s1, y1 = b1.process(p_retuned, b1.init_state(), x,
                        np.zeros(2, bool))
    s2, y2 = b2.process(b2.params, b2.init_state(), x, np.zeros(2, bool))
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), atol=1e-6)


def test_map_sample_with_params():
    """Parameterized map: closure params are a traced pytree, retunable
    without rebinding (src/blocks/transform.rs:132-179 closure swap)."""
    from radiorust_tpu.blocks.transform import MapSample

    blk = MapSample.with_params(lambda x, p: x * p["scale"] + p["offset"],
                                {"scale": np.float32(2.0),
                                 "offset": np.float32(1.0)})
    b = blk.bind(sig(chunk_len=8))
    x = (np.arange(8, dtype=np.complex64))[None, :]
    _, y = b.process(b.params, b.init_state(), jnp.asarray(x),
                     np.zeros((1,), bool))
    np.testing.assert_allclose(np.asarray(y), x * 2.0 + 1.0)
    # Same bound block, new params — no rebind.
    _, y2 = b.process({"scale": np.float32(-1.0),
                       "offset": np.float32(0.0)},
                      b.init_state(), jnp.asarray(x), np.zeros((1,), bool))
    np.testing.assert_allclose(np.asarray(y2), -x)


def test_chain_valid_from_is_cumulative():
    """Warmup taint adds up through cascaded zero-primed histories: two
    overlap-save filters taint TWO output chunks (the skip_out=2 used by
    the model/parallel tests)."""
    from radiorust_tpu.blocks.base import Chain, StreamSig
    from radiorust_tpu.blocks.filters import Filter
    from radiorust_tpu.blocks.transform import GainControl

    def lp(bins, freqs):
        return np.where(np.abs(freqs) <= 200.0, 1.0 + 0.0j, 0.0j)

    sig = StreamSig(1, 64, 1000.0)
    assert Chain(Filter.new(lp)).bind(sig).valid_from == 1
    assert Chain(Filter.new(lp), GainControl(1.0),
                 Filter.new(lp)).bind(sig).valid_from == 2


def test_realness_propagates_through_nested_chain():
    """A Chain nested inside another Chain flattens at construction, so
    realness propagates into the (former) inner members exactly as in the
    hand-flattened chain — the pair-packed real-filter path composes
    under nesting."""
    from radiorust_tpu.blocks.base import Chain, StreamSig, scan
    from radiorust_tpu.blocks.filters import Filter
    from radiorust_tpu.blocks.modulation import FmDemod
    from radiorust_tpu.blocks.transform import GainControl

    def lp(bins, freqs):
        return np.where(np.abs(freqs) <= 2000.0, 1.0 + 0.0j, 0.0j)

    inner = Chain(Filter.new(lp), GainControl(0.5))
    nested = Chain(FmDemod(1000.0), inner).bind(StreamSig(2, 64, 8000.0))
    flat = Chain(FmDemod(1000.0), Filter.new(lp),
                 GainControl(0.5)).bind(StreamSig(2, 64, 8000.0))

    assert len(nested.blocks) == 3                       # flattened
    assert nested.blocks[1].input_is_real is True        # the Filter
    assert nested.blocks[1].output_is_real is True
    assert nested.output_is_real is True

    rng = np.random.default_rng(3)
    xs = (rng.standard_normal((3, 2, 64))
          + 1j * rng.standard_normal((3, 2, 64))).astype(np.complex64)
    import jax.numpy as jnp
    _, y_nested = scan(nested, nested.params, nested.init_state(),
                       jnp.asarray(xs))
    _, y_flat = scan(flat, flat.params, flat.init_state(), jnp.asarray(xs))
    np.testing.assert_allclose(np.asarray(y_nested), np.asarray(y_flat),
                               atol=1e-6)


def test_combine_preserves_realness_in_linear_chain():
    """A preserves_real Combine used single-input in a linear chain must
    propagate realness from the scalar ``input_is_real`` attribute (set by
    Chain.bind / the graph's single-upstream path), not only from the
    per-input flags the fan-in path sets."""
    import jax.numpy as jnp
    from radiorust_tpu.blocks.base import Chain, StreamSig
    from radiorust_tpu.blocks.filters import Filter
    from radiorust_tpu.blocks.modulation import FmDemod
    from radiorust_tpu.blocks.transform import Combine

    def lp(bins, freqs):
        return np.where(np.abs(freqs) <= 2000.0, 1.0 + 0.0j, 0.0j)

    bound = Chain(FmDemod(1000.0),
                  Combine(lambda x: 2.0 * x, preserves_real=True),
                  Filter.new(lp)).bind(StreamSig(2, 64, 8000.0))
    assert bound.blocks[1].input_is_real is True
    assert bound.blocks[1].output_is_real is True
    assert bound.blocks[2].input_is_real is True  # the pair-packed path

    # A non-preserving fn must still report complex output.
    bound2 = Chain(FmDemod(1000.0),
                   Combine(lambda x: 1j * x)).bind(StreamSig(2, 64, 8000.0))
    assert bound2.blocks[1].output_is_real is False
