"""The slew-rate limiter's GPU kernel (ops/pallas_scan.py), run here in
the Pallas interpreter (``interpret=True``, the only way it runs off the
card): the recurrence against the per-sample oracle, the carry across
calls, stream padding to whole blocks, the unroll remainder, and the
block's choice between the kernel and ``lax.scan``."""

import functools

import numpy as np
import pytest

import jax

import oracles
from radiorust_tpu import backend
from radiorust_tpu.blocks.base import StreamSig
from radiorust_tpu.blocks.filters import SlewRateLimiter
from radiorust_tpu.ops import pallas_scan


def _run(b, x, chunks):
    params, state = b.params, b.init_state()
    outs = []
    reset = np.zeros((x.shape[0],), bool)
    step = jax.jit(b.process)
    for c in np.split(x, chunks, axis=-1):
        state, y = step(params, state, c, reset)
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=-1), state


def _kernel(x, md, prev=None):
    B = x.shape[0]
    prev = np.zeros(B, np.complex64) if prev is None else prev
    return pallas_scan.slew_scan(
        x.real.astype(np.float32), x.imag.astype(np.float32),
        prev.real.astype(np.float32), prev.imag.astype(np.float32),
        np.float32(md), interpret=True)


@pytest.mark.parametrize("B,T", [(5, 256), (32, 64)])
def test_slew_kernel_matches_oracle(B, T):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, T))
         + 1j * rng.standard_normal((B, T))).astype(np.complex64)
    yr, yi, pr, pi = _kernel(x, 0.4)
    for b in range(B):
        want, prev = oracles.oracle_slew_rate_limiter(x[b], 1.0, 0.4)
        got = np.asarray(yr)[b] + 1j * np.asarray(yi)[b]
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(pr)[b] + 1j * np.asarray(pi)[b], prev, atol=1e-5)


def test_slew_kernel_multi_time_tile_carry():
    # A 4096-sample chunk (the morse cells' chunk) run in two calls: the
    # carry handed from the first call to the second must continue the
    # recurrence exactly where one long call would.
    rng = np.random.default_rng(4)
    T = 4096
    x = (rng.standard_normal((1, T))
         + 1j * rng.standard_normal((1, T))).astype(np.complex64)
    yr1, yi1, pr, pi = _kernel(x[:, :T // 2], 0.3)
    prev = (np.asarray(pr) + 1j * np.asarray(pi)).astype(np.complex64)
    yr2, yi2, _, _ = _kernel(x[:, T // 2:], 0.3, prev)
    got = np.concatenate([np.asarray(yr1) + 1j * np.asarray(yi1),
                          np.asarray(yr2) + 1j * np.asarray(yi2)], axis=-1)
    want, _ = oracles.oracle_slew_rate_limiter(x[0], 1.0, 0.3)
    np.testing.assert_allclose(got[0], want, atol=1e-5)


def test_slew_block_pallas_equals_scan_path(monkeypatch):
    # The block on its kernel path (policy forced to the GPU choice, the
    # kernel interpreted) against the lax.scan path it takes on the CPU —
    # same chunked streaming semantics, batch 3 (stream padding exercised).
    rng = np.random.default_rng(5)
    B, T = 3, 512
    x = (rng.standard_normal((B, T))
         + 1j * rng.standard_normal((B, T))).astype(np.complex64)
    sig = StreamSig(B, T // 4, 1000.0)
    y2, s2 = _run(SlewRateLimiter(300.0).bind(sig), x, 4)
    monkeypatch.setattr(backend, "use_kernels", lambda on=None: True)
    monkeypatch.setattr(pallas_scan, "slew_scan", functools.partial(
        pallas_scan.slew_scan, interpret=True))
    y1, s1 = _run(SlewRateLimiter(300.0).bind(sig), x, 4)
    np.testing.assert_allclose(y1, y2, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s1["prev"]),
                               np.asarray(s2["prev"]), atol=1e-5)


def test_slew_block_falls_back_on_unsupported_chunk():
    # No chunk length is unsupported any more, so there is no fallback to
    # take: this checks the unroll remainder instead.  A prime chunk
    # length (2309) leaves a remainder that the tail loop must finish.
    rng = np.random.default_rng(6)
    B, T = 2, 2309
    x = (rng.standard_normal((B, T))
         + 1j * rng.standard_normal((B, T))).astype(np.complex64)
    yr, yi, _, _ = _kernel(x, 0.5)
    for b in range(B):
        want, _ = oracles.oracle_slew_rate_limiter(x[b], 1.0, 0.5)
        np.testing.assert_allclose(np.asarray(yr)[b] + 1j * np.asarray(yi)[b],
                                   want, atol=1e-5)


@pytest.mark.parametrize("batch,want", [(1, 1), (3, 4), (32, 32),
                                        (64, 32), (100, 32)])
def test_block_streams_power_of_two_per_program(batch, want):
    assert pallas_scan.block_streams(batch) == want


def test_slew_block_takes_scan_on_cpu(monkeypatch):
    # On the CPU the policy picks lax.scan: the kernel is never traced.
    def boom(*a, **k):
        raise AssertionError("kernel traced on the CPU")
    monkeypatch.setattr(pallas_scan, "slew_scan", boom)
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 64))
         + 1j * rng.standard_normal((2, 64))).astype(np.complex64)
    y, _ = _run(SlewRateLimiter(200.0).bind(StreamSig(2, 64, 1000.0)), x, 1)
    want, _ = oracles.oracle_slew_rate_limiter(x[1], 1000.0, 200.0)
    np.testing.assert_allclose(y[1], want, atol=1e-5)


def test_agc_block_survives_sustained_overdrive():
    # rate*|x| = 5 every sample: the loop is chaotic (slope -4 per step)
    # and composed slope products grow as 4^n.  Uncapped they overflowed
    # f32 to inf and composed to NaN, permanently poisoning the gain.
    # Contract (AgcControl docstring): finite, inside [0, max_gain].
    from radiorust_tpu.blocks.transform import AgcControl
    B, n = 2, 2048
    x = (10.0 * np.exp(1j * 0.3 * np.arange(B * n)).reshape(B, n)
         ).astype(np.complex64)
    b = AgcControl(reference=1.0, rate=0.5, max_gain=4.0).bind(
        StreamSig(B, n, 1000.0))
    st, y = jax.jit(b.process)(b.params, b.init_state(), x,
                               np.zeros(B, bool))
    y, g = np.asarray(y), np.asarray(st["gain"])
    assert np.isfinite(y).all() and np.isfinite(g).all()
    assert (g >= 0.0).all() and (g <= 4.0).all()
    assert np.abs(y).max() <= 4.0 * 10.0 + 1e-3


def test_agc_block_assoc_scan_clamps_like_oracle():
    # Active clamping at both bounds: the clamped-affine composition must
    # reproduce the sequential trajectory exactly (not just converged
    # steady state).
    from radiorust_tpu.blocks.transform import AgcControl
    rng = np.random.default_rng(8)
    B, T = 2, 256
    amp = np.where((np.arange(T) // 40) % 2 == 0, 0.02, 3.0)
    x = (amp * (rng.standard_normal((B, T))
                + 1j * rng.standard_normal((B, T)))).astype(np.complex64)
    b = AgcControl(reference=1.0, rate=0.3, max_gain=2.5).bind(
        StreamSig(B, T // 2, 1000.0))
    y, s = _run(b, x, 2)
    for bb in range(B):
        want, gw = oracles.oracle_agc(x[bb], 1.0, 0.3, 2.5)
        np.testing.assert_allclose(y[bb], want, atol=3e-4)
    np.testing.assert_allclose(np.asarray(s["gain"])[-1], gw, atol=2e-3)
