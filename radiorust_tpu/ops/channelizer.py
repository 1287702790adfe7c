"""Polyphase filterbank channelizer.

The reference has no channelizer block — the analogous workload in its
world is N parallel (FreqShifter -> Downsampler) chains, one per channel
(cf. BASELINE.json config 5: "64-channel polyphase channelizer").  This
design replaces N mixer+decimator chains with one critically sampled
polyphase filterbank: a depthwise branch FIR followed by an M-point DFT
across branches — O(K + M) work per input sample for M channels (a dense
DFT; an FFT across branches would make it O(K + log M)) instead of
O(M * taps).

Channel ``c`` is centered at ``+c * rate / M`` (wrapping, numpy FFT bin
convention) and decimated to ``rate / M``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from radiorust_tpu import config

from ..math import sinc
from ..windowing import Kaiser

__all__ = ["design_prototype", "pfb_channelize", "branch_fir",
           "dft_channels"]


def design_prototype(num_channels: int, taps_per_branch: int,
                     kaiser_null_bins: float = 1.3) -> np.ndarray:
    """Windowed-sinc prototype low-pass for an M-channel filterbank.

    Length ``M * K`` taps, cutoff at half a channel spacing, Kaiser
    windowed, normalized to unit DC gain per branch sum (a tone at a
    channel center comes out at its input amplitude scaled by M from the
    branch DFT — we fold the 1/M in here so channel outputs preserve
    amplitude).
    """
    m, k = num_channels, taps_per_branch
    n = m * k
    window = Kaiser.with_null_at_bin(kaiser_null_bins * k)
    x = (np.arange(n, dtype=np.float64) + 0.5) - n / 2.0
    h = sinc(x / m) * window.relative_value_at(x * 2.0 / n)
    # Unit gain at a channel center: sum over all taps equals M * (branch
    # DC gain); normalize so the final FFT-of-branches yields amplitude 1.
    return (h / np.sum(h)).astype(np.float64)


@functools.lru_cache(maxsize=16)
def _dft_planes(m: int):
    w = np.exp(-2j * np.pi * np.outer(np.arange(m), np.arange(m)) / m)
    return (w.real.astype(np.float32), w.imag.astype(np.float32))


def branch_fir(fr: jax.Array, fi: jax.Array, taps: jax.Array,
               t_out: int):
    """K-tap polyphase branch FIR as K shifted fused multiply-adds.

    ``fr/fi``: [b, T+K-1, branches] frame planes; ``taps``: [K, branches].
    Returns (vr, vi) [b, t_out, branches].  Shared by the single-device
    PFB and the channel-sharded branch groups
    (``parallel/channel_shard.py``) so the two paths cannot diverge
    numerically."""
    k = taps.shape[0]
    b, _, m = fr.shape
    vr = jnp.zeros((b, t_out, m), jnp.float32)
    vi = jnp.zeros((b, t_out, m), jnp.float32)
    for j in range(k):
        tj = taps[j][None, None, :].astype(jnp.float32)
        vr = vr + fr[:, j: j + t_out, :] * tj
        vi = vi + fi[:, j: j + t_out, :] * tj
    return vr, vi


def dft_channels(vr: jax.Array, vi: jax.Array, dr: jax.Array,
                 di: jax.Array) -> jax.Array:
    """Branch DFT as a 4-mul complex matmul.

    ``vr/vi``: [b, T, M] branch-value planes; ``dr/di``: [M, C] DFT
    column planes (C = all M channels, or one device's channel group).
    Returns complex [b, T, C]."""
    kw = dict(preferred_element_type=jnp.float32,
              precision=config.matmul_precision())
    yr = (jnp.einsum("btm,mc->btc", vr, dr, **kw)
          - jnp.einsum("btm,mc->btc", vi, di, **kw))
    yi = (jnp.einsum("btm,mc->btc", vr, di, **kw)
          + jnp.einsum("btm,mc->btc", vi, dr, **kw))
    return jax.lax.complex(yr, yi)


def pfb_channelize(xp: jax.Array, taps: jax.Array,
                   num_channels: int) -> jax.Array:
    """Critically sampled analysis filterbank.

    ``xp``: [batch, hist + n] complex64 with ``hist = (K-1) * M`` history
    samples prepended (n divisible by M).
    ``taps``: [K, M] float32 — prototype reshaped so ``taps[k, m] =
    h[k*M + m]``.
    Returns [batch, M, n/M] complex64: per-channel decimated streams.

    The K-tap branch FIR is K shifted fused multiply-adds (elementwise
    work XLA fuses), and the M-point branch DFT is a dense complex matmul
    at the configured precision.
    """
    b = xp.shape[0]
    k, m = taps.shape
    total = xp.shape[-1]
    t_out = total // m - (k - 1)
    frames = xp.reshape(b, total // m, m)            # [b, T+K-1, M]
    fr = jnp.real(frames).astype(jnp.float32)
    fi = jnp.imag(frames).astype(jnp.float32)
    # Branch FIR: v[b, t, m] = sum_k frames[b, t+k, m] * taps[k, m] —
    # K shifted elementwise FMAs (K is small, typically 4-16).
    vr, vi = branch_fir(fr, fi, taps, t_out)
    # DFT across branches -> channels (numpy bin convention) as a complex
    # matmul: Y[.., c] = sum_m V[.., m] * W[m, c].
    dr, di = _dft_planes(m)
    y = dft_channels(vr, vi, jnp.asarray(dr), jnp.asarray(di))  # [b, T, M]
    return jnp.swapaxes(y, 1, 2).astype(jnp.complex64)  # [b, M, T]
