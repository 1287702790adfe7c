"""Channelizer block: one wideband stream -> M narrowband streams.

No single reference block does this; it replaces M parallel
(FreqShifter -> Downsampler) chains (the reference's way to extract
channels, cf. ``examples/bandwidth_meter/main.rs:54-57``) with one
polyphase FFT filterbank (see :mod:`radiorust_tpu.ops.channelizer`).

The M output channels fold into the batch axis — ``[batch, n]`` becomes
``[batch * M, n / M]`` at ``rate / M`` — so per-channel processing (demod,
metering, audio chains) composes downstream as ordinary batched blocks.
Channel ``c`` of stream ``b`` is row ``b * M + c``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops.channelizer import design_prototype, pfb_channelize
from .base import Block, BoundBlock, StreamSig

__all__ = ["Channelizer"]


class _BoundChannelizer(BoundBlock):
    def __init__(self, sig: StreamSig, m: int, k: int):
        if sig.chunk_len % m:
            raise ValueError(
                f"chunk_len {sig.chunk_len} must be divisible by "
                f"num_channels {m}")
        self.in_sig = sig
        self.m = m
        self.k = k
        self.hist_len = (k - 1) * m
        self.out_sig = StreamSig(sig.batch * m, sig.chunk_len // m,
                                 sig.sample_rate / m)
        proto = design_prototype(m, k)
        # Host numpy leaf (framework convention; see _BoundResampler).
        self.params = {"taps": proto.reshape(k, m).astype(np.float32)}

    def init_state(self):
        return {"hist": np.zeros((self.in_sig.batch, self.hist_len),
                                 np.complex64)}

    def process(self, params, state, x, reset):
        hist = jnp.where(reset[:, None], jnp.zeros_like(state["hist"]),
                         state["hist"])
        xp = jnp.concatenate([hist, x], axis=-1)
        y = pfb_channelize(xp, params["taps"], self.m)   # [b, M, n/M]
        b = x.shape[0]
        y = y.reshape(b * self.m, self.out_sig.chunk_len)
        # Guard hist_len == 0 (K == 1): `[:, -0:]` is the WHOLE array.
        new_hist = xp[:, -self.hist_len:] if self.hist_len else state["hist"]
        return {"hist": new_hist}, y


class Channelizer(Block):
    """Critically sampled M-channel polyphase filterbank."""

    def __init__(self, num_channels: int, taps_per_branch: int = 8):
        self.num_channels = int(num_channels)
        self.taps_per_branch = int(taps_per_branch)

    def bind(self, sig: StreamSig) -> _BoundChannelizer:
        return _BoundChannelizer(sig, self.num_channels,
                                 self.taps_per_branch)
