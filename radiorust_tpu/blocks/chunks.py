"""Chunk reorganization: overlapping and (bulk) rechunking.

XLA equivalents of the reference's ``src/blocks/chunks.rs``:

- :class:`Overlapper` — concatenate the last ``chunk_count`` chunks into one
  overlapping analysis window per step (``src/blocks/chunks.rs:180-242``).
  The reference emits nothing until ``chunk_count`` chunks arrived; a fixed
  -shape dataflow emits every step with zero-padded history, and
  ``valid_from`` tells bulk consumers which outputs match the reference.
- :func:`rechunk` — bulk reshape of stacked chunks to a new chunk length
  (the compiled-path analog of the streaming ``Rechunker``,
  ``src/blocks/chunks.rs:42-177``; the dynamic streaming variant lives in
  :mod:`radiorust_tpu.runtime`).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .base import Block, BoundBlock, StreamSig

__all__ = ["Overlapper", "rechunk"]


class _BoundOverlapper(BoundBlock):
    def __init__(self, sig: StreamSig, chunk_count: int):
        self.in_sig = sig
        self.chunk_count = chunk_count
        self.out_sig = StreamSig(sig.batch, sig.chunk_len * chunk_count,
                                 sig.sample_rate)
        self.params = ()
        #: Output step index from which outputs match the reference's
        #: emissions (earlier steps include zero-padded history).
        self.valid_from = chunk_count - 1

    def init_state(self):
        sig = self.in_sig
        k = self.chunk_count
        from ..numbers import stream_complex
        return {"hist": np.zeros((sig.batch, k - 1, sig.chunk_len),
                                 stream_complex())}

    def process(self, params, state, x, reset):
        # The reference clears history on any event
        # (src/blocks/chunks.rs:226-233).
        hist = jnp.where(reset[:, None, None],
                         jnp.zeros_like(state["hist"]), state["hist"])
        y = jnp.concatenate(
            [hist.reshape(x.shape[0], -1), x], axis=-1)
        if self.chunk_count > 1:
            new_hist = jnp.concatenate([hist[:, 1:], x[:, None, :]], axis=1)
        else:
            new_hist = hist
        return {"hist": new_hist}, y


class Overlapper(Block):
    """Concatenate successive chunks into overlapping windows
    (``src/blocks/chunks.rs:180-242``)."""

    def __init__(self, chunk_count: int):
        if chunk_count <= 0:
            raise ValueError("chunk count must be positive")
        self.chunk_count = int(chunk_count)

    def bind(self, sig: StreamSig) -> _BoundOverlapper:
        return _BoundOverlapper(sig, self.chunk_count)


def rechunk(xs, new_len: int):
    """Bulk rechunker: [T, batch, n] -> [T', batch, new_len].

    Requires T*n to be divisible by new_len.  This is the compiled-path
    analog of the reference's streaming ``Rechunker``
    (``src/blocks/chunks.rs:42-177``) for whole recorded batches.
    """
    t, b, n = xs.shape
    total = t * n
    if total % new_len:
        raise ValueError(f"cannot rechunk {t}x{n} samples into {new_len}")
    # [T, b, n] -> [b, T*n] -> [b, T', new_len] -> [T', b, new_len]
    flat = jnp.swapaxes(xs, 0, 1).reshape(b, total)
    out = flat.reshape(b, total // new_len, new_len)
    return jnp.swapaxes(out, 0, 1)
