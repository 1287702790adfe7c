"""FM modulator and demodulator.

XLA equivalents of the reference's ``src/blocks/modulation.rs``:

- :class:`FmMod` — phase integrator.  The reference's per-sample
  ``phase += re*2*pi*dev/rate`` loop (``src/blocks/modulation.rs:45-52``)
  becomes a parallel prefix sum (``cumsum``) with the end-of-chunk phase as
  scan carry — a data-parallel reformulation with the same f32-class
  rounding behavior.
- :class:`FmDemod` — quadrature demodulation
  ``arg(x[n] * conj(x[n-1])) * rate/(2*pi*dev)``
  (``src/blocks/modulation.rs:116-126``), fully parallel with the previous
  chunk's last sample carried; continuity state drops on interrupt events
  (``src/blocks/modulation.rs:133-136``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import numbers as _nums
from ..numbers import TAU
from .base import Block, BoundBlock, StreamSig

__all__ = ["FmMod", "FmDemod"]


class _BoundFmMod(BoundBlock):
    def __init__(self, sig: StreamSig, deviation: float):
        self.in_sig = self.out_sig = sig
        # factor = deviation / sample_rate * 2*pi, tunable
        # (src/blocks/modulation.rs:45).
        self.params = _nums.stream_real()(
            deviation / sig.sample_rate * TAU)

    def init_state(self):
        return {"phase": np.zeros((self.in_sig.batch,),
                                   _nums.stream_real())}

    def process(self, params, state, x, reset):
        rdt = jnp.real(x).dtype
        increments = x.real.astype(rdt) * params
        theta = state["phase"][:, None] + jnp.cumsum(increments, axis=-1)
        theta = jnp.mod(theta, np.asarray(TAU, rdt))
        y = jax.lax.complex(jnp.cos(theta), jnp.sin(theta))
        # The reference never resets modulator phase on events
        # (src/blocks/modulation.rs:59-61).
        return {"phase": theta[:, -1]}, y


class FmMod(Block):
    """FM modulator with given frequency deviation in hertz
    (``src/blocks/modulation.rs:13-80``)."""

    def __init__(self, deviation: float):
        self.deviation = float(deviation)

    def bind(self, sig: StreamSig) -> _BoundFmMod:
        return _BoundFmMod(sig, self.deviation)


class _BoundFmDemod(BoundBlock):
    @property
    def output_is_real(self):
        # Demodulated audio has zero imaginary part
        # (src/blocks/modulation.rs:120-123).
        return True

    def __init__(self, sig: StreamSig, deviation: float):
        self.in_sig = self.out_sig = sig
        # factor = sample_rate / deviation / 2*pi, tunable
        # (src/blocks/modulation.rs:116).
        self.params = _nums.stream_real()(
            sig.sample_rate / deviation / TAU)

    def init_state(self):
        b = self.in_sig.batch
        return {
            "prev": np.zeros((b,), _nums.stream_complex()),
            "have_prev": np.zeros((b,), bool),
            # The reference keeps emitting the stale output sample for the
            # first sample after a continuity break
            # (src/blocks/modulation.rs:104,119-124).
            "last_out": np.zeros((b,), _nums.stream_real()),
        }

    def process(self, params, state, x, reset):
        have_prev = jnp.where(reset, False, state["have_prev"])
        shifted = jnp.concatenate([state["prev"][:, None], x[:, :-1]], axis=1)
        prod = x * jnp.conj(shifted)
        demod = jnp.arctan2(prod.imag, prod.real) * params
        # Sample 0 uses the carried previous sample only when the stream is
        # continuous; otherwise it repeats the last emitted value.
        first = jnp.where(have_prev, demod[:, 0], state["last_out"])
        y = demod.at[:, 0].set(first)
        new_state = {
            "prev": x[:, -1],
            "have_prev": jnp.ones_like(have_prev),
            "last_out": y[:, -1],
        }
        return new_state, jax.lax.complex(y, jnp.zeros_like(y))


class FmDemod(Block):
    """Quadrature FM demodulator with given deviation in hertz
    (``src/blocks/modulation.rs:83-158``)."""

    def __init__(self, deviation: float):
        self.deviation = float(deviation)

    def bind(self, sig: StreamSig) -> _BoundFmDemod:
        return _BoundFmDemod(sig, self.deviation)
