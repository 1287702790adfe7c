"""Sample-rate conversion blocks.

XLA equivalents of the reference's ``src/blocks/resampling.rs``:
arbitrary-(rational-)ratio windowed-sinc resampling, reformulated from the
reference's per-sample ring-buffer loops into a static strided convolution
(see :mod:`radiorust_tpu.ops.polyphase` for the derivation).  The carried
ring buffer becomes a ``hist`` slab of the last taps-worth of input samples.

Unlike the reference blocks (which take an ``output_chunk_len`` and
accumulate), these blocks map one input chunk to one output chunk.  When
the input chunk is a whole number of resampling periods (``chunk_len %
p == 0``) the output chunk is exactly ``chunk_len * q / p`` samples.  ANY
other chunk length also binds (*phase mode*): the output chunk is a fixed
``ceil(chunk_len/p) * q`` samples whose valid prefix follows the
deterministic ``valid_counts`` schedule, with zero padding behind it —
the runtime actor layer trims by the schedule; in a compiled Chain a
phase-mode resampler must be the last block.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops.polyphase import (RationalPlan, plan_downsample, plan_upsample,
                             rational_fir)
from .base import Block, BoundBlock, StreamSig

__all__ = ["Downsampler", "Upsampler"]


class _BoundResampler(BoundBlock):
    @property
    def output_is_real(self):
        return self.input_is_real  # real FIR taps preserve realness

    def __init__(self, sig: StreamSig, plan: RationalPlan,
                 output_rate: float):
        self.in_sig = sig
        self.plan = plan
        # Any chunk length binds: when the chunk is not a whole number of
        # p-periods the step runs in *phase mode* (ops/polyphase.py
        # rational_fir_phase) — fixed ceil(C/p)*q-sample output chunks
        # whose valid prefix follows the host-computable
        # ``valid_counts`` schedule (reference parity:
        # src/blocks/resampling.rs:103-133 resamples any rate pair at any
        # chunking; here the data-dependent output count becomes padding
        # plus a static schedule, the XLA-native shape discipline).
        self.phase_mode = not plan.aligned(sig.chunk_len)
        if self.phase_mode:
            out_len = plan.windows_per_step(sig.chunk_len) * plan.q
            # Downstream compiled blocks cannot consume padded chunks;
            # Chain.bind rejects a ragged block mid-chain.  The runtime
            # actor layer trims by the schedule instead.
            self.ragged_output = True
        else:
            out_len = plan.out_len(sig.chunk_len)
        self.out_sig = StreamSig(sig.batch, out_len, output_rate)
        # Host numpy leaf (framework convention): an eager device array
        # here would force a device->host fetch on every checkpoint save.
        self.params = {"kernel": np.asarray(plan.kernel)}

    def valid_counts(self, k0: int, nsteps: int = 1):
        """Valid output samples in chunks k0..k0+nsteps (every full
        out_len in aligned mode; the periodic phase-mode schedule
        otherwise)."""
        return self.plan.valid_counts(self.in_sig.chunk_len, k0, nsteps)

    # -- host-side schedule mirror (runtime actors trim padded chunks) --
    def schedule_phase(self, state) -> int:
        """Current grid phase from a host-side state tree (checkpoint
        restores land mid-schedule; the phase alone determines it)."""
        return int(np.asarray(state["phase"])[0]) if self.phase_mode else 0

    def advance_schedule(self, phase: int):
        """(valid output samples of the next chunk, next phase) —
        delegates to the schedule's single owner, RationalPlan.advance."""
        return self.plan.advance(phase, self.in_sig.chunk_len)

    def init_state(self):
        # Zero history matches the reference's zero-initialized ring buffer
        # (src/blocks/resampling.rs:99,234).
        from ..numbers import stream_complex
        b = self.in_sig.batch
        if self.phase_mode:
            return {"hist": np.zeros((b, self.plan.phase_hist),
                                     stream_complex()),
                    "phase": np.zeros((b,), np.int32)}
        return {"hist": np.zeros((b, self.plan.hist), stream_complex())}

    def process(self, params, state, x, reset):
        plan = self.plan
        if self.phase_mode:
            from ..ops.polyphase import rational_fir_phase
            y, nh, nph = rational_fir_phase(
                x, state["hist"], state["phase"], params["kernel"],
                plan.p, plan.q, real_input=self.input_is_real)
            # The reference does not reset resampler state on events
            # (src/blocks/resampling.rs:135-137).
            return {"hist": nh, "phase": nph}, y
        if plan.hist:
            xp = jnp.concatenate([state["hist"], x], axis=-1)
            # History may exceed one chunk (long anti-alias FIRs), so carry
            # the tail of the concatenated buffer.
            new_hist = xp[:, -plan.hist:]
        else:
            xp = x
            new_hist = state["hist"]
        y = rational_fir(xp, params["kernel"], plan.p, plan.q, plan.s0,
                         self.out_sig.chunk_len,
                         real_input=self.input_is_real)
        # The reference does not reset resampler state on events
        # (src/blocks/resampling.rs:135-137), so ``reset`` is unused.
        return {"hist": new_hist}, y


class Downsampler(Block):
    """Reduce sample rate (``src/blocks/resampling.rs:14-146``).

    Aliasing is suppressed below ``bandwidth``; ``quality`` >= 1 scales the
    anti-alias FIR length (default 3.0 like ``Downsampler::new``).

    ``prefilter=(freq_resp, window)`` fuses a preceding overlap-save Filter
    into the decimating FIR (exact composition of LTI stages; the filter's
    impulse response is designed at the bound chunk length exactly like a
    standalone :class:`~radiorust_tpu.blocks.filters.Filter`).
    """

    def __init__(self, output_rate: float, bandwidth: float,
                 quality: float = 3.0, prefilter=None):
        self.output_rate = float(output_rate)
        self.bandwidth = float(bandwidth)
        self.quality = float(quality)
        self.prefilter = prefilter

    def bind(self, sig: StreamSig) -> _BoundResampler:
        pre_ir = None
        if self.prefilter is not None:
            from .filters import design_impulse_response
            freq_resp, window = self.prefilter
            pre_ir = design_impulse_response(
                freq_resp, window, sig.chunk_len, sig.sample_rate)
            pre_ir = pre_ir.astype(np.complex64)  # reference f32 cast
        plan = plan_downsample(sig.sample_rate, self.output_rate,
                               self.bandwidth, self.quality,
                               prefilter_ir=pre_ir)
        return _BoundResampler(sig, plan, self.output_rate)


class Upsampler(Block):
    """Increase sample rate (``src/blocks/resampling.rs:149-280``)."""

    def __init__(self, output_rate: float, bandwidth: float,
                 quality: float = 3.0):
        self.output_rate = float(output_rate)
        self.bandwidth = float(bandwidth)
        self.quality = float(quality)

    def bind(self, sig: StreamSig) -> _BoundResampler:
        plan = plan_upsample(sig.sample_rate, self.output_rate,
                             self.bandwidth, self.quality)
        return _BoundResampler(sig, plan, self.output_rate)
