"""Digital filters: overlap-save fast convolution, slew-rate limiting.

XLA equivalents of the reference's ``src/blocks/filters.rs``.

:class:`Filter` keeps the reference's exact design pipeline
(``src/blocks/filters.rs:184-239``), host-side in float64:

1. sample the user frequency-response closure at every DFT bin of the chunk
   (signed frequencies ``i * rate / n``, conjugate-layout fill),
2. inverse FFT to an impulse response,
3. the reference's half-swap (a block swap of the two floor-halves; equals
   fftshift for even ``n``, leaves the last element fixed for odd ``n``),
4. apply the window (default ``Kaiser.with_null_at_bin(2.0)``) and rescale
   to the pre-window energy,
5. zero-pad to ``2n`` (zeros in the front half) and FFT once.

The device-side hot loop is then one batched ``FFT(2n) * R -> IFFT`` per
chunk with the previous chunk carried as overlap-save state
(``src/blocks/filters.rs:240-259``).  Normalization uses numpy/XLA FFT
conventions; the end-to-end transfer function matches the reference's
unnormalized-rustfft pipeline exactly (the stray 1/(2n^2) factors cancel).

Latency note: the reference emits nothing until the second chunk (1-chunk
latency, ``src/blocks/filters.rs:79-82``).  A fixed-shape dataflow must emit
one chunk per step, so the first output chunk is computed with a zero
previous chunk; outputs from chunk index 1 onward are bit-comparable to the
reference.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import numbers as _nums
from ..numbers import TAU
from ..windowing import Kaiser, Rectangular, Window, window_table
from .base import Block, BoundBlock, StreamSig

__all__ = ["Filter", "FilterBank", "SlewRateLimiter", "deemphasis_factor",
           "extend_response",
           "design_response", "design_impulse_response"]


def deemphasis_factor(tau: float, frequency):
    """Complex gain of a first-order RC deemphasis low-pass
    (``src/blocks/filters.rs:20-27``): ``1 / (1 + j*2*pi*f*tau)``.

    Unity at DC, -3 dB at the corner ``1/(2*pi*tau)`` (the reference's
    doc example composes this into Filter closures,
    ``src/blocks/filters.rs:47-58``):

    >>> complex(deemphasis_factor(50e-6, 0.0))
    (1+0j)
    >>> import numpy as np
    >>> corner = 1.0 / (2.0 * np.pi * 50e-6)
    >>> round(float(abs(deemphasis_factor(50e-6, corner))) ** 2, 9)
    0.5
    """
    frequency = np.asarray(frequency, dtype=np.float64)
    return 1.0 / (1.0 + 1j * (tau * TAU * frequency))


def design_impulse_response(freq_resp: Callable, window: Window, n: int,
                            sample_rate: float) -> np.ndarray:
    """Design the length-n impulse response (complex128) — steps 1-4 of the
    reference pipeline (sample response, IFFT, half-swap, window,
    energy-renormalize).  Any n >= 1, odd included: the reference's swap
    loop (``filters.rs:201-203``, ``swap(i, i + n/2)`` for ``i < n/2``) is
    a block swap of the first two half-open halves with the final element
    fixed for odd n — reproduced literally below (equals fftshift for
    even n only)."""
    # Signed bin layout: bins 0..=max positive, n-i negative
    # (src/blocks/filters.rs:190-199).  Bin n/2 (Nyquist, even n) is left at
    # zero exactly like the reference (max_bin_abs = (n-1)/2 < n/2).
    max_bin = (n - 1) // 2
    bins = np.zeros(n, dtype=np.int64)
    bins[: max_bin + 1] = np.arange(max_bin + 1)
    bins[n - max_bin:] = -np.arange(max_bin, 0, -1)
    freqs = bins.astype(np.float64) * (sample_rate / n)
    # copy: np.asarray aliases a user-returned complex128 table, and the
    # Nyquist write below must not escape into the caller's array.
    gains = np.array(freq_resp(bins, freqs), dtype=np.complex128)
    if n % 2 == 0:
        gains[n // 2] = 0.0  # Nyquist bin never sampled by the reference.
    # Inverse FFT to impulse response, center with the reference's literal
    # half-swap (filters.rs:201-203): block-swap [0,half) and [half,2half),
    # last element fixed for odd n.  Equals fftshift for even n.
    ir = np.fft.ifft(gains)
    half = n // 2
    ir = np.concatenate([ir[half:2 * half], ir[:half], ir[2 * half:]])
    # Window and renormalize to pre-window energy
    # (src/blocks/filters.rs:204-219).
    w = window_table(window, n)
    energy_pre = float(np.sum(np.abs(ir) ** 2))
    ir = ir * w
    energy_post = float(np.sum(np.abs(ir) ** 2))
    if energy_post > 0.0:
        ir = ir * np.sqrt(energy_pre / energy_post)
    return ir


def design_response(freq_resp: Callable, window: Window, n: int,
                    sample_rate: float) -> np.ndarray:
    """Design the extended frequency response R[2n] (complex128).

    ``freq_resp(bins, freqs) -> complex gains`` receives *arrays* of signed
    bin indices and signed frequencies in hertz (vectorized version of the
    reference's per-bin closure calls at ``src/blocks/filters.rs:193-199``).
    """
    ir = design_impulse_response(freq_resp, window, n, sample_rate)
    return extend_response(ir)


def extend_response(ir: np.ndarray, pad: int = None) -> np.ndarray:
    """Zero-pad an m-tap impulse response to ``pad + m`` (front zeros) and
    transform once (``src/blocks/filters.rs:220-238``).  ``pad`` defaults
    to m — the reference's 2n layout; a larger pad = the decoupled
    geometry where each step filters ``pad`` new samples against the same
    m-tap response.  The complex64 round-trip matches the reference's
    f64->Flt cast before the response FFT.  Single owner of this
    layout."""
    m = ir.shape[-1]
    if pad is None:
        pad = m
    ext = np.concatenate([np.zeros(pad, dtype=np.complex128),
                          ir.astype(_nums.stream_complex()).astype(np.complex128)])
    return np.fft.fft(ext)


class _BoundFilter(BoundBlock):
    @property
    def output_is_real(self):
        # A real impulse response maps real input to real output.
        return self.input_is_real and self._real_ir

    def __init__(self, sig: StreamSig, freq_resp: Callable, window: Window,
                 ir_len: Optional[int] = None):
        self.in_sig = self.out_sig = sig
        self.window = window
        # First output is computed against a zero previous chunk the
        # reference would still be buffering (filters.rs:79-82).
        self.valid_from = 1
        n = sig.chunk_len
        # Decoupled overlap-save geometry: the impulse response (and with
        # it the designed frequency resolution, rate/ir_len) may be
        # SHORTER than the chunk — each step then filters n new samples
        # against an ir_len-tap history over an (n + ir_len)-point
        # transform.  Output values equal the coupled geometry's exactly
        # (same designed IR, same linear convolution); ir_len = n (the
        # default) reproduces the reference's coupling
        # (filters.rs:240-259) bit for bit.
        m = n if ir_len is None else int(ir_len)
        if not 0 < m <= n:
            raise ValueError(f"ir_len {m} must be in (0, chunk_len {n}]")
        self.ir_len = m
        ir = design_impulse_response(freq_resp, window, m, sig.sample_rate)
        peak = max(float(np.abs(ir.real).max()), 1e-30)
        self._real_ir = bool(np.abs(ir.imag).max() <= 1e-9 * peak)
        # Traced param: Filter::update swaps the response without
        # recompiling (src/blocks/filters.rs:279-297).  Kept as a host
        # (numpy) array: complex leaves must stay host-side until they
        # cross the jit boundary through the wire packer (see
        # blocks/base.py pack_wire).
        self.params = {"response":
                       extend_response(ir, pad=n).astype(
                           _nums.stream_complex())}

    def init_state(self):
        sig = self.in_sig
        return {"prev": np.zeros((sig.batch, self.ir_len),
                                 _nums.stream_complex())}

    def process(self, params, state, x, reset):
        n = self.in_sig.chunk_len
        m = self.ir_len
        prev = jnp.where(reset[:, None], jnp.zeros_like(state["prev"]),
                         state["prev"])
        pair_real = (self.input_is_real and self._real_ir
                     and x.shape[0] % 2 == 0 and x.shape[0] >= 2)
        if pair_real:
            # Two real streams share one complex transform: with a real
            # impulse response, filter(a + i b) = filter(a) + i filter(b)
            # exactly, so pack stream pairs and halve the FFT work.
            x_full, prev_full = x, prev
            x = jax.lax.complex(x[0::2].real, x[1::2].real)
            prev = jax.lax.complex(prev[0::2].real, prev[1::2].real)
        spec = (jnp.fft.fft(jnp.concatenate([prev, x], axis=-1))
                * params["response"])
        y = jnp.fft.ifft(spec)[..., :n].astype(x.dtype)
        if pair_real:
            yr = jnp.stack([y.real, y.imag], axis=1)
            yr = yr.reshape(x_full.shape[0], n)
            y = jax.lax.complex(yr, jnp.zeros_like(yr))
            return {"prev": x_full[..., n - m:]}, y
        return {"prev": x[..., n - m:]}, y

    def update_params(self, freq_resp: Callable,
                      window: Optional[Window] = None):
        """Redesign the response host-side (analog of ``Filter::update``)."""
        w = window if window is not None else self.window
        ir = design_impulse_response(freq_resp, w, self.ir_len,
                                     self.in_sig.sample_rate)
        r = extend_response(ir, pad=self.in_sig.chunk_len)
        return {"response": r.astype(_nums.stream_complex())}


class Filter(Block):
    """General-purpose frequency filter by overlap-save fast convolution
    (``src/blocks/filters.rs:110-298``).

    ``freq_resp(bins, freqs)`` is a vectorized closure from signed DFT bin
    indices / signed frequencies (hertz) to complex gains.  Frequency
    resolution is ``x * sample_rate / ir_len`` for
    ``Kaiser.with_null_at_bin(x)`` (the default, x=2.0), where ``ir_len``
    defaults to the bound chunk length (the reference's coupling).

    ``ir_len < chunk_len`` decouples the impulse-response length from the
    samples-per-step: the designed response (and resolution) is that of
    an ``ir_len``-chunk reference filter, but each step processes a full
    chunk of new samples over one (chunk+ir_len)-point transform — fewer
    FLOPs and halo bytes per sample.  Output values match the coupled
    geometry.
    """

    def __init__(self, freq_resp: Callable, window: Optional[Window] = None,
                 ir_len: Optional[int] = None):
        self.freq_resp = freq_resp
        self.window = window if window is not None else Kaiser.with_null_at_bin(2.0)
        self.ir_len = ir_len

    @classmethod
    def new(cls, freq_resp: Callable, ir_len: Optional[int] = None) -> "Filter":
        return cls(freq_resp, ir_len=ir_len)

    @classmethod
    def new_rectangular(cls, freq_resp: Callable,
                        ir_len: Optional[int] = None) -> "Filter":
        return cls(freq_resp, Rectangular(), ir_len=ir_len)

    @classmethod
    def with_window(cls, freq_resp: Callable, window: Window) -> "Filter":
        return cls(freq_resp, window)

    def bind(self, sig: StreamSig) -> _BoundFilter:
        return _BoundFilter(sig, self.freq_resp, self.window, self.ir_len)


class _BoundFilterBank(BoundBlock):
    """K overlap-save filters sharing one forward transform.

    Each band goes through the exact reference design pipeline
    (``src/blocks/filters.rs:184-239``) independently, so band ``j``'s
    output is bit-identical to ``Filter(freq_resps[j])`` on the same
    stream — but the hot loop computes FFT(prev || x) once, multiplies K
    responses, and runs the K inverse transforms as one batched call,
    carrying a single shared previous-chunk state instead of K copies.
    """

    def __init__(self, sig: StreamSig, freq_resps, window: Window,
                 ir_len: Optional[int] = None):
        self.in_sig = self.out_sig = sig
        self.window = window
        self.valid_from = 1
        n = sig.chunk_len
        m = n if ir_len is None else int(ir_len)
        if not 0 < m <= n:
            raise ValueError(f"ir_len {m} must be in (0, chunk_len {n}]")
        self.ir_len = m
        irs = [design_impulse_response(fr, window, m, sig.sample_rate)
               for fr in freq_resps]
        self.num_outputs = len(irs)
        self.out_sigs = (sig,) * self.num_outputs
        self._real_irs = tuple(
            bool(np.abs(ir.imag).max()
                 <= 1e-9 * max(float(np.abs(ir.real).max()), 1e-30))
            for ir in irs)
        # One retunable response per band (same wire layout as Filter).
        self.params = {"responses": np.stack(
            [extend_response(ir, pad=n).astype(_nums.stream_complex())
             for ir in irs])}

    @property
    def outputs_real(self):
        return tuple(self.input_is_real and r for r in self._real_irs)

    def init_state(self):
        sig = self.in_sig
        return {"prev": np.zeros((sig.batch, self.ir_len),
                                 _nums.stream_complex())}

    def process(self, params, state, x, reset):
        n = self.in_sig.chunk_len
        m = self.ir_len
        b = x.shape[0]
        k = self.num_outputs
        prev = jnp.where(reset[:, None], jnp.zeros_like(state["prev"]),
                         state["prev"])
        spec = jnp.fft.fft(jnp.concatenate([prev, x], axis=-1))  # once
        prod = spec[None, :, :] * params["responses"][:, None, :]
        ys = jnp.fft.ifft(prod.reshape(k * b, n + m))[..., :n].astype(
            x.dtype)
        ys = ys.reshape(k, b, n)
        return {"prev": x[..., n - m:]}, tuple(ys[j] for j in range(k))

    def update_params(self, freq_resps, window: Optional[Window] = None):
        """Redesign every band's response host-side (Filter::update
        analog, ``src/blocks/filters.rs:279-297``)."""
        w = window if window is not None else self.window
        return {"responses": np.stack(
            [extend_response(
                design_impulse_response(fr, w, self.ir_len,
                                        self.in_sig.sample_rate),
                pad=self.in_sig.chunk_len).astype(_nums.stream_complex())
             for fr in freq_resps])}


class FilterBank(Block):
    """Several :class:`Filter` bands over one stream, sharing the forward
    transform — the multi-band analysis primitive (stereo MPX decode,
    spectrum splitting).  A graph-only multi-output block: add it with
    :meth:`radiorust_tpu.blocks.graph.Graph.bank`, which returns one
    :class:`NodeRef` per band.  Per-band outputs match standalone
    ``Filter`` blocks exactly (shared-transform identity of linear
    filtering; equivalence-tested)."""

    def __init__(self, freq_resps, window: Optional[Window] = None,
                 ir_len: Optional[int] = None):
        self.freq_resps = tuple(freq_resps)
        if not self.freq_resps:
            raise ValueError("FilterBank needs at least one band")
        self.window = (window if window is not None
                       else Kaiser.with_null_at_bin(2.0))
        self.num_outputs = len(self.freq_resps)
        self.ir_len = ir_len

    def bind(self, sig: StreamSig) -> _BoundFilterBank:
        return _BoundFilterBank(sig, self.freq_resps, self.window,
                                self.ir_len)


class _BoundSlewRateLimiter(BoundBlock):
    def __init__(self, sig: StreamSig, slew_rate: float):
        self.in_sig = self.out_sig = sig
        self.params = _nums.stream_real()(slew_rate)

    def init_state(self):
        return {"prev": np.zeros((self.in_sig.batch,), _nums.stream_complex())}

    def process(self, params, state, x, reset):
        # Truly sequential recurrence (each output feeds the next clamp,
        # src/blocks/filters.rs:338-349).  On the GPU the sample loop runs
        # inside one kernel (ops/pallas_scan.py); on the CPU, and for the
        # complex128 validation mode, as the lax.scan below.
        max_diff = params / params.dtype.type(self.in_sig.sample_rate)

        from .. import backend
        if x.dtype != jnp.complex128 and backend.use_kernels():
            from ..ops.pallas_scan import slew_scan
            prev = state["prev"]
            yr, yi, pr, pi = slew_scan(jnp.real(x), jnp.imag(x),
                                       jnp.real(prev), jnp.imag(prev),
                                       max_diff)
            return ({"prev": jax.lax.complex(pr, pi)},
                    jax.lax.complex(yr, yi))

        def step(prev, sample):
            diff = sample - prev
            norm = jnp.abs(diff)
            scale = jnp.where(norm > max_diff, max_diff / norm, 1.0)
            out = prev + diff * scale.astype(x.dtype)
            return out, out

        # unroll=8 amortizes scan-iteration overhead; the recurrence itself
        # has no O(1)-state associative form (the per-step map
        # y -> min(y+d, max(y-d, x)) composes into ever-larger min-max
        # trees), so log-depth parallelization is not available.
        prev, ys = jax.lax.scan(step, state["prev"], jnp.swapaxes(x, 0, 1),
                                unroll=8)
        return {"prev": prev}, jnp.swapaxes(ys, 0, 1)


class SlewRateLimiter(Block):
    """Limits the slew rate of IQ values
    (``src/blocks/filters.rs:307-376``)."""

    def __init__(self, slew_rate: float):
        self.slew_rate = float(slew_rate)

    def bind(self, sig: StreamSig) -> _BoundSlewRateLimiter:
        return _BoundSlewRateLimiter(sig, self.slew_rate)
