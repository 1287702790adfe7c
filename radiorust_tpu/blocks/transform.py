"""Basic transformations: gain, frequency shifting, per-sample mapping.

XLA equivalents of the reference's ``src/blocks/transform.rs``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .. import numbers as _nums
from ..math import round_half_away
from ..numbers import TAU
from .base import Block, BoundBlock, StreamSig

__all__ = ["GainControl", "AgcControl", "Squelch", "FreqShifter",
           "MapSample", "Nop", "Combine"]


# ---------------------------------------------------------------------------
# GainControl
# ---------------------------------------------------------------------------

class _BoundGain(BoundBlock):
    @property
    def output_is_real(self):
        return self.input_is_real  # real gain preserves realness

    def __init__(self, sig: StreamSig, gain: float):
        self.in_sig = self.out_sig = sig
        # Traced param: retunable per step without recompilation — the
        # analog of the reference's watch-channel gain
        # (src/blocks/transform.rs:57-63,89-91).
        self.params = _nums.stream_real()(gain)

    def process(self, params, state, x, reset):
        return state, x * params.astype(jnp.real(x).dtype)


def _shift_param_update(chunk_len: int, denom: int, sample_rate: float,
                        shift: float):
    """New factored phasor tables for ``shift`` (the traced mixer params).
    Shared by FreqShifter's bind and its retune paths."""
    numer = round_half_away((denom * shift / sample_rate))
    ta, tb, adv = _shift_tables(chunk_len, denom, numer)
    return {"table_a": ta, "table_b": tb, "adv": adv}


def fold_phase_state(state, denom: int):
    """Phase-continuous retune state: fold the integer phase index into
    ``start_phase`` and restart the index at 0
    (``src/blocks/transform.rs:322-328``).  Extra state keys pass through
    unchanged."""
    k0 = np.asarray(state["k0"])
    start = np.asarray(state["start_phase"])
    new_start = (start + k0.astype(np.float64) * (TAU / denom)) % TAU
    return {**state,
            "k0": np.zeros(k0.shape, np.int32),
            "start_phase": np.asarray(new_start,
                                      np.asarray(state["start_phase"]).dtype)}


class GainControl(Block):
    """Multiply every sample by a tunable gain
    (``src/blocks/transform.rs:29-92``)."""

    def __init__(self, gain: float):
        self.gain = float(gain)

    def bind(self, sig: StreamSig) -> _BoundGain:
        return _BoundGain(sig, self.gain)


# ---------------------------------------------------------------------------
# Squelch
# ---------------------------------------------------------------------------

class _BoundSquelch(BoundBlock):
    @property
    def output_is_real(self):
        return self.input_is_real  # gating by a real mask preserves realness

    def __init__(self, sig: StreamSig, threshold: float, alpha: float):
        self.in_sig = self.out_sig = sig
        # Both knobs traced: open/close the gate per chunk without
        # recompiling.
        rdt = _nums.stream_real()
        self.params = {"threshold": rdt(threshold), "alpha": rdt(alpha)}

    def init_state(self):
        return {"env": np.zeros((self.in_sig.batch,), _nums.stream_real())}

    def process(self, params, state, x, reset):
        # Smoothed power e[n] = alpha e[n-1] + (1-alpha) |x[n]|^2 is a
        # first-order *linear* recurrence, so unlike the slew limiter's
        # sequential clamp it parallelizes exactly: compose the per-sample
        # affine maps (a, b) with a log-depth associative scan on the VPU
        # instead of a length-n sequential scan.
        alpha = params["alpha"]
        e_prev = jnp.where(reset, jnp.zeros_like(state["env"]), state["env"])
        p = jnp.real(x * jnp.conj(x))
        # Cast to the stream's real dtype: the f32 param broadcast inside
        # an f64 stream (c128 mode) would otherwise run the alpha-product
        # leaf of the scan at f32.
        a = jnp.broadcast_to(alpha.astype(p.dtype), p.shape)
        b = (1.0 - alpha).astype(p.dtype) * p

        def comb(l, r):
            a1, b1 = l
            a2, b2 = r
            return a1 * a2, b2 + a2 * b1

        big_a, big_b = jax.lax.associative_scan(comb, (a, b), axis=1)
        env = big_a * e_prev[:, None] + big_b
        gate = (env > params["threshold"]).astype(jnp.real(x).dtype)
        return ({"env": env[:, -1]},
                x * gate.astype(x.dtype))


class Squelch(Block):
    """Mute the stream while its smoothed power sits below a threshold.

    Not in the reference library (its receivers play unconditionally);
    the standard construction is a one-pole power envelope
    ``e += (1-alpha)(|x|^2 - e)`` gating the samples.  Here the one-pole
    IIR — normally a per-sample loop — runs as an exact log-depth
    ``associative_scan`` over the chunk (the recurrence is affine, so
    per-sample maps compose), keeping the whole block parallel on the
    VPU.  ``threshold`` is linear power of the unit-full-scale stream;
    both knobs retune per chunk (``RuntimeBlock.set_squelch``).  A stream
    reset clears the envelope (the gate re-opens only after the smoother
    re-converges).
    """

    def __init__(self, threshold: float = 1e-4, alpha: float = 0.999):
        assert 0.0 < alpha < 1.0, "alpha must be in (0, 1)"
        self.threshold = float(threshold)
        self.alpha = float(alpha)

    def bind(self, sig: StreamSig) -> _BoundSquelch:
        return _BoundSquelch(sig, self.threshold, self.alpha)


# ---------------------------------------------------------------------------
# AgcControl
# ---------------------------------------------------------------------------

# Slope/offset cap for the composed clamped-affine maps.  Slope products
# grow exponentially under sustained overdrive (|1 - rate |x|| > 1 every
# sample); uncapped they overflow f32 to inf and then compose to NaN
# (inf*0 in the bound arithmetic).  At |a| = 1e18 the unclamped interval
# of g0 values has width max_gain/1e18 < 1e-13 — far below f32
# resolution of the [0, max_gain] state — so capping is exact for every
# representable gain while keeping all composition arithmetic finite
# (1e18^2 = 1e36 < f32 max).
_AGC_CAP = np.float32(1e18)


def _agc_elems(params, x):
    """Per-sample clamped-affine maps of the AGC loop: sample n sends the
    loop gain through ``g -> clip(a g + b, lo, hi)`` with
    ``a = 1 - rate |x[n]|``, ``b = rate reference``.

    Every leaf is cast to the stream's real dtype: associative_scan
    concatenates computed elements with input elements leaf-for-leaf, so
    a f32 param broadcast inside an f64 stream (c128 mode) would trip
    lax.concatenate's dtype check."""
    absx = jnp.abs(x)
    rdt = absx.dtype
    a = jnp.clip(1.0 - params["rate"].astype(rdt) * absx,
                 -_AGC_CAP, _AGC_CAP).astype(rdt)
    b = jnp.broadcast_to(
        (params["rate"] * params["reference"]).astype(rdt), a.shape)
    lo = jnp.zeros_like(a)
    hi = jnp.broadcast_to(params["max_gain"].astype(rdt), a.shape)
    return a, b, lo, hi


def _agc_compose(e1, e2):
    """Compose clamped-affine maps: ``(f2 . f1)(g)`` where
    ``f(g) = clip(a g + b, lo, hi)``.  The family is closed under
    composition for *any* slope sign: a scalar multiple of a clip is a
    clip with (possibly swapped) bounds, and a clip of a clip is a clip
    with re-clamped bounds — so the element ``(a, b, lo, hi)`` is O(1)
    and the scan is exactly associative.  Slope/offset are capped at
    ``_AGC_CAP`` (see above) so sustained-overdrive products saturate
    instead of overflowing to inf/NaN."""
    a1, b1, l1, h1 = e1
    a2, b2, l2, h2 = e2
    a = jnp.clip(a1 * a2, -_AGC_CAP, _AGC_CAP)
    b = jnp.clip(a2 * b1 + b2, -_AGC_CAP, _AGC_CAP)
    inner_lo = jnp.minimum(a2 * l1, a2 * h1) + b2
    inner_hi = jnp.maximum(a2 * l1, a2 * h1) + b2
    return a, b, jnp.clip(inner_lo, l2, h2), jnp.clip(inner_hi, l2, h2)


class _BoundAgc(BoundBlock):
    @property
    def output_is_real(self):
        return self.input_is_real  # real gain preserves realness

    def __init__(self, sig: StreamSig, reference: float, rate: float,
                 max_gain: float):
        self.in_sig = self.out_sig = sig
        # All three knobs are traced params: retune per chunk without
        # recompiling, like GainControl's watch-channel analog.
        rdt = _nums.stream_real()
        self.params = {"reference": rdt(reference), "rate": rdt(rate),
                       "max_gain": rdt(max_gain)}

    def init_state(self):
        return {"gain": np.ones((self.in_sig.batch,), _nums.stream_real())}

    def process(self, params, state, x, reset):
        # y[n] = g[n] x[n];  g[n+1] = clip(g[n] + rate (ref - |y[n]|)).
        # Since |y| = |x| g (g >= 0), the update is g' = clip(a g + b)
        # with a = 1 - rate |x|, b = rate ref — a *clamped-affine* map,
        # and clamped-affine maps compose into clamped-affine maps
        # (_agc_compose), so the whole per-sample feedback loop runs as
        # an exact log-depth associative_scan on the VPU instead of a
        # length-n sequential scan (measured ~15x on-chip vs
        # lax.scan/Pallas sample loops, tools/exp_scan.py).  Gain is a
        # receiver tuning state, deliberately carried across stream
        # discontinuities (``reset`` leaves it untouched).
        elems = _agc_elems(params, x)
        pa, pb, plo, phi = jax.lax.associative_scan(
            _agc_compose, elems, axis=-1)
        g0 = state["gain"]
        g_inc = jnp.clip(pa * g0[:, None] + pb, plo, phi)
        # y[n] uses the gain *before* sample n's update (exclusive form).
        g_exc = jnp.concatenate([g0[:, None], g_inc[:, :-1]], axis=-1)
        y = x * g_exc.astype(x.dtype)
        return {"gain": g_inc[:, -1]}, y


class AgcControl(Block):
    """Automatic gain control: drives the output envelope toward
    ``reference`` with loop gain ``rate`` per sample.

    The reference library has no AGC — its ``GainControl`` is a manually
    tuned scalar (``src/blocks/transform.rs:29-92``) — but any AM/SSB
    receiver needs one; this is the classic feedback AGC loop
    (``g += rate * (reference - |g*x|)``), clamped to ``[0, max_gain]``.

    Stability contract: the loop is contracting (and the parallel
    associative-scan formulation matches the per-sample recurrence to
    f32) whenever ``rate * |x| < 2`` — the designed regime, ``rate``
    chosen well below ``1/|x|``.  Under *sustained* overdrive beyond
    that, the recurrence itself is chaotic (the gain bangs between the
    clip bounds and per-sample slope magnitudes exceed 1); outputs and
    state remain finite and inside ``[0, max_gain]`` (slope products
    saturate at ``_AGC_CAP`` instead of overflowing), but the f32
    trajectory is then one valid shadowing of the chaos, not
    bit-reproducible against a sequential evaluation.
    """

    def __init__(self, reference: float = 1.0, rate: float = 1e-3,
                 max_gain: float = 65536.0):
        self.reference = float(reference)
        self.rate = float(rate)
        self.max_gain = float(max_gain)

    def bind(self, sig: StreamSig) -> _BoundAgc:
        return _BoundAgc(sig, self.reference, self.rate, self.max_gain)


# ---------------------------------------------------------------------------
# MapSample
# ---------------------------------------------------------------------------

class _BoundMap(BoundBlock):
    @property
    def output_is_real(self):
        return self._real_output

    def __init__(self, sig: StreamSig, fn: Callable, fn_params=None,
                 real_output: bool = False):
        self.in_sig = self.out_sig = sig
        self.fn = fn
        self._real_output = bool(real_output)
        self._parameterized = fn_params is not None
        self.params = fn_params if self._parameterized else ()

    def process(self, params, state, x, reset):
        y = self.fn(x, params) if self._parameterized else self.fn(x)
        if self._real_output and jnp.iscomplexobj(y):
            # Enforce the declaration instead of trusting it: downstream
            # realness optimizations (pair-packed filter FFTs,
            # single-plane convs) discard the imaginary plane, so a fn
            # that violates ``real_output=True`` would corrupt output on
            # those paths only.  Truncating here makes every path agree
            # (and XLA DCEs the dead imaginary computation).
            y = jnp.real(y).astype(y.dtype)
        return state, y


class MapSample(Block):
    """Apply an elementwise jax-traceable function to every sample
    (``src/blocks/transform.rs:108-187``).

    Unlike the reference's boxed ``FnMut`` closure, the function must be a
    pure jax-traceable elementwise map (it is fused into the compiled
    chain); swap it by rebinding — or, for the common case of *tuning* a
    map rather than replacing it, use :meth:`with_params`: the closure's
    parameters become a traced pytree updated per chunk without recompile
    (the analog of the reference's mpsc closure hot-swap at
    ``src/blocks/transform.rs:132-179`` for parameter changes).
    """

    def __init__(self, fn: Callable = lambda x: x,
                 real_output: bool = False):
        self.fn = fn
        self.fn_params = None
        # Structural promise that ``fn`` emits zero imaginary parts
        # (e.g. an AM envelope detector) so downstream filters keep
        # their pair-packed real fast path.  ENFORCED, not trusted: the
        # bound block truncates the imaginary plane, so a fn violating
        # the promise yields Re(fn(x)) on every path rather than
        # silently corrupt output on the pair-packed ones.
        self.real_output = bool(real_output)

    @classmethod
    def with_params(cls, fn: Callable, params,
                    real_output: bool = False) -> "MapSample":
        """``fn(x, params) -> y`` with ``params`` a traced pytree (numpy
        leaves; complex leaves stay numpy until wire-packed)."""
        self = cls.__new__(cls)
        self.fn = fn
        self.fn_params = params
        self.real_output = bool(real_output)
        return self

    def bind(self, sig: StreamSig) -> _BoundMap:
        return _BoundMap(sig, self.fn, self.fn_params, self.real_output)


# ---------------------------------------------------------------------------
# Combine (fan-in)
# ---------------------------------------------------------------------------

class _BoundCombine(BoundBlock):
    def __init__(self, sigs, fn: Callable, preserves_real: bool):
        sigs = tuple(sigs)
        first = sigs[0]
        for s in sigs[1:]:
            if (s.batch, s.chunk_len, s.sample_rate) != (
                    first.batch, first.chunk_len, first.sample_rate):
                raise ValueError(
                    f"Combine inputs must share one signature; got {sigs}")
        self.in_sigs = sigs
        self.in_sig = self.out_sig = first
        self.fn = fn
        self._preserves_real = preserves_real
        #: Per-input realness flags, set by the binding graph.
        self.input_is_real_flags = [False] * len(sigs)

    @property
    def output_is_real(self):
        flags = list(self.input_is_real_flags)
        if len(flags) == 1:
            # Degenerate single-input use in a linear chain: Chain.bind /
            # BoundGraph's single-upstream path communicate realness via the
            # scalar ``input_is_real`` attribute, not the per-input flags.
            flags[0] = flags[0] or self.input_is_real
        return self._preserves_real and all(flags)

    def process(self, params, state, xs, reset):
        if not isinstance(xs, tuple):
            xs = (xs,)  # degenerate single-input use in a linear chain
        return state, self.fn(*xs)


class Combine(Block):
    """Elementwise fan-in of several streams: ``fn(*chunks) -> chunk``.

    The reference has no combine blocks — its channels only fan *out* (one
    producer, many lock-step consumers, ``src/flow.rs:44-52``); merging two
    streams would need a block holding two receivers, which no reference
    block does.  On the compiled path a :class:`~radiorust_tpu.blocks.graph.
    Graph` node may take several upstream nodes, and this block is the
    general fan-in operator: ``fn`` must be a pure jax-traceable elementwise
    map over equal-signature chunks (it fuses into the one XLA program).

    ``preserves_real=True`` declares that ``fn`` maps all-real inputs to
    real output (enables downstream pair-packed real paths).  Stateless;
    use inside a ``Graph`` via ``g.add(Combine(fn), (a, b))``.
    """

    def __init__(self, fn: Callable, preserves_real: bool = False):
        self.fn = fn
        self.preserves_real = bool(preserves_real)

    def bind(self, sig: StreamSig) -> _BoundCombine:
        # Degenerate single-input use in a linear chain.
        return self.bind_multi((sig,))

    def bind_multi(self, sigs) -> "_BoundCombine":
        return _BoundCombine(sigs, self.fn, self.preserves_real)


# ---------------------------------------------------------------------------
# FreqShifter
# ---------------------------------------------------------------------------

def _inner_block(chunk_len: int) -> int:
    best = 1
    for d in range(1, chunk_len + 1):
        if chunk_len % d == 0 and abs(d - 128) <= abs(best - 128):
            best = d
        if d > 512:
            break
    return best


def _shift_tables(chunk_len: int, denom: int, numer: int):
    """Host-side exact factored phasor tables for one chunk.

    The reference quantizes the shift to ``numer/denom`` of the sample rate
    and cycles an exact integer phase index so there is zero long-run phase
    drift (``src/blocks/transform.rs:298-339``).  We keep the integer-index
    representation but factor the oscillator: for sample ``n = a*inner + b``

        osc[n] = A[a] * B[b],   A[a] = e^{i tau (a*inner*numer mod denom)/denom}
                                B[b] = e^{i tau (b*numer mod denom)/denom}

    — an exact identity (the complex exponential is denom-periodic), so the
    hot loop is one complex multiply per sample instead of a sin/cos pair,
    while the carried *integer* phase index keeps zero drift.  Tables are
    built in float64 and rounded once to complex64, the same rounding class
    as the reference's f32 phase table.
    """
    numer %= denom
    inner = _inner_block(chunk_len)
    outer = chunk_len // inner
    tau = 2.0 * np.pi
    b_idx = (np.arange(inner, dtype=np.int64) * numer) % denom
    a_idx = (np.arange(outer, dtype=np.int64) * inner * numer) % denom
    table_b = np.exp(1j * tau * b_idx.astype(np.float64) / denom)
    table_a = np.exp(1j * tau * a_idx.astype(np.float64) / denom)
    adv = (chunk_len * numer) % denom
    cdt = _nums.stream_complex()
    return (table_a.astype(cdt), table_b.astype(cdt), np.int32(adv))


class _BoundFreqShifter(BoundBlock):
    def __init__(self, sig: StreamSig, precision: float, shift: float):
        self.in_sig = self.out_sig = sig
        self.precision = float(precision)
        # Readable current value (``FreqShifter::shift``,
        # src/blocks/transform.rs:380-382); shift_params is the single
        # mutation path and keeps it in sync.
        self.current_shift = float(shift)
        # Rational quantization exactly as the reference
        # (src/blocks/transform.rs:298-302).
        self.denom = round_half_away((sig.sample_rate / precision))
        if self.denom <= 0:
            raise ValueError("sample_rate / precision must round to >= 1")
        numer = round_half_away((self.denom * shift / sig.sample_rate))
        ta, tb, adv = _shift_tables(sig.chunk_len, self.denom, numer)
        # Traced params: retuning the shift only swaps these arrays (host
        # recompute, no XLA recompilation).  Complex tables stay numpy
        # until wire-packed (see blocks/base.py).
        self.params = {"table_a": ta, "table_b": tb, "adv": adv}

    def init_state(self):
        b = self.in_sig.batch
        return {
            # Exact integer phase index at chunk start, per stream.
            "k0": np.zeros((b,), np.int32),
            # Phase offset accumulated across retunes (phase continuity,
            # src/blocks/transform.rs:322-339).
            "start_phase": np.zeros((b,), _nums.stream_real()),
        }

    def process(self, params, state, x, reset):
        denom = self.denom
        # Per-stream chunk-start phasor from the exact integer index.
        rdt = state["start_phase"].dtype
        theta0 = (state["start_phase"]
                  + state["k0"].astype(rdt) * np.asarray(TAU / denom, rdt))
        p0 = jax.lax.complex(jnp.cos(theta0), jnp.sin(theta0))
        ta = params["table_a"]
        tb = params["table_b"]
        outer, inner = ta.shape[-1], tb.shape[-1]
        xb = x.reshape(x.shape[0], outer, inner)
        y = (xb * p0[:, None, None] * ta[None, :, None]
             * tb[None, None, :]).reshape(x.shape)
        new_state = {
            "k0": (state["k0"] + params["adv"]) % denom,
            "start_phase": state["start_phase"],
        }
        # The reference's oscillator keeps running through events (no state
        # reset on interrupt: src/blocks/transform.rs:357-359), so ``reset``
        # is deliberately unused.
        return new_state, y

    # -- host-side retune helpers ------------------------------------------

    def shift_params(self, shift: float):
        """Recompute traced params for a new shift (no recompilation)."""
        self.current_shift = float(shift)
        return _shift_param_update(self.in_sig.chunk_len, self.denom,
                                   self.in_sig.sample_rate, shift)

    def retune(self, params, state, shift: float):
        """Return (params', state') for a phase-continuous retune.

        Mirrors the reference's start-phase carryover on shift change
        (``src/blocks/transform.rs:322-328``): the current phase angle is
        folded into ``start_phase`` and the integer index restarts at 0.
        """
        return self.shift_params(shift), fold_phase_state(state, self.denom)


class FreqShifter(Block):
    """Complex oscillator/mixer shifting all frequencies in an IQ stream
    (``src/blocks/transform.rs:266-391``).

    The shift is quantized to a rational fraction of the sample rate at the
    given ``precision`` (default 1 Hz) and tracked with exact integer phase
    indices, so there is no long-run phase drift — matching the reference's
    phase-table method without materializing the table.
    """

    def __init__(self, shift: float = 0.0, precision: float = 1.0):
        self.shift = float(shift)
        self.precision = float(precision)

    @classmethod
    def with_shift(cls, shift: float) -> "FreqShifter":
        return cls(shift=shift)

    @classmethod
    def with_precision(cls, precision: float) -> "FreqShifter":
        return cls(precision=precision)

    @classmethod
    def with_precision_and_shift(cls, precision: float,
                                 shift: float) -> "FreqShifter":
        return cls(shift=shift, precision=precision)

    def bind(self, sig: StreamSig) -> _BoundFreqShifter:
        return _BoundFreqShifter(sig, self.precision, self.shift)


class Nop(MapSample):
    """Identity block forwarding samples unchanged — the reference's
    ``Nop``/``NopSignal`` template blocks (``src/blocks/mod.rs:157-239``)."""

    def __init__(self):
        super().__init__(lambda x: x)
