"""Rational polyphase FIR resampling as a strided convolution.

The reference resamples with per-sample ring-buffer loops and an f64 phase
accumulator (``src/blocks/resampling.rs:103-133`` down,
``:238-267`` up) whose output count is data-dependent — a formulation XLA
cannot compile.  Here the arbitrary-ratio resampler is re-derived as a
*static* rational operation:

With input/output rates in the exact ratio ``p/q`` (reduced), the
reference's accumulator emits output ``k`` at input index
``n_k = ceil((k+1) p / q) - 1`` (downsampling) and scatters input ``n`` to
output base ``o_n = ceil(n q / p)`` (upsampling).  Both patterns are
periodic: advancing ``q`` outputs advances exactly ``p`` inputs.  Grouping
outputs by residue class mod ``q`` turns resampling into a single
cross-correlation with ``q`` output channels and stride ``p`` — one strided
convolution for XLA (cuDNN on the GPU):

    y[b, m*q + r] = sum_u  xp[b, s0 + m*p + u] * W[r, u]

where ``W`` is a host-designed kernel matrix embedding the windowed-sinc
taps at each residue's offset.  History (the ring buffer) becomes a carried
``hist`` slab concatenated in front of each chunk; output counts are static
because chunks are constrained to whole periods (``chunk_len % p == 0``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from radiorust_tpu import config

from ..math import sinc
from ..windowing import Kaiser

__all__ = [
    "design_ir", "RationalPlan", "plan_downsample", "plan_upsample",
    "rational_fir", "rational_fir_phase",
]


def design_ir(base_rate: float, other_rate: float, margin: float,
              quality: float) -> np.ndarray:
    """Windowed-sinc prototype taps (float64).

    Mirrors the reference's IR design (``src/blocks/resampling.rs:82-101``
    and ``:216-233``): length ``ceil(base_rate/margin*quality)``, Kaiser
    window with first null at bin ``len*margin/base_rate``, taps
    ``sinc(x*other_rate/base_rate) * window``, energy-normalized.  For
    downsampling ``base=input, other=output``; for upsampling
    ``base=output, other=input``.
    """
    ir_len = int(math.ceil(base_rate / margin * quality))
    assert ir_len > 0
    window = Kaiser.with_null_at_bin(ir_len * margin / base_rate)
    x = (np.arange(ir_len, dtype=np.float64) + 0.5) - ir_len / 2.0
    y = sinc(x * other_rate / base_rate) * window.relative_value_at(
        x * 2.0 / ir_len)
    return y / np.sqrt(np.sum(y * y))


def _exact_ratio(input_rate: float, output_rate: float) -> Tuple[int, int]:
    """Reduced (p, q) with input_rate/output_rate == p/q exactly (as f64s)."""
    r = Fraction(input_rate) / Fraction(output_rate)
    return r.numerator, r.denominator


@dataclass(frozen=True)
class RationalPlan:
    """Static plan for one rational resampling op.

    Two execution modes share the plan:

    - *aligned* (``chunk_len % p == 0``): the original static formulation —
      exactly ``chunk_len/p`` whole periods per step, one strided conv.
    - *phase* (any chunk length): the window grid no longer lands on chunk
      boundaries, so the step carries the grid phase ``(k*C) mod p`` in
      state and slices the history+chunk buffer at a traced offset.  The
      per-step output is a fixed ``ceil(C/p)*q``-sample chunk whose first
      ``valid_counts(k)`` samples are real outputs (the rest zero-padding)
      — the deterministic, host-computable schedule has period
      ``p/gcd(C,p)``.  Matches the reference's phase-accumulator loop
      (``src/blocks/resampling.rs:103-133``) output for output.

    Both directions reduce to the same geometry: window ``w`` (emitting
    outputs ``w*q..w*q+q``) covers inputs ``[w*p + D - Kw, w*p + D)`` with
    ``D = s0 - hist + Kw = p`` identically for the down- and up-sampling
    plan constructions (verified in tests), so a window is computable
    exactly when ``(w+1)*p`` input samples have been seen.
    """

    p: int            # input samples per period
    q: int            # output samples per period
    kernel: np.ndarray  # [q, Kw] float32 kernel matrix
    hist: int         # carried history samples (prepended to each chunk)
    s0: int           # start offset of window 0 in the padded input
    out_per_in: Fraction

    def out_len(self, chunk_len: int) -> int:
        if chunk_len % self.p:
            raise ValueError(
                f"chunk_len {chunk_len} must be a multiple of {self.p} "
                f"(rational resampling period); insert a Rechunker")
        return (chunk_len // self.p) * self.q

    def aligned(self, chunk_len: int) -> bool:
        return chunk_len % self.p == 0

    @property
    def phase_hist(self) -> int:
        """History samples carried in phase mode (Kw - 1: enough to cover
        the oldest input any next-step window can reach)."""
        return int(self.kernel.shape[1]) - 1

    def windows_per_step(self, chunk_len: int) -> int:
        """Static window slots per step in phase mode (>= any step's
        actual count)."""
        return -(-chunk_len // self.p)

    def advance(self, phase: int, chunk_len: int):
        """One schedule step from grid phase ``phase``: returns
        ``(valid_output_samples, next_phase)``.  SINGLE OWNER of the
        phase-mode schedule — ``valid_counts``, the bound block's
        runtime mirror (``advance_schedule``), and the traced in-kernel
        ``v``/``new_phase`` in :func:`rational_fir_phase` all follow
        this formula; change them together."""
        v = self.q * ((phase + chunk_len) // self.p)
        return v, (phase + chunk_len) % self.p

    def valid_counts(self, chunk_len: int, k0: int, nsteps: int):
        """Valid output samples per step for steps k0..k0+nsteps (phase
        mode schedule; in aligned mode every entry is chunk_len/p*q)."""
        phase = (k0 * chunk_len) % self.p
        out = []
        for _ in range(nsteps):
            v, phase = self.advance(phase, chunk_len)
            out.append(v)
        return np.array(out, np.int64)


def plan_downsample(input_rate: float, output_rate: float, bandwidth: float,
                    quality: float = 3.0,
                    prefilter_ir=None) -> RationalPlan:
    """Plan a downsampling op (``src/blocks/resampling.rs:38-146``).

    ``prefilter_ir`` (optional, at the *input* rate) fuses a preceding LTI
    filter into the decimating FIR: the composite correlation taps are
    ``conv(ir, reversed(prefilter_ir))``, which computes exactly
    ``decimate(filter(x))`` in one strided convolution — used e.g. to fold
    the WFM deemphasis filter into the final decimation.
    """
    assert output_rate >= 0.0 and bandwidth >= 0.0
    assert bandwidth < output_rate, "bandwidth must be below output rate"
    assert input_rate >= output_rate, "input rate must be >= output rate"
    margin = (output_rate - bandwidth) / 2.0
    ir = design_ir(input_rate, output_rate, margin, quality)
    if prefilter_ir is not None:
        pre = np.asarray(prefilter_ir)
        if np.abs(pre.imag).max() > 1e-9 * max(np.abs(pre.real).max(), 1e-30):
            raise ValueError("prefilter impulse response must be real "
                             "(conjugate-symmetric frequency response)")
        ir = np.convolve(ir, pre.real[::-1])
    L = len(ir)
    p, q = _exact_ratio(input_rate, output_rate)
    # Output k lands on input index n_k = ceil((k+1) p / q) - 1; one period
    # of residues:
    n = [-((-(k + 1) * p) // q) - 1 for k in range(q)]
    Kw = L + p - 1
    W = np.zeros((q, Kw), dtype=np.float64)
    for r in range(q):
        W[r, n[r]: n[r] + L] = ir
    from ..numbers import stream_real
    return RationalPlan(p=p, q=q, kernel=W.astype(stream_real()),
                        hist=L - 1, s0=0,
                        out_per_in=Fraction(q, p))


def plan_upsample(input_rate: float, output_rate: float, bandwidth: float,
                  quality: float = 3.0) -> RationalPlan:
    """Plan an upsampling op (``src/blocks/resampling.rs:173-280``)."""
    assert output_rate >= 0.0 and bandwidth >= 0.0
    assert input_rate <= output_rate, "input rate must be <= output rate"
    assert bandwidth < input_rate, "bandwidth must be below input rate"
    margin = (input_rate - bandwidth) / 2.0
    ir = design_ir(output_rate, input_rate, margin, quality)
    L = len(ir)
    p, q = _exact_ratio(input_rate, output_rate)
    # Input n scatters ir into outputs o_n + j, o_n = ceil(n q / p); output m
    # sums x[n] * ir[m - o_n] over lo(m) <= n <= hi(m).
    def hi(m):
        return (m * p) // q

    def lo(m):
        return ((m - L) * p) // q + 1

    his = [hi(r) for r in range(q)]
    los = [lo(r) for r in range(q)]
    minlo = min(los)
    Kw = max(h - minlo + 1 for h in his)
    # Evaluate taps at a period far enough in that all indices are >= 0.
    C = max(0, -((minlo) // p) + 1)
    W = np.zeros((q, Kw), dtype=np.float64)
    for r in range(q):
        m = r + C * q
        base = minlo + C * p
        for u in range(Kw):
            n = base + u
            j = m - (-((-n * q) // p))  # m - ceil(n q / p)
            if los[r] + C * p <= n <= his[r] + C * p and 0 <= j < L:
                W[r, u] = ir[j]
    hist = max(0, -minlo)
    s0 = minlo + hist
    from ..numbers import stream_real
    return RationalPlan(p=p, q=q, kernel=W.astype(stream_real()),
                        hist=hist, s0=s0, out_per_in=Fraction(q, p))


def rational_fir_phase(x: jax.Array, hist: jax.Array, phase: jax.Array,
                       kernel: jax.Array, p: int, q: int,
                       real_input: bool = False):
    """One arbitrary-chunk-length rational resampling step (phase mode).

    ``x``: [batch, C] complex chunk; ``hist``: [batch, Kw-1] carried input
    tail; ``phase``: [batch] int32 grid phase ``(k*C) mod p`` (replicated
    across the batch — kept batch-major for the sharded executors'
    sub-batch splitting; row 0 drives the slice).  Returns
    ``(y [batch, E*q], new_hist, new_phase)`` with ``E = ceil(C/p)``; the
    first ``v*q`` output samples are valid where ``v = (phase + C) // p``
    whole windows completed this step (the rest are zeroed padding — the
    schedule is host-computable via :meth:`RationalPlan.valid_counts`).

    Window ``w`` covers absolute inputs ``[(w+1)p - Kw, (w+1)p)``; with
    the buffer holding the last ``Kw-1`` history samples plus the chunk,
    this step's first window starts at buffer offset ``p - 1 - phase``
    (derived in RationalPlan's docstring; identical window contents to
    the aligned formulation, so outputs match it bit for bit wherever
    both modes apply).
    """
    b, C = x.shape
    Kw = int(kernel.shape[1])
    E = -(-C // p)
    rdt = jnp.float64 if x.dtype == jnp.complex128 else jnp.float32
    ph = phase[0].astype(jnp.int32)
    parts = [hist, x]
    if p > 1:
        # Up to p-1 of the last windows may read past the chunk end
        # before they are valid; zero-pad so the static slice never
        # overruns (those windows are masked out below).
        parts.append(jnp.zeros((b, p - 1), x.dtype))
    buf = jnp.concatenate(parts, axis=-1)
    if real_input:
        planes = buf.real[:, None, :]
        nb = b
    else:
        planes = jnp.concatenate([buf.real, buf.imag], axis=0)[:, None, :]
        nb = 2 * b
    width = E * p + (Kw - p)
    o = (p - 1) - ph
    # All slice indices must share o's dtype (literal 0s default to
    # int64 under jax_enable_x64 — the c128 stream mode).
    z = jnp.zeros((), o.dtype)
    sl = jax.lax.dynamic_slice(planes.astype(rdt), (z, z, o),
                               (nb, 1, width))
    out = jax.lax.conv_general_dilated(
        sl, kernel[:, None, :].astype(rdt),
        window_strides=(p,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=rdt,
        precision=config.matmul_precision(),
    )                                                 # [nb, q, E]
    # Traced mirror of RationalPlan.advance (the schedule's single
    # owner): v whole windows complete this step, the rest are masked.
    v = (ph + jnp.int32(C)) // jnp.int32(p)
    mask = (jnp.arange(E, dtype=jnp.int32) < v)[None, None, :]
    out = jnp.where(mask, out, jnp.zeros_like(out))
    if real_input:
        yr = jnp.swapaxes(out, 1, 2).reshape(b, E * q)
        y = jax.lax.complex(yr, jnp.zeros_like(yr))
    else:
        yc = jax.lax.complex(out[:b], out[b:])        # [b, q, E]
        y = jnp.swapaxes(yc, 1, 2).reshape(b, E * q)
    new_hist = (jnp.concatenate([hist, x], axis=-1)[:, -(Kw - 1):]
                if Kw > 1 else hist[:, :0])
    new_phase = (phase + jnp.int32(C)) % jnp.int32(p)
    return y.astype(x.dtype), new_hist, new_phase


def rational_fir(xp: jax.Array, kernel: jax.Array, p: int, q: int,
                 s0: int, out_len: int, real_input: bool = False) -> jax.Array:
    """Apply a rational-resampling kernel matrix.

    ``xp``: [batch, hist+chunk_len] complex64 (history prepended).
    ``kernel``: [q, Kw] float32.  Returns [batch, out_len] complex64.

    Real/imaginary parts ride the conv batch axis so one real conv call
    serves the complex stream; XLA lowers the strided multi-channel
    correlation as one convolution.  ``real_input=True`` (stream known to carry
    zero imaginary part) halves the conv work.
    """
    b = xp.shape[0]
    # f64 stream mode (complex128 inputs, CPU backend): the conv runs in
    # f64 end to end; otherwise f32 as before.
    rdt = jnp.float64 if xp.dtype == jnp.complex128 else jnp.float32
    if real_input:
        lhs = xp.real[:, None, :]
        if s0:
            lhs = lhs[:, :, s0:]
        out = jax.lax.conv_general_dilated(
            lhs.astype(rdt), kernel[:, None, :].astype(rdt),
            window_strides=(p,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            preferred_element_type=rdt,
            precision=config.matmul_precision(),
        )
        m = out_len // q
        yr = jnp.swapaxes(out[:, :, :m], 1, 2).reshape(b, out_len)
        return jax.lax.complex(yr, jnp.zeros_like(yr))
    lhs = jnp.concatenate([xp.real, xp.imag], axis=0)[:, None, :]
    if s0:
        lhs = lhs[:, :, s0:]
    rhs = kernel[:, None, :]
    out = jax.lax.conv_general_dilated(
        lhs.astype(rdt), rhs.astype(rdt),
        window_strides=(p,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=rdt,
        precision=config.matmul_precision(),
    )  # [2b, q, M']
    m = out_len // q
    out = out[:, :, :m]
    y = jax.lax.complex(out[:b], out[b:])            # [b, q, M]
    y = jnp.swapaxes(y, 1, 2).reshape(b, out_len)    # interleave residues
    return y
