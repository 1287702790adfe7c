"""Metering: level, occupied bandwidth, energy rescaling.

Host (numpy, float64-exact) and device (jax, batched, stream-dtype) variants
of the reference's ``src/metering.rs`` analysis functions:

- ``level`` — mean squared norm (``src/metering.rs:21-30``).
- ``bandwidth`` — occupied bandwidth: walk FFT bins inward from both band
  edges, discounting ``double_percentile/2`` of total energy per side with
  fractional-bin interpolation (``src/metering.rs:41-80``).
- ``rescale_energy`` — resample bin energies to a display resolution with
  fractional-overlap weighting (``src/metering.rs:89-109``).

The ``*_jax`` variants are jittable and batched over a leading axis so a
whole stack of spectra is metered in one device launch.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


__all__ = [
    "level",
    "bandwidth",
    "rescale_energy",
    "level_jax",
    "bandwidth_jax",
    "rescale_energy_jax",
]


# ---------------------------------------------------------------------------
# Host (numpy, float64) versions — exact against the reference's unit tests.
# ---------------------------------------------------------------------------

def level(chunk) -> float:
    """Mean squared norm of a complex chunk (``src/metering.rs:21-30``).

    A unit-circle oscillator meters at 0 dB (the reference's doc-test,
    ``src/metering.rs:7-20``):

    >>> import numpy as np
    >>> x = np.exp(1j * np.linspace(0.0, 6.0, 100))
    >>> round(float(10.0 * np.log10(level(x))), 9)
    0.0
    """
    chunk = np.asarray(chunk)
    return float(np.mean(np.abs(chunk.astype(np.complex128)) ** 2))


def _bin_walk_order(n: int) -> np.ndarray:
    # The walk starts at the band edge (most-negative frequency, located at
    # index ceil(n/2) in DFT layout) and wraps: (wrap..n, 0..wrap)
    # (``src/metering.rs:69-70``).
    wrap = (n + 1) // 2
    return np.concatenate([np.arange(wrap, n), np.arange(0, wrap)])


def _discount(energies: np.ndarray, limit: float) -> float:
    # Count whole bins while the running energy stays <= limit, then add the
    # fractional part of the first bin that crosses it
    # (``src/metering.rs:48-65``).
    c = np.cumsum(energies)
    full = int(np.sum(c <= limit))
    if full >= len(energies):
        return float(full)
    prev = c[full - 1] if full > 0 else 0.0
    step = energies[full]
    return float(full) + (limit - prev) / step


def bandwidth(double_percentile: float, sample_rate: float, bins) -> float:
    """Occupied bandwidth in hertz of FFT bins (``src/metering.rs:41-80``)."""
    bins = np.asarray(bins).astype(np.complex128)
    n = len(bins)
    e = np.abs(bins) ** 2
    limit = float(np.sum(e)) * double_percentile / 2.0
    order = _bin_walk_order(n)
    used = _discount(e[order], limit) + _discount(e[order[::-1]], limit)
    bw = (n - used) * sample_rate / n
    return max(bw, 0.0)


def _overlap_matrix(resolution: int, n: int, xp=np):
    # overlap[o, i] = measure of [i, i+1) inside [o*n/res, (o+1)*n/res)
    o = xp.arange(resolution, dtype=xp.float64 if xp is np else jnp.float32)
    i = xp.arange(n, dtype=xp.float64 if xp is np else jnp.float32)
    left = o[:, None] * n / resolution
    right = (o[:, None] + 1.0) * n / resolution
    lo = xp.maximum(left, i[None, :])
    hi = xp.minimum(right, i[None, :] + 1.0)
    return xp.clip(hi - lo, 0.0, None)


def rescale_energy(resolution: int, bins) -> np.ndarray:
    """Resample |bins|^2 into ``resolution`` buckets
    (``src/metering.rs:89-109``).

    Expects the spectrum center-shifted (no wraparound mid-array), as the
    reference documents.
    """
    bins = np.asarray(bins).astype(np.complex128)
    e = np.abs(bins) ** 2
    return _overlap_matrix(resolution, len(bins)) @ e


# ---------------------------------------------------------------------------
# Device (jax) versions — batched over a leading axis, jittable.
# ---------------------------------------------------------------------------

def level_jax(chunks: jax.Array) -> jax.Array:
    """Mean squared norm per stream: [..., n] complex -> [...] real."""
    return jnp.mean(jnp.abs(chunks) ** 2, axis=-1)


def _discount_jax(energies: jax.Array, limit: jax.Array) -> jax.Array:
    """Reference single-direction discount (one cumsum per walk).  The
    shipping :func:`bandwidth_jax` derives BOTH walks from one scan; this
    form remains as its equivalence oracle (test_metering)."""
    c = jnp.cumsum(energies, axis=-1)
    full = jnp.sum(c <= limit[..., None], axis=-1)
    n = energies.shape[-1]
    idx = jnp.minimum(full, n - 1)
    prev = jnp.where(full > 0,
                     jnp.take_along_axis(
                         c, jnp.maximum(full - 1, 0)[..., None], axis=-1
                     )[..., 0],
                     0.0)
    step = jnp.take_along_axis(energies, idx[..., None], axis=-1)[..., 0]
    frac = jnp.where(full >= n, 0.0, (limit - prev) / jnp.where(step == 0, 1.0, step))
    return full.astype(energies.dtype) + frac


def bandwidth_jax(double_percentile: float, sample_rate: float,
                  bins: jax.Array) -> jax.Array:
    """Occupied bandwidth per spectrum: [..., n] complex -> [...] hertz.

    One prefix scan serves BOTH walk directions: with ``c`` the forward
    cumsum of the walked energies and ``S`` the total, the reverse walk's
    running sums are ``crev[k] = S - c[n-2-k]`` (``crev[n-1] = S``), so
    the reverse discount needs no second cumsum and no reversal of the
    spectrum.  Exact in real arithmetic; differs from a
    literal reversed cumsum by f32 ulps (a bin whose prefix lands within
    ~1 ulp of the limit can count differently — same caveat class as the
    sharded Squelch threshold)."""
    n = bins.shape[-1]
    e = jnp.abs(bins) ** 2
    S = jnp.sum(e, axis=-1)
    limit = S * (double_percentile / 2.0)
    # The bin walk (_bin_walk_order) is a circular shift by ceil(n/2):
    # an explicit roll (two slices + concat) instead of a general gather.
    w = jnp.roll(e, -((n + 1) // 2), axis=-1)
    c = jnp.cumsum(w, axis=-1)

    def take(a, idx):
        return jnp.take_along_axis(a, idx[..., None], axis=-1)[..., 0]

    # Forward walk (the original _discount on w).
    full_f = jnp.sum(c <= limit[..., None], axis=-1)
    prev_f = jnp.where(full_f > 0,
                       take(c, jnp.maximum(full_f - 1, 0)), 0.0)
    step_f = take(w, jnp.minimum(full_f, n - 1))
    frac_f = jnp.where(full_f >= n, 0.0,
                       (limit - prev_f) / jnp.where(step_f == 0.0, 1.0,
                                                    step_f))
    # Reverse walk, from the same scan: crev[k] <= limit (k <= n-2)
    # <=> c[n-2-k] >= S - limit, plus the k = n-1 term (crev = S).
    thresh = (S - limit)[..., None]
    full_r = (jnp.sum(c[..., : n - 1] >= thresh, axis=-1)
              + (S <= limit).astype(full_f.dtype))
    prev_r = jnp.where(
        full_r > 0,
        S - take(c, jnp.clip(n - 1 - full_r, 0, n - 1)), 0.0)
    step_r = take(w, jnp.clip(n - 1 - jnp.minimum(full_r, n - 1),
                              0, n - 1))
    frac_r = jnp.where(full_r >= n, 0.0,
                       (limit - prev_r) / jnp.where(step_r == 0.0, 1.0,
                                                    step_r))
    used = (full_f + frac_f + full_r + frac_r).astype(e.dtype)
    bw = (n - used) * (sample_rate / n)
    return jnp.maximum(bw, 0.0)


def rescale_energy_jax(resolution: int, bins: jax.Array) -> jax.Array:
    """Resample bin energies: [..., n] complex -> [..., resolution] real.

    The overlap weights form a sparse banded matrix, applied as one dense
    matmul over the bins.
    """
    e = (jnp.abs(bins) ** 2).astype(jnp.float32)
    m = _overlap_matrix(resolution, bins.shape[-1], xp=jnp).astype(jnp.float32)
    return jnp.einsum("ri,...i->...r", m, e)
