"""Prefix sums on the device path (``jnp.cumsum``: FmMod's phase
integrator, the occupied-bandwidth walk) vs float64, within the error
bound of recursive float32 summation."""

import jax.numpy as jnp
import numpy as np
import pytest

from radiorust_tpu.blocks.base import StreamSig, scan
from radiorust_tpu.blocks.modulation import FmMod
from radiorust_tpu.metering import bandwidth, bandwidth_jax

U = np.finfo(np.float32).eps / 2  # unit roundoff of float32


def _phase_bound(inc):
    """Worst-case absolute error of an f32 prefix sum of ``inc`` (first
    order): (k+1) u sum|inc| at sample k, any summation order."""
    k = np.arange(1, inc.shape[-1] + 1)
    return (k + 1) * U * np.cumsum(np.abs(inc), axis=-1)


def _fm_mod_phase_error(x, rate, deviation, chunks=1):
    n = x.shape[-1] // chunks
    b = FmMod(deviation).bind(StreamSig(x.shape[0], n, rate))
    xs = jnp.asarray(np.moveaxis(x.reshape(x.shape[0], chunks, n), 1, 0))
    _, ys = scan(b, b.params, b.init_state(), xs)
    y = np.moveaxis(np.asarray(ys), 0, 1).reshape(x.shape)
    inc = x.real.astype(np.float64) * np.float64(np.float32(b.params))
    theta = np.cumsum(inc, axis=-1)
    err = np.abs(np.angle(y * np.exp(-1j * theta)))
    # The f32 sum, the mod-2pi fold of a |theta|-sized value, and the
    # cos/sin evaluation each add their own rounding.
    bound = _phase_bound(inc) + 2 * U * np.abs(theta) + 1e-6
    return err, bound


@pytest.mark.parametrize("shape", [(3, 4096), (64, 4096), (6, 512),
                                   (5, 100), (4, 128), (1, 256)])
def test_matches_f64_within_f32_scan_error(shape):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.complex64)
    err, bound = _fm_mod_phase_error(x, 128000.0, 2500.0)
    assert np.all(err <= bound)


def test_short_or_unaligned_falls_back_exactly():
    # The carried phase crosses chunk boundaries of unaligned lengths: the
    # streamed integrator stays inside the one-shot f64 bound.
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3 * 130)).astype(np.complex64)
    err, bound = _fm_mod_phase_error(x, 48000.0, 3000.0, chunks=3)
    assert np.all(err <= bound)
    assert float(np.max(err)) < 1e-4


def test_bandwidth_walk_matches_host_f64():
    # The device bandwidth walk (one f32 prefix scan) against the host
    # float64 walk: same occupied bandwidth to within one bin.
    rng = np.random.default_rng(2)
    n, rate = 1024, 102400.0
    spec = (np.exp(-0.5 * ((np.arange(n) - n / 2) / 30.0) ** 2)
            * (1.0 + 0.05 * rng.standard_normal(n))).astype(np.complex64)
    spec = np.fft.ifftshift(spec)
    want = bandwidth(0.01, rate, spec)
    got = float(bandwidth_jax(0.01, rate, jnp.asarray(spec[None]))[0])
    assert abs(got - want) <= rate / n


def test_monotone_on_nonnegative_input():
    # Metering walks compare a running energy total against a limit; the
    # prefix sum must stay monotone for nonnegative energies up to the
    # rounding of the running total.
    rng = np.random.default_rng(3)
    e = (rng.standard_normal((2, 4096)) ** 2).astype(np.float32)
    c = np.asarray(jnp.cumsum(jnp.asarray(e), axis=-1))
    tol = 4 * np.finfo(np.float32).eps * c[..., -1:]
    assert np.all(np.diff(c, axis=-1) >= -tol)
