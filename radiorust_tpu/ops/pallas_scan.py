"""GPU kernel for the slew-rate limiter's per-sample recurrence.

``SlewRateLimiter`` (reference ``src/blocks/filters.rs:338-349``) is a
true per-sample recurrence: each output feeds the next clamp, and the
complex clamp has no O(1) associative form (the per-step map composes
into ever-growing min-max trees), so some sequential sample loop is
unavoidable.  As ``lax.scan`` that loop becomes a device while-loop with
kernel launches in every step.  This kernel runs the whole loop inside
one Pallas program, through Triton:

- the streams are spread over the lanes of a block (``block_b`` streams
  per program, one per thread), so independent streams run in parallel
  and the grid covers the batch;
- the time loop runs inside the program, with the carried previous
  sample in registers;
- samples are laid out ``[T, B]`` (time-major, streams contiguous), so
  each step's load of one sample per stream is one coalesced row;
- complex samples are separate f32 re/im planes, and the clamp takes one
  transcendental on the critical path: ``md/|d| = md * rsqrt(|d|^2)``,
  compared on the squared norm.

Off the card the same kernel runs in the Pallas interpreter, but only
when a caller asks for it with ``interpret=True`` (the kernel's tests);
the block itself takes ``lax.scan`` on the CPU (:mod:`radiorust_tpu.backend`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

__all__ = ["slew_scan", "block_streams"]

# Samples advanced per loop iteration: their loads do not depend on the
# carry, so they issue together ahead of the serial clamp chain.
_UNROLL = 8


def block_streams(batch: int) -> int:
    """Streams per program: a power of two (Triton's tensor rule), at most
    one warp's 32 lanes, no wider than the batch needs."""
    bb = 1
    while bb < min(batch, 32):
        bb *= 2
    return bb


def _slew_kernel(T, xr_ref, xi_ref, md_ref, pr_ref, pi_ref,
                 yr_ref, yi_ref, opr_ref, opi_ref):
    md = md_ref[...]
    md2 = md * md

    def step(t, carry):
        pr, pi = carry
        dr = xr_ref[t, :] - pr
        di = xi_ref[t, :] - pi
        n2 = dr * dr + di * di
        scale = jnp.where(n2 > md2, md * jax.lax.rsqrt(n2),
                          jnp.float32(1.0))
        pr = pr + dr * scale
        pi = pi + di * scale
        yr_ref[t, :] = pr
        yi_ref[t, :] = pi
        return pr, pi

    def unrolled(i, carry):
        for u in range(_UNROLL):
            carry = step(i * _UNROLL + u, carry)
        return carry

    n_full = T // _UNROLL
    carry = jax.lax.fori_loop(0, n_full, unrolled, (pr_ref[...], pi_ref[...]))
    carry = jax.lax.fori_loop(n_full * _UNROLL, T, step, carry)
    opr_ref[...] = carry[0]
    opi_ref[...] = carry[1]


@functools.partial(jax.jit, static_argnames=("interpret",))
def slew_scan(xr, xi, prev_r, prev_i, max_diff, interpret: bool = False):
    """SlewRateLimiter over ``[B, T]`` f32 planes; carry = previous sample.

    Returns ``(yr, yi, prev_r, prev_i)``.  ``max_diff`` is a traced f32
    scalar (retunable without recompiling)."""
    B, T = xr.shape
    bb = block_streams(B)
    Bp = -(-B // bb) * bb

    def lanes(a):  # [B, ...] -> padded along the stream axis
        pad = [(0, Bp - B)] + [(0, 0)] * (a.ndim - 1)
        return a if Bp == B else jnp.pad(a, pad)

    xrp = lanes(xr.astype(jnp.float32)).T            # [T, Bp]
    xip = lanes(xi.astype(jnp.float32)).T
    md = jnp.broadcast_to(jnp.asarray(max_diff, jnp.float32), (Bp,))
    x_spec = pl.BlockSpec((T, bb), lambda b: (0, b))
    c_spec = pl.BlockSpec((bb,), lambda b: (b,))
    yr, yi, pr, pi = pl.pallas_call(
        functools.partial(_slew_kernel, T),
        grid=(Bp // bb,),
        in_specs=[x_spec, x_spec, c_spec, c_spec, c_spec],
        out_specs=(x_spec, x_spec, c_spec, c_spec),
        out_shape=(jax.ShapeDtypeStruct((T, Bp), jnp.float32),) * 2
        + (jax.ShapeDtypeStruct((Bp,), jnp.float32),) * 2,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="slew_scan",
    )(xrp, xip, md, lanes(prev_r.astype(jnp.float32)),
      lanes(prev_i.astype(jnp.float32)))
    return yr.T[:B], yi.T[:B], pr[:B], pi[:B]
