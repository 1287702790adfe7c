"""f64 stream mode (``RRTPU_STREAM_DTYPE=c128``) — the CPU-backend
validation mode closing the reference's last literal capability gap: the
reference is generic over f32/f64 for the whole stream path
(``/root/reference/src/numbers.rs:23-42``; every block is ``Flt: Float``),
while the default build fixes streams to complex64.  Under ``c128`` the bound
blocks run complex128 end to end (XLA formulations only — the Pallas
kernels are f32 by design and gate themselves off), giving
reference-class f64 numerics for tight oracle twins.

Runs in a SUBPROCESS: the mode needs ``jax_enable_x64``, which is a
process-global flag that would change dtype inference for every other
test in the suite.
"""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp

from radiorust_tpu import numbers
assert numbers.stream_mode() == "c128", numbers.stream_mode()
assert numbers.stream_complex() is np.complex128

from radiorust_tpu.blocks.base import Chain, StreamSig, pack_wire, \
    unpack_wire, scan
from radiorust_tpu.blocks.filters import Filter, SlewRateLimiter, \
    design_response
from radiorust_tpu.blocks.modulation import FmDemod, FmMod
from radiorust_tpu.blocks.transform import AgcControl, FreqShifter, \
    GainControl, Squelch
from radiorust_tpu.blocks.resampling import Downsampler
from radiorust_tpu.windowing import Kaiser

rng = np.random.default_rng(0)
batch, n, rate = 2, 2048, 384000.0
sig = StreamSig(batch, n, rate)
x = (rng.standard_normal((3, batch, n))
     + 1j * rng.standard_normal((3, batch, n))).astype(np.complex128)

# --- 1. dtype plumbing through a full receive chain -----------------------
def lp(bins, freqs):
    return np.where(np.abs(freqs) <= 100000.0, 1.0 + 0.0j, 0.0j)

chain = Chain(FreqShifter.with_shift(-57000.0), Filter.new(lp),
              FmDemod(150000.0), Downsampler(48000.0, 40000.0),
              GainControl(0.5))
bound = chain.bind(sig)
st, ys = scan(bound, bound.params, bound.init_state(), jnp.asarray(x))
assert ys.dtype == jnp.complex128, ys.dtype
assert np.all(np.isfinite(np.asarray(ys)))
# Wire format carries f64 planes and round-trips bit-exactly.
leaf = jax.tree.leaves(pack_wire(x[0]))[0]
assert leaf.dtype == np.float64, leaf.dtype
rt = unpack_wire(pack_wire(x[0]))
assert rt.dtype == np.complex128 and np.array_equal(rt, x[0])

# --- 2. recurrence reformulations vs straight f64 per-sample loops --------
# The parallel forms (associative scans, prefix products) reassociate f32
# arithmetic — their c64-mode error vs a sequential evaluation is ~1e-6.
# In c128 they must agree with an f64 sequential loop to f64 precision.
xs = x[0, 0]

# Squelch: e' = a e + (1-a)|s|^2, gate.
thr, alpha = 1e-1, 0.999
e = 0.0
want = np.empty(n, np.complex128)
for i, s in enumerate(xs):
    e = alpha * e + (1.0 - alpha) * abs(s) ** 2
    want[i] = s if e > thr else 0.0
sq = Squelch(thr, alpha).bind(sig)
_, got = sq.process(sq.params, sq.init_state(), jnp.asarray(x[0]),
                    jnp.zeros((batch,), bool))
err_sq = np.abs(np.asarray(got)[0] - want).max()
assert err_sq < 1e-10, err_sq

# AGC: g' = clip(g + rate (ref - |g s|)).
ref, agc_rate, max_g = 1.0, 1e-3, 64.0
g = 1.0
want = np.empty(n, np.complex128)
for i, s in enumerate(xs):
    want[i] = s * g
    g = min(max(g + agc_rate * (ref - abs(want[i])), 0.0), max_g)
agc = AgcControl(ref, agc_rate, max_g).bind(sig)
_, got = agc.process(agc.params, agc.init_state(), jnp.asarray(x[0]),
                     jnp.zeros((batch,), bool))
err_agc = np.abs(np.asarray(got)[0] - want).max()
assert err_agc < 1e-10, err_agc

# SlewRateLimiter (sequential lax.scan path under c128 — the Pallas
# kernel gates itself off).
slew = 100000.0
md = slew / rate
prev = 0.0 + 0.0j
want = np.empty(n, np.complex128)
for i, s in enumerate(xs):
    diff = s - prev
    nr = abs(diff)
    if nr > md:
        s = prev + diff / nr * md
    want[i] = s
    prev = s
sl = SlewRateLimiter(slew).bind(sig)
_, got = sl.process(sl.params, sl.init_state(), jnp.asarray(x[0]),
                    jnp.zeros((batch,), bool))
err_slew = np.abs(np.asarray(got)[0] - want).max()
assert err_slew < 1e-12, err_slew

# FmMod: f64 phase integral.
dev = 2500.0
fac = dev / rate * 2 * np.pi
theta = np.mod(np.cumsum(xs.real) * fac, 2 * np.pi)
want = np.cos(theta) + 1j * np.sin(theta)
fm = FmMod(dev).bind(sig)
_, got = fm.process(fm.params, fm.init_state(), jnp.asarray(x[0]),
                    jnp.zeros((batch,), bool))
err_fm = np.abs(np.asarray(got)[0] - want).max()
assert err_fm < 1e-9, err_fm        # cumsum reassociation, f64 ulps

# --- 3. Filter vs direct f64 overlap-save ---------------------------------
resp = design_response(lp, Kaiser.with_null_at_bin(2.0), n, rate)
filt = Filter.new(lp).bind(sig)
state = filt.init_state()
prev = np.zeros((batch, n), np.complex128)
for t in range(2):
    state, got = filt.process(filt.params, state, jnp.asarray(x[t]),
                              jnp.zeros((batch,), bool))
    want = np.fft.ifft(np.fft.fft(
        np.concatenate([prev, x[t]], axis=-1)) * resp)[..., :n]
    err_f = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
    assert err_f < 1e-12, (t, err_f)
    prev = x[t]

# --- 4. r5 features under c128 --------------------------------------------
# Decoupled overlap-save geometry (ir_len < chunk): must equal direct f64
# overlap-save with the m-tap response at every step.
m = 512
from radiorust_tpu.blocks.filters import design_impulse_response, \
    extend_response
ir = design_impulse_response(lp, Kaiser.with_null_at_bin(2.0), m, rate)
resp_d = extend_response(ir, pad=n)
fd = Filter.new(lp, ir_len=m).bind(sig)
state = fd.init_state()
prev = np.zeros((batch, m), np.complex128)
for t in range(2):
    state, got = fd.process(fd.params, state, jnp.asarray(x[t]),
                            jnp.zeros((batch,), bool))
    want = np.fft.ifft(np.fft.fft(
        np.concatenate([prev, x[t]], axis=-1)) * resp_d)[..., :n]
    err_d = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
    assert err_d < 1e-12, (t, err_d)
    prev = x[t][..., n - m:]

# Phase-mode (arbitrary-chunk) resampler: f64 conv end to end; trimmed
# stream must match the f64 ring-buffer oracle to f64-class error.
sig_p = StreamSig(1, 100, 1024.0)
dn = Downsampler(384.0, 200.0).bind(sig_p)
assert dn.phase_mode
xp = (rng.standard_normal((6, 1, 100))
      + 1j * rng.standard_normal((6, 1, 100))).astype(np.complex128)
stp = dn.init_state()
outs = []
for t in range(6):
    stp, y = dn.process(dn.params, stp, jnp.asarray(xp[t]),
                        jnp.zeros((1,), bool))
    assert y.dtype == jnp.complex128, y.dtype
    outs.append(np.asarray(y)[0])
vc = dn.valid_counts(0, 6)
got_p = np.concatenate([o[:v] for o, v in zip(outs, vc)])
# f64 ring-buffer oracle (tests/oracles.py oracle_downsample run in
# complex128 — the reference's per-sample loop, resampling.rs:61-133).
from radiorust_tpu.ops.polyphase import design_ir
irp = design_ir(1024.0, 384.0, (384.0 - 200.0) / 2.0, 3.0)
flat = xp[:, 0, :].reshape(-1)
L = len(irp)
ring = np.zeros(L, np.complex128)
rpos, pos, out_ref = 0, 0.0, []
for s in flat:
    ring[rpos] = s
    rpos += 1
    if rpos == L:
        rpos = 0
    pos += 384.0
    if pos >= 1024.0:
        pos -= 1024.0
        order = np.concatenate([ring[rpos:], ring[:rpos]])
        out_ref.append(np.sum(order * irp))
out_ref = np.array(out_ref, np.complex128)
err_p = np.abs(got_p - out_ref[:len(got_p)]).max()
assert err_p < 1e-10, err_p

print("F64OK", err_sq, err_agc, err_slew, err_fm, err_d, err_p)
"""


def test_f64_stream_mode_reference_class_numerics():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update({"RRTPU_STREAM_DTYPE": "c128", "JAX_PLATFORMS": "cpu",
                "PYTHONPATH": str(REPO)})
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "F64OK" in out.stdout, out.stdout
