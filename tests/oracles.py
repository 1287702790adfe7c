"""Slow host-side oracles replicating the reference's per-sample semantics.

Each oracle is an independent, literal reimplementation of the reference
block's sequential loop (per-sample state updates, ring buffers, f64 phase
accumulators) used to validate the vectorized XLA formulations.  They mirror
radiorust's code paths structurally — e.g. the filter oracle emulates
rustfft's *unnormalized* transforms with the reference's 1/(2n^2) scaling,
whereas the production code uses numpy conventions with the scaling folded
away — so agreement is a genuine cross-check.
"""

import numpy as np

from radiorust_tpu.math import sinc
from radiorust_tpu.windowing import Kaiser, window_table


def oracle_freq_shift(x, sample_rate, shift, precision=1.0,
                      start_phase=0.0, phase_idx=0):
    """Reference FreqShifter (src/blocks/transform.rs:297-348): rational
    phase table in f32, cycled per sample."""
    denom = int(round(sample_rate / precision))
    numer = int(round(denom * shift / sample_rate))
    table = np.zeros(denom, np.complex64)
    i = 0
    for t in range(denom):
        ang = np.float32(start_phase) + np.float32(i) / np.float32(denom) * np.float32(2 * np.pi)
        table[t] = complex(np.cos(np.float32(ang)), np.sin(np.float32(ang)))
        i = (i + numer) % denom
    y = np.empty_like(x, dtype=np.complex64)
    for n in range(len(x)):
        y[n] = np.complex64(x[n]) * table[phase_idx]
        phase_idx = (phase_idx + 1) % denom
    return y, phase_idx


def oracle_fm_mod(x, sample_rate, deviation, phase=0.0):
    """Reference FmMod (src/blocks/modulation.rs:45-52), f32 state."""
    factor = np.float32(deviation / sample_rate * 2 * np.pi)
    phase = np.float32(phase)
    tau = np.float32(2 * np.pi)
    y = np.empty(len(x), np.complex64)
    for n in range(len(x)):
        phase = np.float32(phase + np.float32(np.real(x[n])) * factor)
        phase = np.float32(np.fmod(phase, tau))
        y[n] = complex(np.cos(phase), np.sin(phase))
    return y, phase


def oracle_fm_demod(x, sample_rate, deviation, prev=None, last_out=0.0):
    """Reference FmDemod (src/blocks/modulation.rs:116-126)."""
    factor = np.float32(sample_rate / deviation / (2 * np.pi))
    y = np.empty(len(x), np.complex64)
    out = np.float32(last_out)
    for n in range(len(x)):
        s = np.complex64(x[n])
        if prev is not None:
            p = s * np.conj(np.complex64(prev))
            out = np.float32(np.arctan2(np.float32(p.imag),
                                        np.float32(p.real)) * factor)
        y[n] = out
        prev = s
    return y, prev, out


def oracle_slew_rate_limiter(x, sample_rate, slew_rate, prev=0.0 + 0.0j):
    """Reference SlewRateLimiter (src/blocks/filters.rs:338-349)."""
    max_diff = np.float32(slew_rate / sample_rate)
    y = np.empty(len(x), np.complex64)
    prev = np.complex64(prev)
    for n in range(len(x)):
        s = np.complex64(x[n])
        diff = s - prev
        norm = np.float32(abs(diff))
        if norm > max_diff:
            s = prev + diff / norm * max_diff
        y[n] = s
        prev = s
    return y, prev


def oracle_agc(x, reference, rate, max_gain, gain0=1.0):
    """Per-sample feedback AGC loop in f32 (the AgcControl recurrence)."""
    g = np.float32(gain0)
    y = np.empty(len(x), np.complex64)
    for n in range(len(x)):
        y[n] = np.complex64(x[n]) * g
        g = np.float32(g + np.float32(rate)
                       * (np.float32(reference) - np.float32(abs(y[n]))))
        g = np.float32(min(max(g, np.float32(0.0)), np.float32(max_gain)))
    return y, g


def oracle_squelch(x, threshold, alpha, env0=0.0):
    """Per-sample one-pole power squelch in f32 (the Squelch recurrence)."""
    e = np.float32(env0)
    y = np.empty(len(x), np.complex64)
    for n in range(len(x)):
        s = np.complex64(x[n])
        e = np.float32(np.float32(alpha) * e
                       + np.float32(1.0 - alpha) * np.float32(abs(s)) ** 2)
        y[n] = s if e > np.float32(threshold) else np.complex64(0.0)
    return y, e


def oracle_downsample(x, input_rate, output_rate, bandwidth, quality=3.0):
    """Reference Downsampler loop (src/blocks/resampling.rs:61-133)."""
    margin = (output_rate - bandwidth) / 2.0
    ir_len = int(np.ceil(input_rate / margin * quality))
    window = Kaiser.with_null_at_bin(ir_len * margin / input_rate)
    xs = (np.arange(ir_len) + 0.5) - ir_len / 2.0
    ir = sinc(xs * output_rate / input_rate) * window.relative_value_at(
        xs * 2.0 / ir_len)
    ir = (ir / np.sqrt(np.sum(ir * ir))).astype(np.float32)
    ringbuf = np.zeros(ir_len, np.complex64)
    rpos = 0
    pos = 0.0
    out = []
    for sample in x.astype(np.complex64):
        ringbuf[rpos] = sample
        rpos += 1
        if rpos == ir_len:
            rpos = 0
        pos += output_rate
        if pos >= input_rate:
            pos -= input_rate
            order = np.concatenate([ringbuf[rpos:], ringbuf[:rpos]])
            out.append(np.complex64(np.sum(order * ir)))
    return np.array(out, np.complex64)


def oracle_upsample(x, input_rate, output_rate, bandwidth, quality=3.0):
    """Reference Upsampler loop (src/blocks/resampling.rs:192-267)."""
    margin = (input_rate - bandwidth) / 2.0
    ir_len = int(np.ceil(output_rate / margin * quality))
    window = Kaiser.with_null_at_bin(ir_len * margin / output_rate)
    xs = (np.arange(ir_len) + 0.5) - ir_len / 2.0
    ir = sinc(xs * input_rate / output_rate) * window.relative_value_at(
        xs * 2.0 / ir_len)
    ir = (ir / np.sqrt(np.sum(ir * ir))).astype(np.float32)
    ringbuf = np.zeros(ir_len, np.complex64)
    rpos = 0
    pos = 0.0
    out = []
    for sample in x.astype(np.complex64):
        idx = 0
        for i in range(rpos, ir_len):
            ringbuf[i] += sample * ir[idx]
            idx += 1
        for i in range(0, rpos):
            ringbuf[i] += sample * ir[idx]
            idx += 1
        while pos < output_rate:
            out.append(ringbuf[rpos])
            ringbuf[rpos] = 0
            rpos += 1
            if rpos >= ir_len:
                rpos = 0
            pos += input_rate
        pos -= output_rate
    return np.array(out, np.complex64)


def oracle_filter_chunks(chunks, sample_rate, freq_resp, window):
    """Reference Filter (src/blocks/filters.rs:184-259) with emulated
    unnormalized rustfft transforms.  Returns the list of emitted output
    chunks (one fewer than input chunks)."""
    n = len(chunks[0])
    scale = 2.0 * n * n
    resp = np.zeros(n, np.complex128)
    max_bin = (n - 1) // 2
    freq_step = sample_rate / n
    for i in range(max_bin + 1):
        resp[i] = freq_resp(i, i * freq_step) / scale
        if i > 0:
            resp[n - i] = freq_resp(-i, -i * freq_step) / scale
    # rustfft unnormalized inverse = numpy ifft * n
    time = np.fft.ifft(resp) * n
    half = n // 2
    # Literal reference swap loop (filters.rs:201-203): swap(i, i+n/2) for
    # i in 0..n/2 — a block swap of [0,half) and [half,2*half); for odd n
    # the last element stays in place (NOT a rotation).
    time = np.concatenate([time[half:2 * half], time[:half],
                           time[2 * half:]])
    w = window_table(window, n)
    e_pre = np.sum(np.abs(time) ** 2)
    time = time * w
    e_post = np.sum(np.abs(time) ** 2)
    time = time * np.sqrt(e_pre / e_post)
    ext = np.concatenate([np.zeros(n, np.complex64),
                          time.astype(np.complex64)])
    # f32 forward unnormalized FFT of the extended response
    ext_resp = np.fft.fft(ext.astype(np.complex64)).astype(np.complex64)
    outs = []
    prev = None
    for chunk in chunks:
        if prev is not None:
            buf = np.concatenate([prev, chunk]).astype(np.complex64)
            spec = np.fft.fft(buf).astype(np.complex64) * ext_resp
            # rustfft's inverse is unnormalized: np.fft.ifft * 2n.  The
            # 1/(2n^2) folded into the response above cancels it overall.
            y = (np.fft.ifft(spec) * (2 * n)).astype(np.complex64)
            outs.append(y[:n])
        prev = np.asarray(chunk)
    return outs
