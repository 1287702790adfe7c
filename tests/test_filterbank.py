"""FilterBank: K bands sharing one forward transform (graph bank nodes).

Per-band outputs must be identical to standalone Filter blocks over the
same stream (shared-transform linearity of overlap-save filtering,
reference design pipeline src/blocks/filters.rs:184-239), including reset
semantics and time sharding.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radiorust_tpu.blocks.base import StreamSig, scan
from radiorust_tpu.blocks.filters import Filter, FilterBank
from radiorust_tpu.blocks.graph import Graph, graph_scan
from radiorust_tpu.blocks.modulation import FmDemod
from radiorust_tpu.blocks.transform import GainControl


def _lowpass(bins, freqs):
    return np.where(np.abs(freqs) <= 2000.0, 1.0 + 0.0j, 0.0j)


def _bandpass(bins, freqs):
    keep = (freqs >= 1000.0) & (freqs <= 3000.0)  # one-sided (analytic)
    return np.where(keep, 2.0 + 0.0j, 0.0j)


def _highpass(bins, freqs):
    return np.where(np.abs(freqs) >= 2500.0, 1.0 + 0.0j, 0.0j)


BANDS = [_lowpass, _bandpass, _highpass]


def _chunks(steps=4, batch=2, n=128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((steps, batch, n))
            + 1j * rng.standard_normal((steps, batch, n))
            ).astype(np.complex64)


def test_bank_matches_standalone_filters():
    sig = StreamSig(2, 128, 8000.0)
    bank = FilterBank(BANDS).bind(sig)
    xs = _chunks()
    state = bank.init_state()
    outs = [[] for _ in BANDS]
    reset = np.zeros((2,), bool)
    for s in range(xs.shape[0]):
        state, ys = bank.process(bank.params, state, jnp.asarray(xs[s]),
                                 reset)
        for j, y in enumerate(ys):
            outs[j].append(np.asarray(y))
    for j, fr in enumerate(BANDS):
        f = Filter.new(fr).bind(sig)
        _, want = scan(f, f.params, f.init_state(), jnp.asarray(xs))
        np.testing.assert_allclose(np.stack(outs[j]), np.asarray(want),
                                   atol=2e-5)


def test_bank_reset_matches_filter_reset():
    sig = StreamSig(2, 128, 8000.0)
    bank = FilterBank([_lowpass]).bind(sig)
    f = Filter.new(_lowpass).bind(sig)
    xs = _chunks(steps=3, seed=1)
    # Reset stream 0 only, at step 1.
    resets = np.zeros((3, 2), bool)
    resets[1, 0] = True
    sb, sf = bank.init_state(), f.init_state()
    for s in range(3):
        sb, yb = bank.process(bank.params, sb, jnp.asarray(xs[s]),
                              jnp.asarray(resets[s]))
        sf, yf = f.process(f.params, sf, jnp.asarray(xs[s]),
                           jnp.asarray(resets[s]))
        np.testing.assert_allclose(np.asarray(yb[0]), np.asarray(yf),
                                   atol=2e-5)


def test_graph_bank_nodes_match_filter_nodes():
    sig = StreamSig(2, 128, 8000.0)
    xs = _chunks(steps=3, seed=2)

    def build(use_bank):
        g = Graph()
        x = g.input("x")
        if use_bank:
            lo, bp, hi = g.bank(FilterBank(BANDS), x)
        else:
            lo = g.add(Filter.new(_lowpass), x)
            bp = g.add(Filter.new(_bandpass), x)
            hi = g.add(Filter.new(_highpass), x)
        g.output("lo", g.add(GainControl(0.5), lo))
        g.output("bp", bp)
        g.output("hi", hi)
        return g.bind({"x": sig})

    ga, gb = build(True), build(False)
    _, ya = graph_scan(ga, ga.params, ga.init_state(), {"x": jnp.asarray(xs)})
    _, yb = graph_scan(gb, gb.params, gb.init_state(), {"x": jnp.asarray(xs)})
    assert ga.valid_from == gb.valid_from
    for k in ya:
        np.testing.assert_allclose(np.asarray(ya[k]), np.asarray(yb[k]),
                                   atol=2e-5)


def test_bank_realness_per_band():
    # After FM demod the stream is real; the symmetric low-pass preserves
    # realness, the one-sided bandpass does not.
    g = Graph()
    x = g.input("x")
    d = g.add(FmDemod(1000.0), x)
    lo, bp, hi = g.bank(FilterBank(BANDS), d)
    g.output("lo", lo)
    g.output("bp", bp)
    g.output("hi", hi)
    bg = g.bind({"x": StreamSig(2, 128, 8000.0)})
    outs = {name: i for name, i in bg._outputs.items()}
    assert bg.bound[outs["lo"]].output_is_real is True
    assert bg.bound[outs["bp"]].output_is_real is False
    assert bg.bound[outs["hi"]].output_is_real is True


def test_bank_node_is_not_a_stream():
    g = Graph()
    x = g.input("x")
    g.bank(FilterBank(BANDS), x)
    from radiorust_tpu.blocks.graph import NodeRef
    with pytest.raises(ValueError, match="bank node"):
        g.add(GainControl(1.0), NodeRef(1))  # the bank node itself


def test_bank_update_params_retunes_all_bands():
    sig = StreamSig(1, 128, 8000.0)
    bank = FilterBank([_lowpass, _highpass]).bind(sig)
    new = bank.update_params([_highpass, _lowpass])
    xs = _chunks(steps=2, batch=1, seed=3)
    sb = bank.init_state()
    for s in range(2):
        sb, ys = bank.process(new, sb, jnp.asarray(xs[s]),
                              np.zeros((1,), bool))
    f = Filter.new(_highpass).bind(sig)
    _, want = scan(f, f.params, f.init_state(), jnp.asarray(xs))
    np.testing.assert_allclose(np.asarray(ys[0]), np.asarray(want)[-1],
                               atol=2e-5)


def test_bank_time_shards():
    from radiorust_tpu.parallel.time_shard import TimeShardedGraph

    mesh = jax.make_mesh((4,), ("t",))
    sig = StreamSig(2, 128, 8000.0)
    g = Graph()
    x = g.input("x")
    lo, bp, hi = g.bank(FilterBank(BANDS), x)
    g.output("lo", lo)
    g.output("bp", bp)
    g.output("hi", hi)
    bg = g.bind({"x": sig})

    steps, t, n = 2, 4, 128
    xs = _chunks(steps=steps * t, seed=4)
    _, want = graph_scan(bg, bg.params, bg.init_state(),
                         {"x": jnp.asarray(xs)})

    tsg = TimeShardedGraph(bg, mesh, t_axis="t")
    st = tsg.init_state()
    got = {k: [] for k in bg.out_sigs}
    for s in range(steps):
        group = xs[s * t: (s + 1) * t]
        x_big = np.moveaxis(group, 0, 1).reshape(2, t * n)
        st, ys = tsg.process(tsg.params, st, {"x": jnp.asarray(x_big)})
        for k in got:
            got[k].append(np.moveaxis(
                np.asarray(ys[k]).reshape(2, t, n), 1, 0))
    for k in got:
        np.testing.assert_allclose(np.concatenate(got[k], axis=0),
                                   np.asarray(want[k]), atol=2e-5)
