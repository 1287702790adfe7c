"""Multi-device tests on the virtual 8-CPU mesh: time sharding with halo
exchange must be numerically identical to sequential chunk scanning."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from radiorust_tpu.blocks.base import Chain, StreamSig, scan
from radiorust_tpu.blocks.analysis import Fourier
from radiorust_tpu.blocks.chunks import Overlapper
from radiorust_tpu.blocks.filters import Filter
from radiorust_tpu.blocks.modulation import FmDemod, FmMod
from radiorust_tpu.blocks.resampling import Downsampler, Upsampler
from radiorust_tpu.blocks.transform import FreqShifter, GainControl, MapSample
from radiorust_tpu.models.analog import _envelope
from radiorust_tpu.models.wfm import wfm_receiver
from radiorust_tpu.parallel.time_shard import TimeShardedChain


def lowpass(cut):
    def resp(bins, freqs):
        return np.where(np.abs(freqs) <= cut, 1.0 + 0.0j, 0.0j)
    return resp


def sequential_reference(bound, xs):
    state, ys = scan(bound, bound.params, bound.init_state(), jnp.asarray(xs))
    return np.asarray(ys)


def make_iq(t, batch, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, batch, n))
            + 1j * rng.standard_normal((t, batch, n))).astype(np.complex64)


@pytest.fixture(scope="module")
def devices():
    d = jax.devices()
    assert len(d) >= 8, "tests need the 8-device virtual CPU platform"
    return d


def run_time_sharded(chain, sig, xs, mesh, steps, t_axis="t", ch_axis=None,
                     overlap=1):
    bound = chain.bind(sig)
    ts = TimeShardedChain(bound, mesh, t_axis=t_axis, ch_axis=ch_axis,
                          overlap=overlap)
    d = mesh.shape[t_axis]
    t, b, n = xs.shape
    assert t == steps * d
    state = ts.init_state()
    outs = []
    for s in range(steps):
        group = xs[s * d: (s + 1) * d]              # [D, b, n]
        x_big = np.moveaxis(group, 0, 1).reshape(b, d * n)
        state, y = ts.process(ts.params, state, jnp.asarray(x_big))
        y = np.asarray(y)
        out_n = bound.out_sig.chunk_len
        out_b = bound.out_sig.batch
        outs.append(np.moveaxis(y.reshape(out_b, d, out_n), 1, 0))
    return np.concatenate(outs, axis=0), bound


CASES = [
    ("shift", Chain(FreqShifter.with_shift(1000.0)),
     StreamSig(2, 64, 8000.0)),
    ("filter", Chain(Filter.new(lowpass(2000.0))),
     StreamSig(2, 64, 8000.0)),
    ("downsample", Chain(Downsampler(1000.0, 400.0)),
     StreamSig(2, 64, 8000.0)),
    ("upsample", Chain(Upsampler(16000.0, 3000.0)),
     StreamSig(2, 64, 8000.0)),
    ("up_then_down", Chain(Upsampler(16000.0, 3000.0),
                           Downsampler(4000.0, 1500.0)),
     StreamSig(2, 64, 8000.0)),
    ("demod", Chain(FmDemod(1000.0)), StreamSig(2, 64, 8000.0)),
    ("fmmod", Chain(FmMod(1000.0)), StreamSig(2, 64, 8000.0)),
    ("gain", Chain(GainControl(0.5)), StreamSig(2, 64, 8000.0)),
    ("mixed", Chain(FreqShifter.with_shift(500.0), Filter.new(lowpass(2000.0)),
                    FmDemod(1000.0), GainControl(2.0)),
     StreamSig(2, 64, 8000.0)),
    # Overlapper needs a multi-hop halo: chunk_count 4 spans 3 neighbor
    # chunks (the bandwidth_meter analysis front end).
    ("overlap_fourier", Chain(Overlapper(4), Fourier()),
     StreamSig(2, 64, 8000.0)),
    ("overlap_deep", Chain(Overlapper(6)), StreamSig(2, 64, 8000.0)),
    # An AM-receiver-shaped chain: the MapSample envelope's real_output
    # promise must survive sharding (the downstream filter pair-packs).
    ("am_envelope", Chain(
        FreqShifter.with_shift(500.0), Downsampler(2000.0, 700.0),
        MapSample(_envelope, real_output=True),
        Filter.new_rectangular(
            lambda bins, freqs: np.where(
                (np.abs(bins) >= 1) & (np.abs(freqs) <= 700.0),
                1.0 + 0.0j, 0.0j)),
        GainControl(0.7),
    ), StreamSig(2, 64, 8000.0)),
]


@pytest.mark.parametrize("overlap", [2, 4])
def test_time_sharded_overlap_pipelining(devices, overlap):
    """``overlap=S`` sub-batch software pipelining (halo/compute overlap,
    docs/SCALING.md) must be BIT-exact vs overlap=1 — per-stream rows
    never couple, the split only reorders independent dataflow — and
    match sequential scanning like any sharded run."""
    sig = StreamSig(4, 64, 8000.0)
    chain = Chain(FreqShifter.with_shift(500.0),
                  Filter.new(lowpass(2000.0)),
                  FmDemod(1000.0), GainControl(2.0))
    mesh = jax.make_mesh((4,), ("t",))
    steps = 3
    xs = make_iq(steps * 4, sig.batch, sig.chunk_len, seed=7)
    base, _ = run_time_sharded(chain, sig, xs, mesh, steps)
    got, bound = run_time_sharded(chain, sig, xs, mesh, steps,
                                  overlap=overlap)
    np.testing.assert_array_equal(got, base)
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_time_sharded_overlap_rejects_odd_batch(devices):
    sig = StreamSig(3, 64, 8000.0)
    chain = Chain(GainControl(1.0))
    mesh = jax.make_mesh((4,), ("t",))
    ts = TimeShardedChain(chain.bind(sig), mesh, overlap=2)
    x = np.zeros((3, 4 * 64), np.complex64)
    with pytest.raises(ValueError, match="not divisible by overlap"):
        ts.process(ts.params, ts.init_state(), jnp.asarray(x))


def test_time_sharded_phase_mode_resampler(devices):
    """Arbitrary-chunk (phase-mode) resampler under time sharding: each
    device derives its grid phase in closed form; the padded per-chunk
    output layout must match sequential stepping exactly."""
    from radiorust_tpu.blocks.resampling import Downsampler
    mesh = jax.make_mesh((4,), ("t",))
    sig = StreamSig(2, 100, 1024.0)          # 100 % 8 != 0 -> phase mode
    chain = Chain(Downsampler(384.0, 200.0))
    steps = 3
    xs = make_iq(steps * 4, sig.batch, sig.chunk_len, seed=31)
    got, bound = run_time_sharded(chain, sig, xs, mesh, steps)
    assert bound.ragged_output
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("name,chain,sig", CASES, ids=[c[0] for c in CASES])
def test_time_sharded_matches_sequential(devices, name, chain, sig):
    mesh = jax.make_mesh((4,), ("t",))
    steps = 3
    xs = make_iq(steps * 4, sig.batch, sig.chunk_len, seed=hash(name) % 100)
    got, bound = run_time_sharded(chain, sig, xs, mesh, steps)
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_time_sharded_squelch_gate_toggles(devices):
    # The squelch envelope is affine in its carry, so it time-shards via
    # an exclusive prefix of per-device affine maps; the gate must open
    # and close at exactly the sequential sample positions even when
    # bursts straddle device boundaries.
    from radiorust_tpu.blocks.transform import Squelch
    mesh = jax.make_mesh((4,), ("t",))
    n = 64
    sig = StreamSig(2, n, 8000.0)
    chain = Chain(Squelch(threshold=0.25, alpha=0.8))
    steps = 3
    T = steps * 4
    t = np.arange(T * n)
    on = ((t // 96) % 2 == 0)  # bursts not aligned to chunk/device edges
    x = on * np.exp(2j * np.pi * 0.03 * t) + 0.01 * np.exp(1j * 0.1 * t)
    xs = np.stack([x, 0.7 * x]).astype(np.complex64)
    xs = np.moveaxis(xs.reshape(2, T, n), 1, 0)
    got, _ = run_time_sharded(chain, sig, xs, mesh, steps)
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_time_sharded_agc_matches_sequential(devices):
    # AGC's gain update is a clamped-affine map; the time-shard handler
    # composes each device's chunk into one map and seeds the carry via
    # an exclusive prefix — the adapting gain trajectory must match the
    # sequential scan even while the loop is actively converging and
    # clamping across device boundaries.
    from radiorust_tpu.blocks.transform import AgcControl
    mesh = jax.make_mesh((4,), ("t",))
    n = 64
    sig = StreamSig(2, n, 8000.0)
    chain = Chain(AgcControl(reference=1.0, rate=5e-2, max_gain=4.0))
    steps = 3
    T = steps * 4
    t = np.arange(T * n)
    # Weak signal (gain rises, clamps at max_gain) then a loud burst
    # (gain slams down): both regimes cross device boundaries.
    amp = np.where((t // 160) % 2 == 0, 0.05, 2.0)
    x = (amp * np.exp(2j * np.pi * 0.03 * t)).astype(np.complex64)
    xs = np.stack([x, 0.5 * x]).astype(np.complex64)
    xs = np.moveaxis(xs.reshape(2, T, n), 1, 0)
    got, _ = run_time_sharded(chain, sig, xs, mesh, steps)
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_time_and_channel_sharded_wfm(devices):
    # Full WFM chain on a 2x4 (channel x time) mesh, tiny shapes.
    mesh = jax.make_mesh((2, 4), ("ch", "t"))
    n = 2048
    sig = StreamSig(2, n, 1024000.0)
    steps = 2
    rng = np.random.default_rng(42)
    t = np.arange(steps * 4 * n) / 1024000.0
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * (2 * np.pi * 150000.0 / 1024000.0 * np.cumsum(audio)))
    xs = np.stack([iq, iq * np.exp(0.5j)]).astype(np.complex64)  # [b, T*n]
    xs = np.moveaxis(xs.reshape(2, steps * 4, n), 1, 0)          # [T, b, n]
    got, bound = run_time_sharded(wfm_receiver(), sig, xs, mesh, steps,
                                  ch_axis="ch")
    want = sequential_reference(wfm_receiver().bind(sig), xs)
    # Warmup chunks (zero-primed filter tails) pass near-zero garbage into
    # the chaotic arctan2 demodulator, where FFT-implementation rounding
    # differences blow up; the reference emits nothing there.  Steady state
    # must agree tightly.
    np.testing.assert_allclose(got[2:], want[2:], atol=5e-4)


def test_time_sharded_channelizer_64ch(devices):
    """The 64-channel receiver (Channelizer + per-channel FmDemod) under
    time sharding == sequential scan (raw-input halo plus the demod's
    one-sample continuity per channel)."""
    from radiorust_tpu.models.channelizer import channelized_receiver
    mesh = jax.make_mesh((4,), ("t",))
    m, n, rate = 64, 1024, 1024000.0
    sig = StreamSig(1, n, rate)
    chain = channelized_receiver(num_channels=m, input_rate=rate)
    steps = 2
    xs = make_iq(steps * 4, 1, n, seed=13)
    got, bound = run_time_sharded(chain, sig, xs, mesh, steps)
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_time_sharded_channelized_receiver(devices):
    from radiorust_tpu.models.channelizer import channelized_receiver
    mesh = jax.make_mesh((4,), ("t",))
    m, n, rate = 8, 256, 80000.0
    sig = StreamSig(1, n, rate)
    chain = channelized_receiver(num_channels=m, input_rate=rate)
    steps = 2
    rng = np.random.default_rng(9)
    xs = (rng.standard_normal((steps * 4, 1, n))
          + 1j * rng.standard_normal((steps * 4, 1, n))).astype(np.complex64)
    got, bound = run_time_sharded(chain, sig, xs, mesh, steps)
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_time_sharded_wfm_chunk4096(devices):
    """The literal WFM chain at a 4096-sample chunk (mid chunk 1536)
    time-shards: every block's halo rebuilt over the mesh must match
    sequential scanning of the same chain."""
    mesh = jax.make_mesh((4,), ("t",))
    n = 4096
    sig = StreamSig(2, n, 1024000.0)
    chain = wfm_receiver()
    steps = 2
    t = np.arange(steps * 4 * n) / 1024000.0
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * (2 * np.pi * 150000.0 / 1024000.0 * np.cumsum(audio)))
    xs = np.stack([iq, iq * np.exp(0.5j)]).astype(np.complex64)
    xs = np.moveaxis(xs.reshape(2, steps * 4, n), 1, 0)
    got, bound = run_time_sharded(chain, sig, xs, mesh, steps)
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got[2:], want[2:], atol=5e-4)


def test_time_sharded_decoupled_geometry_wfm(devices):
    """The decoupled overlap-save geometry (filter_ir_len < mid chunk)
    time-shards: the halo shrinks to the IR length; must match sequential
    scanning of the same decoupled chain."""
    mesh = jax.make_mesh((4,), ("t",))
    n = 4096  # mid chunk 1536, IRs at 512 taps -> 2048-pt transforms
    sig = StreamSig(2, n, 1024000.0)
    chain = wfm_receiver(filter_ir_len=512)
    steps = 2
    t = np.arange(steps * 4 * n) / 1024000.0
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * (2 * np.pi * 150000.0 / 1024000.0 * np.cumsum(audio)))
    xs = np.stack([iq, iq * np.exp(0.5j)]).astype(np.complex64)
    xs = np.moveaxis(xs.reshape(2, steps * 4, n), 1, 0)
    got, bound = run_time_sharded(chain, sig, xs, mesh, steps)
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got[2:], want[2:], atol=5e-4)


def test_time_sharded_wfm_fused_deemphasis(devices):
    """The WFM chain with the deemphasis filter folded into the final
    decimating FIR (a long-history resampler) time-shards and matches
    sequential scanning of the same chain."""
    mesh = jax.make_mesh((4,), ("t",))
    n = 4096
    sig = StreamSig(2, n, 1024000.0)
    chain = wfm_receiver(fuse_deemphasis=True)
    steps = 2
    t = np.arange(steps * 4 * n) / 1024000.0
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * (2 * np.pi * 150000.0 / 1024000.0 * np.cumsum(audio)))
    xs = np.stack([iq, iq * np.exp(0.5j)]).astype(np.complex64)
    xs = np.moveaxis(xs.reshape(2, steps * 4, n), 1, 0)
    got, bound = run_time_sharded(chain, sig, xs, mesh, steps)
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got[2:], want[2:], atol=5e-4)


def test_time_sharded_shift_decimate_front_end(devices):
    """The WFM front end (FreqShifter + Downsampler to 384 kHz) alone,
    random IQ (harsher than the smooth FM tone): the mixer's closed-form
    phase and the decimator's history halo must agree with sequential
    execution."""
    mesh = jax.make_mesh((4,), ("t",))
    n = 2048
    sig = StreamSig(2, n, 1024000.0)
    chain = Chain(FreqShifter.with_shift(-57000.0),
                  Downsampler(384000.0, 200000.0))
    steps = 3
    xs = make_iq(steps * 4, 2, n, seed=5)
    got, bound = run_time_sharded(chain, sig, xs, mesh, steps)
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got, want, atol=2e-4)


def _random_chain(rng):
    """Random composition with tracked (rate, chunk_len); exercises halo
    handler composition in orders the fixed CASES don't."""
    rate, n = 8000.0, 64
    specs = []
    n_down = 0
    for _ in range(int(rng.integers(2, 5))):
        kind = rng.choice(["shift", "filter", "gain", "demod", "mod",
                           "down"])
        if kind == "shift":
            specs.append(FreqShifter.with_shift(float(rate) / 16.0))
        elif kind == "filter":
            specs.append(Filter.new(lowpass(rate / 4.0)))
        elif kind == "gain":
            specs.append(GainControl(1.5))
        elif kind == "demod":
            specs.append(FmDemod(rate / 8.0))
        elif kind == "mod":
            specs.append(FmMod(rate / 8.0))
        elif kind == "down":
            if n_down >= 1 or n < 32:
                specs.append(GainControl(0.5))
            else:
                specs.append(Downsampler(rate / 2.0, rate / 4.0))
                rate, n = rate / 2.0, n // 2
                n_down += 1
    return Chain(*specs)


@pytest.mark.parametrize("seed", range(6))
def test_time_sharded_random_chains(devices, seed):
    rng = np.random.default_rng(seed)
    chain = _random_chain(rng)
    sig = StreamSig(2, 64, 8000.0)
    mesh = jax.make_mesh((4,), ("t",))
    steps = 3
    xs = make_iq(steps * 4, sig.batch, sig.chunk_len, seed=seed + 50)
    got, bound = run_time_sharded(chain, sig, xs, mesh, steps)
    want = sequential_reference(chain.bind(sig), xs)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_time_sharded_graph_fanout(devices):
    """A DAG with a fan-out tap time-shards: both outputs match graph_scan
    of the same bound graph run sequentially."""
    from radiorust_tpu.blocks.graph import Graph, graph_scan
    from radiorust_tpu.parallel.time_shard import TimeShardedGraph

    sig = StreamSig(2, 64, 8000.0)
    g = Graph()
    src = g.input("iq")
    mid = g.add(FreqShifter.with_shift(500.0), src)
    g.output("a", g.add(Filter.new(lowpass(2000.0)), mid))
    g.output("b", g.add(FmDemod(1000.0), mid))
    bg = g.bind(sig)

    d, steps = 4, 3
    mesh = jax.make_mesh((d,), ("t",))
    xs = make_iq(steps * d, 2, 64, seed=11)
    _, want = graph_scan(bg, bg.params, bg.init_state(),
                         {"iq": jnp.asarray(xs)})

    ts = TimeShardedGraph(bg, mesh, t_axis="t")
    state = ts.init_state()
    got = {"a": [], "b": []}
    for s in range(steps):
        group = xs[s * d: (s + 1) * d]
        x_big = np.moveaxis(group, 0, 1).reshape(2, d * 64)
        state, ys = ts.process(ts.params, state, {"iq": jnp.asarray(x_big)})
        for k in got:
            out_n = bg.out_sigs[k].chunk_len
            got[k].append(np.moveaxis(
                np.asarray(ys[k]).reshape(2, d, out_n), 1, 0))
    for k in got:
        np.testing.assert_allclose(np.concatenate(got[k], axis=0),
                                   np.asarray(want[k]), atol=2e-4)


def test_time_sharded_graph_wfm_spectrum(devices):
    """The flagship DAG (WFM audio + spectrum tap) on a time mesh."""
    from radiorust_tpu.blocks.graph import graph_scan
    from radiorust_tpu.models.wfm import wfm_receiver_graph
    from radiorust_tpu.parallel.time_shard import TimeShardedGraph

    d, steps, n = 4, 2, 2048
    sig = StreamSig(2, n, 1024000.0)
    bg = wfm_receiver_graph().bind(sig)
    mesh = jax.make_mesh((d,), ("t",))
    t = np.arange(steps * d * n) / 1024000.0
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * (2 * np.pi * 150000.0 / 1024000.0 * np.cumsum(audio)))
    xs = np.stack([iq, iq * np.exp(0.5j)]).astype(np.complex64)
    xs = np.moveaxis(xs.reshape(2, steps * d, n), 1, 0)
    _, want = graph_scan(bg, bg.params, bg.init_state(),
                         {"iq": jnp.asarray(xs)})

    ts = TimeShardedGraph(bg, mesh)
    state = ts.init_state()
    got = {k: [] for k in bg.out_sigs}
    for s in range(steps):
        group = xs[s * d: (s + 1) * d]
        x_big = np.moveaxis(group, 0, 1).reshape(2, d * n)
        state, ys = ts.process(ts.params, state, {"iq": jnp.asarray(x_big)})
        for k in got:
            out_n = bg.out_sigs[k].chunk_len
            got[k].append(np.moveaxis(
                np.asarray(ys[k]).reshape(2, d, out_n), 1, 0))
    # Audio passes through the chaotic demod: skip the zero-primed warmup
    # chunks like the chain tests; the spectrum path is linear, check all.
    np.testing.assert_allclose(
        np.concatenate(got["audio"], axis=0)[2:],
        np.asarray(want["audio"])[2:], atol=5e-4)
    np.testing.assert_allclose(
        np.concatenate(got["spectrum"], axis=0),
        np.asarray(want["spectrum"]), atol=2e-2)


def test_jit_step_sharded_phase_mode_resampler():
    """Data-parallel (stream-axis) sharding of a phase-mode resampler:
    the [b] int32 phase leaf shards with the batch (each shard carries
    its rows' replicated phase) and outputs equal the single-device
    program — which is why the actor's mesh guard allows shard='streams'
    and rejects only the channel/time group wrappers."""
    import jax
    from jax.sharding import Mesh

    from radiorust_tpu.blocks.base import (Chain, StreamSig, jit_step,
                                           jit_step_sharded, pack_wire)
    from radiorust_tpu.blocks.resampling import Downsampler
    from radiorust_tpu.blocks.transform import GainControl

    mesh = Mesh(np.array(jax.devices()[:4]), ("streams",))
    chain = Chain(GainControl(0.5), Downsampler(384.0, 200.0))
    sig = StreamSig(8, 100, 1024.0)          # 100 % 8 != 0 -> phase mode
    bound = chain.bind(sig)
    assert bound.ragged_output
    rng = np.random.default_rng(17)
    x = (rng.standard_normal((8, 100))
         + 1j * rng.standard_normal((8, 100))).astype(np.complex64)
    reset = np.zeros((8,), bool)
    pp, ps, px = (pack_wire(bound.params), pack_wire(bound.init_state()),
                  pack_wire(x))
    s1, y1 = jit_step(bound)(pp, ps, px, reset)
    s2, y2 = jit_step_sharded(bound, mesh, "streams")(pp, ps, px, reset)
    for a, b in zip(jax.tree.leaves((s1, y1)), jax.tree.leaves((s2, y2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jit_step_sharded_matches_single_device():
    """Data-parallel serving step (blocks.base.jit_step_sharded): the
    stream-batch axis shards over the mesh, params replicate; outputs are
    identical to the single-device program."""
    import jax
    from jax.sharding import Mesh

    from radiorust_tpu.blocks.base import (Chain, StreamSig, jit_step,
                                           jit_step_sharded, pack_wire,
                                           unpack_wire)
    from radiorust_tpu.blocks.filters import Filter
    from radiorust_tpu.blocks.modulation import FmDemod
    from radiorust_tpu.blocks.transform import FreqShifter, GainControl

    mesh = Mesh(np.array(jax.devices()[:4]), ("streams",))
    chain = Chain(
        FreqShifter.with_shift(1000.0),
        Filter.new(lambda b, f: np.where(np.abs(f) <= 2000.0, 1.0, 0.0)),
        FmDemod(1500.0),
        GainControl(0.5),
    )
    sig = StreamSig(8, 256, 8000.0)
    bound = chain.bind(sig)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((8, 256))
         + 1j * rng.standard_normal((8, 256))).astype(np.complex64)
    reset = np.zeros((8,), bool)

    pp, ps, px = (pack_wire(bound.params), pack_wire(bound.init_state()),
                  pack_wire(x))
    s1, y1 = jit_step(bound)(pp, ps, px, reset)
    s2, y2 = jit_step_sharded(bound, mesh, "streams")(pp, ps, px, reset)
    # Same math per stream, but XLA picks different kernels for the local
    # batch shape, so expect f32 summation-order noise (same tolerance as
    # the time-sharding cases above).
    np.testing.assert_allclose(np.asarray(unpack_wire(y2)),
                               np.asarray(unpack_wire(y1)), atol=5e-4)
    for a, b in zip(jax.tree.leaves(s1), jax.tree.leaves(s2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-4)

    with pytest.raises(ValueError, match="cannot shard"):
        jit_step_sharded(chain.bind(StreamSig(6, 256, 8000.0)),
                         mesh, "streams")


def test_jit_step_sharded_conditioning_blocks():
    """Squelch/AGC per-stream loop state ([batch] leaves) splits cleanly
    under data-parallel serving: identical to the single-device step."""
    import jax
    from jax.sharding import Mesh

    from radiorust_tpu.blocks.base import (Chain, StreamSig, jit_step,
                                           jit_step_sharded, pack_wire,
                                           unpack_wire)
    from radiorust_tpu.blocks.transform import AgcControl, Squelch

    mesh = Mesh(np.array(jax.devices()[:4]), ("streams",))
    chain = Chain(Squelch(threshold=1e-3, alpha=0.9),
                  AgcControl(reference=0.5, rate=5e-2))
    sig = StreamSig(8, 128, 8000.0)
    bound = chain.bind(sig)
    rng = np.random.default_rng(13)
    x = (0.2 * (rng.standard_normal((8, 128))
                + 1j * rng.standard_normal((8, 128)))).astype(np.complex64)
    # Mute half the streams so gates differ per stream.
    x[1::2] *= 1e-3
    reset = np.zeros((8,), bool)
    pp, ps, px = (pack_wire(bound.params), pack_wire(bound.init_state()),
                  pack_wire(x))
    s1, y1 = jit_step(bound)(pp, ps, px, reset)
    s2, y2 = jit_step_sharded(bound, mesh, "streams")(pp, ps, px, reset)
    np.testing.assert_allclose(np.asarray(unpack_wire(y2)),
                               np.asarray(unpack_wire(y1)), atol=5e-4)
    for a, b in zip(jax.tree.leaves(s1), jax.tree.leaves(s2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-4)


def test_runtime_block_mesh_serving_matches_unsharded():
    """RuntimeBlock(mesh=...): batched [streams, n] chunks shard the
    stream axis across the mesh; values and state carry match the
    unsharded actor, and non-divisible batches fall back."""
    import asyncio

    import jax
    from jax.sharding import Mesh

    from radiorust_tpu.blocks.transform import FreqShifter
    from radiorust_tpu.runtime import ArraySink, RuntimeBlock
    from radiorust_tpu.runtime.flow import new_sender
    from radiorust_tpu.signal import Samples

    rng = np.random.default_rng(5)
    xs = (rng.standard_normal((4, 8, 128))
          + 1j * rng.standard_normal((4, 8, 128))).astype(np.complex64)

    async def drive(mesh):
        sender, connector = new_sender()
        blk = RuntimeBlock(FreqShifter.with_shift(500.0), mesh=mesh)
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        for t in range(4):
            await sender.send(Samples(8000.0, xs[t]))
        # One single-stream (1-D) chunk exercises the fallback path.
        await sender.send(Samples(8000.0, xs[0, 0]))
        for _ in range(500):
            if len(sink.chunks) >= 5:
                break
            await asyncio.sleep(0.01)
        return sink.chunks

    mesh = Mesh(np.array(jax.devices()), ("streams",))
    got = asyncio.run(drive(mesh))
    want = asyncio.run(drive(None))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-4)


def test_runtime_block_time_shard_serving_matches_unsharded():
    """RuntimeBlock(mesh=..., shard="time"): one stream served by the
    whole mesh — each D*chunk_len group chunk splits into D consecutive
    device chunks with halo exchange.  Values match the plain actor fed
    the same groups; live set_gain retunes mid-stream; a chunk length
    that does not divide the mesh falls back."""
    import asyncio

    import jax

    from radiorust_tpu.models.wfm import wfm_receiver
    from radiorust_tpu.runtime import ArraySink, RuntimeBlock
    from radiorust_tpu.runtime.flow import new_sender
    from radiorust_tpu.signal import Samples

    d, n, steps = 8, 1024, 3
    # Smooth FM input (demod of noise is chaotic through warmup).
    xs = make_iq(steps * d, 2, n, seed=31)          # [steps*d, 2, n]

    async def drive(mesh, spec=None, chunks=None, rate=1024000.0,
                    retune_at=None, overlap=1):
        sender, connector = new_sender()
        kw = ({"mesh": mesh, "shard": "time", "overlap": overlap}
              if mesh is not None else {})
        blk = RuntimeBlock(spec or wfm_receiver(), **kw)
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        for t in range(len(chunks)):
            if retune_at == t:
                blk.set_gain(0.25)
            await sender.send(Samples(rate, chunks[t]))
        for _ in range(2400):
            if len(sink.chunks) >= len(chunks):
                break
            await asyncio.sleep(0.025)
        return np.concatenate(sink.chunks, axis=-1)

    # The time-sharded actor consumes GROUP chunks of d per-device
    # chunks; the reference actor consumes the same stream chunk by
    # chunk — identical chain binding (chunk_len = n on both sides, so
    # identical filter designs), identical samples.  set_gain lands at
    # the same stream position (group boundary = d chunk boundary).
    groups = [np.concatenate([xs[g * d + i] for i in range(d)], axis=-1)
              for g in range(steps)]
    mesh = jax.make_mesh((8,), ("t",))
    # set_gain before streaming proves the typed setter routes into the
    # TimeShardedChain's params (mid-stream retune timing vs in-flight
    # chunks is covered by the dedicated retune tests).
    got = asyncio.run(drive(mesh, chunks=groups, retune_at=0))
    want = asyncio.run(drive(None, chunks=list(xs), retune_at=0))
    assert got.shape == want.shape
    out_n = got.shape[-1] // (steps * d)
    # First two output chunks are zero-primed warmup through the chaotic
    # arctan2 (same guard as the dryrun); steady state must match.
    np.testing.assert_allclose(got[:, 2 * out_n:], want[:, 2 * out_n:],
                               atol=5e-4)

    # overlap=2 sub-batch pipelining (SCALING.md halo/compute overlap):
    # per-stream rows never couple, but batch 2 splits to sub-batches of
    # ONE stream, where the real-output filter's pair-packed FFT falls
    # back to its single-plane form — identical math, different (equally
    # valid) f32 rounding, so compare within ulp-scale tolerance rather
    # than bitwise (bitwise equality at pair-preserving sub-batches is
    # covered by test_time_sharded_overlap_pipelining).
    got_ov = asyncio.run(drive(mesh, chunks=groups, retune_at=0,
                               overlap=2))
    np.testing.assert_allclose(got_ov[:, 2 * out_n:], got[:, 2 * out_n:],
                               atol=1e-5)

    # A chain time sharding rejects (SlewRateLimiter's sequential clamp)
    # falls back to the single-device program instead of crashing.
    from radiorust_tpu.models.morse_tx import morse_audio_chain
    env = [np.ones((2, 512), np.complex64)] * 2
    got_fb = asyncio.run(drive(mesh, spec=morse_audio_chain(),
                               chunks=env, rate=48000.0))
    want_fb = asyncio.run(drive(None, spec=morse_audio_chain(),
                                chunks=env, rate=48000.0))
    np.testing.assert_allclose(got_fb, want_fb, atol=5e-4)


def test_runtime_block_overlap_indivisible_falls_back_at_construction():
    """A trace-time capability rejection (batch 1 with overlap=2: the
    sub-batch split has nothing to split) must engage the single-device
    fallback at ACTOR CONSTRUCTION — the lazily-jitted sharded step used
    to defer the ValueError to the first served chunk, killing the
    stream after the fallback window had passed."""
    import asyncio

    import jax

    from radiorust_tpu.models.wfm import wfm_receiver
    from radiorust_tpu.runtime import ArraySink, RuntimeBlock
    from radiorust_tpu.runtime.flow import new_sender
    from radiorust_tpu.signal import Samples

    d, n, steps = 8, 1024, 2
    xs = make_iq(steps * d, 1, n, seed=33)          # batch-1 stream
    groups = [np.concatenate([xs[g * d + i] for i in range(d)], axis=-1)
              for g in range(steps)]
    mesh = jax.make_mesh((8,), ("t",))

    async def drive(mesh_, overlap):
        sender, connector = new_sender()
        kw = ({"mesh": mesh_, "shard": "time", "overlap": overlap}
              if mesh_ is not None else {})
        blk = RuntimeBlock(wfm_receiver(), **kw)
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        for g in groups:
            await sender.send(Samples(1024000.0, g))
        for _ in range(2400):
            if len(sink.chunks) >= len(groups):
                break
            await asyncio.sleep(0.025)
        assert len(sink.chunks) == len(groups), "stream died"
        return np.concatenate(sink.chunks, axis=-1)

    got = asyncio.run(drive(mesh, overlap=2))       # falls back, serves
    want = asyncio.run(drive(None, overlap=1))
    out_n = got.shape[-1] // (steps * d)
    np.testing.assert_allclose(got[:, 2 * out_n:], want[:, 2 * out_n:],
                               atol=5e-4)


def test_sharded_local_batch_divisibility():
    """jit_step_sharded refuses a stream batch that does not split evenly
    over the mesh axis (instead of failing inside the program), and on an
    even split matches the single-device program."""
    from radiorust_tpu.blocks.base import (StreamSig, jit_step,
                                           jit_step_sharded, pack_wire,
                                           unpack_wire)
    from radiorust_tpu.models.wfm import _deemphasis_band

    spec = Chain(FreqShifter.with_shift(1000.0), FmDemod(150000.0),
                 Filter.new_rectangular(_deemphasis_band))
    bound = spec.bind(StreamSig(6, 512, 384000.0))
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("streams",))
    assert not bound.shard_batch_ok(4)           # 6 streams over 4
    with pytest.raises(ValueError, match="per-shard constraint"):
        jit_step_sharded(bound, mesh4, "streams")

    # 6 streams over 2 devices: local batch 3 (odd, so the filter packs
    # no stream pairs) -> values match the single-device program.
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("streams",))
    assert bound.shard_batch_ok(2)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((6, 512))
         + 1j * rng.standard_normal((6, 512))).astype(np.complex64)
    reset = np.zeros((6,), bool)
    pp, ps, px = (pack_wire(bound.params), pack_wire(bound.init_state()),
                  pack_wire(x))
    _, y1 = jit_step(bound)(pp, ps, px, reset)
    _, y2 = jit_step_sharded(bound, mesh2, "streams")(pp, ps, px, reset)
    np.testing.assert_allclose(np.asarray(unpack_wire(y2)),
                               np.asarray(unpack_wire(y1)), atol=5e-4)


def test_runtime_block_mesh_indivisible_batch_falls_back():
    """RuntimeBlock(mesh=...) with a stream batch that does not split over
    the mesh: the actor falls back to the single-device program (no actor
    failure) and values match the unsharded actor."""
    import asyncio

    from radiorust_tpu.models.wfm import _deemphasis_band
    from radiorust_tpu.runtime import ArraySink, RuntimeBlock
    from radiorust_tpu.runtime.flow import new_sender
    from radiorust_tpu.signal import Samples

    rng = np.random.default_rng(9)
    xs = (rng.standard_normal((2, 6, 512))
          + 1j * rng.standard_normal((2, 6, 512))).astype(np.complex64)

    async def drive(mesh):
        sender, connector = new_sender()
        blk = RuntimeBlock(Chain(FmDemod(150000.0),
                                 Filter.new_rectangular(_deemphasis_band)),
                           mesh=mesh)
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        for t in range(2):
            await sender.send(Samples(384000.0, xs[t]))
        for _ in range(500):
            if len(sink.chunks) >= 2:
                break
            await asyncio.sleep(0.01)
        assert blk.failure is None
        return sink.chunks

    mesh = Mesh(np.array(jax.devices()), ("streams",))  # 6 over 8
    got = asyncio.run(drive(mesh))
    want = asyncio.run(drive(None))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-4)


def test_runtime_mesh_axis_validated_at_construction():
    """A typo'd mesh_axis (or mesh_axis without a mesh) raises in
    __init__, not as a deferred KeyError inside the actor coroutine."""
    from radiorust_tpu.runtime import RuntimeBlock

    mesh = Mesh(np.array(jax.devices()), ("streams",))
    with pytest.raises(ValueError, match="not an axis"):
        RuntimeBlock(GainControl(1.0), mesh=mesh, mesh_axis="stream")
    with pytest.raises(ValueError, match="without a mesh"):
        RuntimeBlock(GainControl(1.0), mesh_axis="streams")


def test_runtime_graph_mesh_serving_matches_unsharded():
    """RuntimeGraph(mesh=...): the graph path's dict-valued chunks/resets
    shard the stream axis the same way as the chain path; both named
    outputs match the unsharded graph actor."""
    import asyncio

    from radiorust_tpu.blocks.graph import Graph
    from radiorust_tpu.runtime import ArraySink, RuntimeGraph
    from radiorust_tpu.runtime.flow import new_sender
    from radiorust_tpu.signal import Samples

    def build():
        g = Graph()
        src = g.input("iq")
        mid = g.add(FreqShifter.with_shift(500.0), src)
        g.output("filt", g.add(Filter.new(lowpass(2000.0)), mid))
        g.output("demod", g.add(FmDemod(1500.0), mid))
        return g

    rng = np.random.default_rng(13)
    xs = (rng.standard_normal((3, 8, 256))
          + 1j * rng.standard_normal((3, 8, 256))).astype(np.complex64)

    async def drive(mesh):
        sender, connector = new_sender()
        rg = RuntimeGraph(build(), mesh=mesh)
        sink_f, sink_d = ArraySink(), ArraySink()
        rg.feed_from(type("P", (), {"sender_connector": connector})())
        sink_f.feed_from(rg.out("filt"))
        sink_d.feed_from(rg.out("demod"))
        for t in range(3):
            await sender.send(Samples(8000.0, xs[t]))
        for _ in range(500):
            if len(sink_f.chunks) >= 3 and len(sink_d.chunks) >= 3:
                break
            await asyncio.sleep(0.01)
        assert rg.failure is None
        return sink_f.chunks, sink_d.chunks

    mesh = Mesh(np.array(jax.devices()), ("streams",))
    got_f, got_d = asyncio.run(drive(mesh))
    want_f, want_d = asyncio.run(drive(None))
    assert len(got_f) == len(want_f) == 3
    for g, w in zip(got_f + got_d, want_f + want_d):
        np.testing.assert_allclose(g, w, atol=5e-4)


def test_runtime_graph_time_shard_serving_matches_unsharded():
    """RuntimeGraph(mesh=..., shard="time"): the DAG runs time-sharded —
    one stream, whole mesh, D*chunk_len group chunks; both named outputs
    match the plain graph actor fed the same per-device chunks."""
    import asyncio

    from radiorust_tpu.blocks.graph import Graph
    from radiorust_tpu.runtime import ArraySink, RuntimeGraph
    from radiorust_tpu.runtime.flow import new_sender
    from radiorust_tpu.signal import Samples

    def build():
        g = Graph()
        src = g.input("iq")
        mid = g.add(FreqShifter.with_shift(500.0), src)
        g.output("filt", g.add(Filter.new(lowpass(2000.0)), mid))
        g.output("demod", g.add(FmDemod(1500.0), mid))
        return g

    d, n, steps = 8, 256, 3
    xs = make_iq(steps * d, 2, n, seed=17)

    async def drive(mesh, chunks):
        sender, connector = new_sender()
        kw = {"mesh": mesh, "shard": "time"} if mesh is not None else {}
        rg = RuntimeGraph(build(), **kw)
        sink_f, sink_d = ArraySink(), ArraySink()
        rg.feed_from(type("P", (), {"sender_connector": connector})())
        sink_f.feed_from(rg.out("filt"))
        sink_d.feed_from(rg.out("demod"))
        for c in chunks:
            await sender.send(Samples(8000.0, c))
        for _ in range(1200):
            if (len(sink_f.chunks) >= len(chunks)
                    and len(sink_d.chunks) >= len(chunks)):
                break
            await asyncio.sleep(0.01)
        assert rg.failure is None
        return (np.concatenate(sink_f.chunks, axis=-1),
                np.concatenate(sink_d.chunks, axis=-1))

    groups = [np.concatenate([xs[g * d + i] for i in range(d)], axis=-1)
              for g in range(steps)]
    mesh = jax.make_mesh((8,), ("t",))
    got_f, got_d = asyncio.run(drive(mesh, groups))
    want_f, want_d = asyncio.run(drive(None, list(xs)))
    np.testing.assert_allclose(got_f, want_f, atol=5e-4)
    # Demod chunk 0 is zero-primed warmup through arctan2; skip it.
    np.testing.assert_allclose(got_d[:, n:], want_d[:, n:], atol=5e-4)


def test_runtime_graph_overlap_indivisible_falls_back_at_construction():
    """RuntimeGraph's time-shard binding has the same construction-time
    trace forcing as RuntimeBlock's: a batch-1 stream with overlap=2 (the
    sub-batch split has nothing to split — a trace-time ValueError) must
    engage the single-device fallback at actor construction, not kill
    the stream at its first chunk."""
    import asyncio

    from radiorust_tpu.blocks.graph import Graph
    from radiorust_tpu.runtime import ArraySink, RuntimeGraph
    from radiorust_tpu.runtime.flow import new_sender
    from radiorust_tpu.signal import Samples

    def build():
        g = Graph()
        src = g.input("iq")
        mid = g.add(FreqShifter.with_shift(500.0), src)
        g.output("filt", g.add(Filter.new(lowpass(2000.0)), mid))
        return g

    d, n, steps = 8, 256, 2
    xs = make_iq(steps * d, 1, n, seed=19)      # batch-1 stream
    groups = [np.concatenate([xs[g * d + i] for i in range(d)], axis=-1)
              for g in range(steps)]

    async def drive(mesh, chunks, overlap):
        sender, connector = new_sender()
        kw = ({"mesh": mesh, "shard": "time", "overlap": overlap}
              if mesh is not None else {})
        rg = RuntimeGraph(build(), **kw)
        sink = ArraySink()
        rg.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(rg.out("filt"))
        for c in chunks:
            await sender.send(Samples(8000.0, c))
        for _ in range(1200):
            if len(sink.chunks) >= len(chunks):
                break
            await asyncio.sleep(0.01)
        assert rg.failure is None
        assert len(sink.chunks) == len(chunks), "stream died"
        return np.concatenate(sink.chunks, axis=-1)

    mesh = jax.make_mesh((8,), ("t",))
    got = asyncio.run(drive(mesh, groups, overlap=2))   # falls back
    want = asyncio.run(drive(None, groups, overlap=1))
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_runtime_block_mesh_wfm_fleet_matches_unsharded():
    """A 16-stream WFM fleet through one mesh-serving actor: batched
    chunks run the full receive chain sharded over the 8-device mesh and
    match the single-device actor chunk for chunk (state carry included)."""
    import asyncio

    from radiorust_tpu.runtime import ArraySink, RuntimeBlock
    from radiorust_tpu.runtime.flow import new_sender
    from radiorust_tpu.signal import Samples

    # FM-modulated tones (demod on raw noise is chaotic; see dryrun).
    n, streams, steps = 2048, 16, 4
    tt = np.arange(steps * n) / 1024000.0
    audio = 0.3 * np.sin(2 * np.pi * 1000.0 * tt)
    iq = np.exp(1j * (2 * np.pi * 150000.0 / 1024000.0 * np.cumsum(audio)))
    phases = np.exp(1j * np.linspace(0.0, 1.0, streams))
    xs = (iq[None, :] * phases[:, None]).astype(np.complex64)
    xs = np.moveaxis(xs.reshape(streams, steps, n), 1, 0)  # [T, streams, n]

    async def drive(mesh):
        sender, connector = new_sender()
        blk = RuntimeBlock(wfm_receiver(), mesh=mesh)
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        for t in range(steps):
            await sender.send(Samples(1024000.0, xs[t]))
        for _ in range(1000):
            if len(sink.chunks) >= steps:
                break
            await asyncio.sleep(0.01)
        assert blk.failure is None
        return sink.chunks

    devices = jax.devices()
    mesh = Mesh(np.array(devices), ("streams",))
    got = asyncio.run(drive(mesh))
    want = asyncio.run(drive(None))
    assert len(got) == len(want) == steps

    # Every chunk, warmup included, against the single-device chain run at
    # the per-device batch: a wrong initial state or reset on any shard
    # shows here (measured max |diff| 4.8e-7).
    per = streams // len(devices)
    bound = wfm_receiver().bind(StreamSig(per, n, 1024000.0))
    for s in range(0, streams, per):
        _, ys = scan(bound, bound.params, bound.init_state(),
                     jnp.asarray(xs[:, s:s + per]))
        for t in range(steps):
            np.testing.assert_allclose(np.asarray(got[t])[s:s + per],
                                       np.asarray(ys[t]), atol=5e-4)

    # Against the 16-stream actor from the first valid chunk on.  In the
    # two warmup chunks the overlap-save Filter's output differs by ~8e-7
    # between batch 16 and batch 2 on the CPU backend, and FmDemod's
    # arctan2 turns that into O(1) phase steps on the zero-primed,
    # near-zero-amplitude tail (measured max |diff| 0.257 in chunk 0).
    assert wfm_receiver().bind(
        StreamSig(streams, n, 1024000.0)).valid_from == 2
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, atol=5e-4)


# ---------------------------------------------------------------------------
# Live retune under time sharding: phase-continuous
# set_shift against a *running* sharded executor must match a sequentially
# retuned scan — the folded start_phase interacting with the per-device
# k0 + d*adv offsets is exactly the kind of thing that breaks silently.
# ---------------------------------------------------------------------------

def _seq_retuned(chain, sig, xs, d, shift2, update_gain=None):
    """Sequential oracle: scan half, retune phase-continuously (the
    per-block retune API the channel-shard tests already validate), scan
    the rest."""
    from radiorust_tpu.blocks.transform import _BoundFreqShifter, _BoundGain
    bound = chain.bind(sig)
    half = xs.shape[0] // 2
    st, ys_a = scan(bound, bound.params, bound.init_state(),
                    jnp.asarray(xs[:half]))
    params = list(bound.params)
    state = list(st)
    for i, blk in enumerate(bound.blocks):
        if isinstance(blk, _BoundFreqShifter):
            params[i], state[i] = blk.retune(
                params[i], jax.tree.map(np.asarray, state[i]), shift2)
        if update_gain is not None and isinstance(blk, _BoundGain):
            params[i] = np.float32(update_gain)
    _, ys_b = scan(bound, tuple(params), tuple(state), jnp.asarray(xs[half:]))
    return np.concatenate([np.asarray(ys_a), np.asarray(ys_b)])


def _drive_sharded_retuned(ts, bound, xs, d, shift2, update_gain=None):
    steps = xs.shape[0] // d
    b, n = xs.shape[1], xs.shape[2]
    state = ts.init_state()
    outs = []
    for s in range(steps):
        if s == steps // 2:
            state = ts.set_shift(state, shift2)      # mid-stream retune
            if update_gain is not None:
                from radiorust_tpu.blocks.transform import _BoundGain
                ts.update_params(
                    lambda blk, p: np.float32(update_gain)
                    if isinstance(blk, _BoundGain) else None)
        group = xs[s * d:(s + 1) * d]
        x_big = np.moveaxis(group, 0, 1).reshape(b, d * n)
        state, y = ts.process(ts.params, state, jnp.asarray(x_big))
        out_n = bound.out_sig.chunk_len
        out_b = bound.out_sig.batch
        outs.append(np.moveaxis(
            np.asarray(y).reshape(out_b, d, out_n), 1, 0))
    return np.concatenate(outs, axis=0)


def test_time_sharded_live_retune(devices):
    """set_shift + a gain update on a running TimeShardedChain (plain
    FreqShifter front end) vs the sequentially retuned scan."""
    d = 4
    mesh = jax.make_mesh((d,), ("t",))
    sig = StreamSig(2, 2048, 1024000.0)
    chain = wfm_receiver(tune_shift=100000.0)
    xs = make_iq(4 * d, 2, 2048, seed=31)
    want = _seq_retuned(chain, sig, xs, d, -57000.0, update_gain=0.5)
    bound = chain.bind(sig)
    ts = TimeShardedChain(bound, mesh)
    got = _drive_sharded_retuned(ts, bound, xs, d, -57000.0,
                                 update_gain=0.5)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_time_sharded_live_retune_decoupled_geometry(devices):
    """Same, on the decoupled overlap-save geometry (filter IRs shorter
    than the mid chunk): the retune rewrites the mixer's phasor tables
    while the IR-length filter halos carry on unchanged."""
    d = 4
    mesh = jax.make_mesh((d,), ("t",))
    n = 2048
    sig = StreamSig(2, n, 1024000.0)
    chain = wfm_receiver(tune_shift=100000.0, filter_ir_len=256)
    xs = make_iq(4 * d, 2, n, seed=32)
    want = _seq_retuned(chain, sig, xs, d, -57000.0)
    bound = chain.bind(sig)
    ts = TimeShardedChain(bound, mesh)
    got = _drive_sharded_retuned(ts, bound, xs, d, -57000.0)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_time_sharded_graph_live_retune(devices):
    """set_shift against a running TimeShardedGraph (fan-out DAG): both
    outputs continue phase-continuously."""
    from radiorust_tpu.blocks.graph import Graph, graph_scan
    from radiorust_tpu.blocks.transform import _BoundFreqShifter
    from radiorust_tpu.parallel.time_shard import TimeShardedGraph

    sig = StreamSig(2, 64, 8000.0)

    def build():
        g = Graph()
        src = g.input("iq")
        mid = g.add(FreqShifter.with_shift(500.0), src)
        g.output("a", g.add(Filter.new(lowpass(2000.0)), mid))
        g.output("b", g.add(FmDemod(1000.0), mid))
        return g.bind(sig)

    d, steps = 4, 4
    mesh = jax.make_mesh((d,), ("t",))
    xs = make_iq(steps * d, 2, 64, seed=33)
    half = steps * d // 2

    # Sequential oracle with a mid-stream retune.
    bg = build()
    st, ys_a = graph_scan(bg, bg.params, bg.init_state(),
                          {"iq": jnp.asarray(xs[:half])})
    params = list(bg.params)
    state = list(st)
    for i, blk in enumerate(bg.bound):
        if isinstance(blk, _BoundFreqShifter):
            params[i], state[i] = blk.retune(
                params[i], jax.tree.map(np.asarray, state[i]), -700.0)
    bg.params = tuple(params)
    _, ys_b = graph_scan(bg, bg.params, tuple(state),
                         {"iq": jnp.asarray(xs[half:])})
    want = {k: np.concatenate([np.asarray(ys_a[k]), np.asarray(ys_b[k])])
            for k in ("a", "b")}

    bg2 = build()
    tg = TimeShardedGraph(bg2, mesh)
    state = tg.init_state()
    got = {"a": [], "b": []}
    for s in range(steps):
        if s == steps // 2:
            state = tg.set_shift(state, -700.0)
        group = xs[s * d:(s + 1) * d]
        x_big = np.moveaxis(group, 0, 1).reshape(2, d * 64)
        state, ys = tg.process(tg.params, state, {"iq": jnp.asarray(x_big)})
        for k in ("a", "b"):
            got[k].append(np.moveaxis(
                np.asarray(ys[k]).reshape(2, d, -1), 1, 0))
    for k in ("a", "b"):
        np.testing.assert_allclose(np.concatenate(got[k]), want[k],
                                   atol=2e-4)


def test_time_sharded_retune_requires_shifter(devices):
    mesh = jax.make_mesh((4,), ("t",))
    sig = StreamSig(2, 64, 8000.0)
    ts = TimeShardedChain(Chain(GainControl(1.0)).bind(sig), mesh)
    with pytest.raises(ValueError):
        ts.set_shift(ts.init_state(), 100.0)
