"""Streaming runtime tests: channel semantics, dynamic rewiring, runtime
blocks, buffering — mirroring the reference's broadcast/flow behaviors."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radiorust_tpu.blocks.base import StreamSig
from radiorust_tpu.blocks.modulation import FmDemod
from radiorust_tpu.blocks.transform import FreqShifter, GainControl
from radiorust_tpu.runtime import (ArraySink, ArraySource, Blackhole, Buffer,
                                   KeyerSource, Rechunker, RuntimeBlock,
                                   Silence)
from radiorust_tpu.runtime.flow import (ChannelClosed, new_receiver,
                                        new_sender)
from radiorust_tpu.signal import (BufferOverflow, Disconnection, Samples,
                                  SamplesLost)


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def until(cond, timeout=15.0, interval=0.02):
    """Poll until cond() is truthy (jit compiles make fixed sleeps flaky)."""
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError("condition not met in time")
        await asyncio.sleep(interval)


# ---------------------------------------------------------------------------
# Channel semantics (src/sync/broadcast_bp.rs:337-375)
# ---------------------------------------------------------------------------

def test_broadcast_all_receivers_get_each_value():
    # Mirrors the reference's test_broadcast: 1 sender, 3 receivers, one
    # of them created via Receiver clone (broadcast_bp.rs:337-375).
    async def main():
        sender, connector = new_sender()
        recvs = []
        for _ in range(2):
            r, rc = new_receiver()
            rc.connect(connector)
            recvs.append(r)
        recvs.append(recvs[0].clone())
        results = [[] for _ in range(3)]

        async def consume(i):
            for _ in range(3):
                results[i].append(await recvs[i].recv())

        async def produce():
            for v in "abc":
                await sender.send(v)

        await asyncio.gather(produce(), *[consume(i) for i in range(3)])
        assert results == [["a", "b", "c"]] * 3

    run(main())


def test_backpressure_capacity_one():
    async def main():
        sender, connector = new_sender()
        r, rc = new_receiver()
        rc.connect(connector)
        sent = []

        async def produce():
            for v in range(5):
                await sender.send(v)
                sent.append(v)

        task = asyncio.ensure_future(produce())
        await asyncio.sleep(0.05)
        # Without consumption, at most one value can be in flight.
        assert len(sent) <= 1
        got = [await r.recv() for _ in range(5)]
        await task
        assert got == list(range(5))

    run(main())


def test_recv_raises_when_sender_gone():
    async def main():
        sender, connector = new_sender()
        r, rc = new_receiver()
        rc.connect(connector)

        async def produce():
            # Backpressure: send completes only once the receiver
            # subscribed and consumed (capacity-1 semantics).
            await sender.send(1)
            sender.close()

        task = asyncio.ensure_future(produce())
        assert await r.recv() == 1
        await task
        with pytest.raises(ChannelClosed):
            await r.recv()

    run(main())


def test_rewire_injects_disconnection():
    async def main():
        s1, c1 = new_sender()
        s2, c2 = new_sender()
        r, rc = new_receiver()
        rc.connect(c1)
        t1 = asyncio.ensure_future(s1.send("one"))
        assert await r.recv() == "one"
        await t1
        rc.connect(c2)
        msg = await r.recv()
        assert isinstance(msg, Disconnection)
        t2 = asyncio.ensure_future(s2.send("two"))
        assert await r.recv() == "two"
        await t2

    run(main())


# ---------------------------------------------------------------------------
# Runtime blocks
# ---------------------------------------------------------------------------

def test_runtime_gain_block():
    async def main():
        data = np.arange(8, dtype=np.complex64)
        src = ArraySource(data, chunk_len=4, sample_rate=48000.0)
        gain = RuntimeBlock(GainControl(0.25))
        sink = ArraySink()
        gain.feed_from(src)
        sink.feed_from(gain)
        await until(lambda: len(sink.samples) >= len(data))
        np.testing.assert_allclose(sink.samples, data * 0.25)
        assert sink.sample_rate == 48000.0

    run(main())


def test_runtime_phase_mode_resampler_trims_to_schedule():
    """An arbitrary-ratio resampler (chunk not a multiple of the period)
    served through the actor layer emits a GAPLESS stream: the actor
    trims each padded chunk to the schedule's valid prefix, matching the
    reference's variable-count accumulator output
    (resampling.rs:103-133)."""
    from radiorust_tpu.blocks.resampling import Downsampler
    import oracles

    rng = np.random.default_rng(13)
    data = (rng.standard_normal(800)
            + 1j * rng.standard_normal(800)).astype(np.complex64)

    async def main():
        src = ArraySource(data, chunk_len=100, sample_rate=1024.0)
        down = RuntimeBlock(Downsampler(384.0, 200.0))
        sink = ArraySink()
        down.feed_from(src)
        sink.feed_from(down)
        # 800 inputs -> 100 whole periods -> 300 outputs.
        await until(lambda: len(sink.samples) >= 300)
        got = np.asarray(sink.samples)
        want = oracles.oracle_downsample(data, 1024.0, 384.0, 200.0)
        np.testing.assert_allclose(got, want[:len(got)], atol=2e-4)
        assert sink.sample_rate == 384.0

    run(main())


def test_runtime_shift_getter_and_update_shift():
    """FreqShifter::shift / update_shift analogs (transform.rs:380-390):
    the actor reads the current shift and applies a read-modify-write
    retune with phase continuity."""
    from radiorust_tpu.blocks.base import Chain

    async def main():
        sender, connector = new_sender()
        rx = RuntimeBlock(Chain(FreqShifter.with_shift(100.0),
                                GainControl(0.25)))
        sink = ArraySink()
        rx.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(rx)
        assert rx.shift() == 100.0          # pre-binding: from the spec
        assert rx.gain() == 0.25
        await sender.send(Samples(1000.0, np.ones(64, np.complex64)))
        await until(lambda: len(sink.chunks) >= 1)
        assert rx.shift() == 100.0          # bound: from the live block
        rx.update_shift(lambda s: s + 150.0)
        assert rx.shift() == 250.0
        rx.set_gain(0.5)
        assert rx.gain() == 0.5
        # Deviation getter on a demod actor (modulation.rs:150-152);
        # pre-binding the getter reflects a pending setter (the override
        # only APPLIES at first bind).
        from radiorust_tpu.blocks.modulation import FmDemod
        demod = RuntimeBlock(FmDemod(1500.0))
        assert abs(demod.deviation() - 1500.0) < 1e-6   # from the spec
        demod.set_deviation(2000.0)
        assert abs(demod.deviation() - 2000.0) < 1e-6
        await sender.send(Samples(1000.0, np.ones(64, np.complex64)))
        await until(lambda: len(sink.chunks) >= 2)
        # The retune took effect: per-sample phase step is the new shift.
        step = np.angle(sink.chunks[1][2] * np.conj(sink.chunks[1][1]))
        np.testing.assert_allclose(step, 2 * np.pi * 250.0 / 1000.0,
                                   atol=1e-5)

    run(main())


def test_runtime_graph_getters():
    """The getters dispatch over a bound GRAPH's node list too (the
    sharded-wrapper unwrap must not mistake BoundGraph.bound — the node
    list — for an inner binding)."""
    from radiorust_tpu.blocks.graph import Graph
    from radiorust_tpu.runtime import RuntimeGraph

    async def main():
        g = Graph()
        i = g.input("iq")
        g.output("out", g.chain([FreqShifter.with_shift(123.0),
                                 GainControl(0.5)], i))
        rg = RuntimeGraph(g)
        src = ArraySource(np.ones(256, np.complex64), chunk_len=64,
                          sample_rate=1000.0)
        sink = ArraySink()
        rg.feed_from(src)
        sink.feed_from(rg.out("out"))
        assert rg.shift() == 123.0 and rg.gain() == 0.5  # spec fallback
        await until(lambda: rg._bound is not None)
        assert rg.shift() == 123.0 and rg.gain() == 0.5  # live nodes
        rg.update_shift(lambda s: s - 23.0)
        assert rg.shift() == 100.0

    run(main())


def test_runtime_rebind_on_rate_change():
    async def main():
        sender, connector = new_sender()
        shifter = RuntimeBlock(FreqShifter.with_shift(100.0))
        sink = ArraySink()
        shifter.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(shifter)
        await sender.send(Samples(1000.0, np.ones(10, np.complex64)))
        await sender.send(Samples(2000.0, np.ones(10, np.complex64)))
        await until(lambda: len(sink.chunks) >= 2)
        assert len(sink.chunks) == 2
        # Different sample rates -> different oscillator steps.
        step1 = np.angle(sink.chunks[0][2] * np.conj(sink.chunks[0][1]))
        step2 = np.angle(sink.chunks[1][2] * np.conj(sink.chunks[1][1]))
        np.testing.assert_allclose(step1, 2 * np.pi * 100.0 / 1000.0,
                                   atol=1e-5)
        np.testing.assert_allclose(step2, 2 * np.pi * 100.0 / 2000.0,
                                   atol=1e-5)

    run(main())


def test_silence_and_blackhole():
    async def main():
        src = Silence(chunk_size=256, sample_rate=8000.0)
        hole = Blackhole()
        hole.feed_from(src)
        await until(lambda: hole.samples_seen >= 256)
        assert hole.samples_seen >= 256

    run(main())


def test_rechunker_splits():
    async def main():
        data = np.arange(4096, dtype=np.complex64)
        src = ArraySource(data, chunk_len=4096, sample_rate=1.0)
        rechunk = Rechunker(1024)
        sink = ArraySink()
        rechunk.feed_from(src)
        sink.feed_from(rechunk)
        await until(lambda: len(sink.samples) >= 4096)
        assert all(len(c) == 1024 for c in sink.chunks)
        np.testing.assert_array_equal(sink.samples, data)

    run(main())


def test_rechunker_joins():
    async def main():
        data = np.arange(64, dtype=np.complex64)
        src = ArraySource(data, chunk_len=8, sample_rate=1.0)
        rechunk = Rechunker(16)
        sink = ArraySink()
        rechunk.feed_from(src)
        sink.feed_from(rechunk)
        await until(lambda: len(sink.samples) >= 64)
        assert all(len(c) == 16 for c in sink.chunks)
        np.testing.assert_array_equal(sink.samples, data)

    run(main())


def test_keyer_source_events():
    from radiorust_tpu.blocks.morse import (EndOfMessages, Speed,
                                            StartOfMessages)

    async def main():
        speed = Speed.from_dits_per_minute(60.0 * 48000.0 / 64)
        keyer = KeyerSource(128, 48000.0, speed, message="E")
        sink = ArraySink()
        sink.feed_from(keyer)
        await until(lambda: len(sink.events) >= 2 and len(sink.chunks) >= 4)
        kinds = [type(e).__name__ for e in sink.events]
        assert "StartOfMessages" in kinds
        assert "EndOfMessages" in kinds
        assert np.any(sink.samples.real == 1.0)

    run(main())


def test_buffer_drops_stale_data():
    async def main():
        sender, connector = new_sender()
        buf = Buffer(0.0, 0.0, 10.0, max_age=0.05)
        sink_r, sink_rc = new_receiver()
        buf.feed_from(type("P", (), {"sender_connector": connector})())
        sink_rc.connect(buf.sender_connector)
        # Push several chunks without consuming, let them age out.
        for i in range(5):
            await sender.send(Samples(1000.0, np.full(100, i,
                                                      np.complex64)))
        await asyncio.sleep(0.2)
        # Now consume: expect a BufferOverflow marker and then fresh data
        # (stale entries were discarded).
        got = []
        for _ in range(3):
            try:
                got.append(await asyncio.wait_for(sink_r.recv(), 1.0))
            except asyncio.TimeoutError:
                break
        assert any(isinstance(m, BufferOverflow) for m in got)

    run(main())


def test_buffer_passthrough():
    async def main():
        data = np.arange(32, dtype=np.complex64)
        src = ArraySource(data, chunk_len=8, sample_rate=1000.0)
        buf = Buffer(0.0, 0.0, 100.0, max_age=100.0)
        sink = ArraySink()
        buf.feed_from(src)
        sink.feed_from(buf)
        await until(lambda: len(sink.samples) >= len(data))
        np.testing.assert_array_equal(sink.samples, data)

    run(main())


def test_end_to_end_runtime_chain():
    # Keyer -> gain -> shifter -> sink, all through the dynamic runtime
    # with device compute per chunk.
    from radiorust_tpu.blocks.morse import Speed

    async def main():
        speed = Speed.from_dits_per_minute(60.0 * 48000.0 / 64)
        keyer = KeyerSource(128, 48000.0, speed, message="EE")
        gain = RuntimeBlock(GainControl(0.5))
        shift = RuntimeBlock(FreqShifter.with_shift(700.0))
        sink = ArraySink()
        gain.feed_from(keyer)
        shift.feed_from(gain)
        sink.feed_from(shift)
        await until(lambda: np.any(np.abs(sink.samples) > 0.4), timeout=25.0)
        s = sink.samples
        on = np.abs(s) > 0.4
        assert on.any()
        seg = s[np.flatnonzero(on)[0]:][:50]
        steps = np.angle(seg[1:] * np.conj(seg[:-1]))
        np.testing.assert_allclose(steps, 2 * np.pi * 700.0 / 48000.0,
                                   atol=1e-4)

    run(main())


def test_runtime_setters():
    from radiorust_tpu.blocks.filters import Filter

    async def main():
        data = np.ones(64, np.complex64)
        src = ArraySource(data, chunk_len=16, sample_rate=1000.0,
                          repeat=True)
        gain = RuntimeBlock(GainControl(1.0))
        sink = ArraySink()
        gain.feed_from(src)
        sink.feed_from(gain)
        await until(lambda: len(sink.chunks) >= 2)
        gain.set_gain(0.25)
        seen = len(sink.chunks)
        await until(lambda: len(sink.chunks) >= seen + 3)
        assert np.allclose(sink.chunks[-1], 0.25)

    run(main())


def test_runtime_set_shift_phase_continuous():
    async def main():
        src = ArraySource(np.ones(400, np.complex64), chunk_len=40,
                          sample_rate=1000.0, repeat=True)
        shift = RuntimeBlock(FreqShifter.with_shift(100.0))
        sink = ArraySink()
        shift.feed_from(src)
        sink.feed_from(shift)
        await until(lambda: len(sink.chunks) >= 3)
        shift.set_shift(250.0)
        seen = len(sink.chunks)
        await until(lambda: len(sink.chunks) >= seen + 3)
        s = sink.chunks[-1]
        steps = np.angle(s[1:] * np.conj(s[:-1]))
        np.testing.assert_allclose(steps, 2 * np.pi * 250.0 / 1000.0,
                                   atol=1e-3)

    run(main())


def test_feed_from_none_disconnects():
    async def main():
        data = np.ones(64, np.complex64)
        src = ArraySource(data, chunk_len=16, sample_rate=1000.0,
                          repeat=True)
        sink = ArraySink()
        sink.feed_from(src)
        await until(lambda: len(sink.chunks) >= 2)
        sink.feed_from_none()
        await asyncio.sleep(0.1)
        # The rewire injected a Disconnection interrupt.
        assert any(isinstance(e, Disconnection) for e in sink.events)

    run(main())


def test_runtime_block_resets_on_interrupt():
    # A Disconnection event mid-stream clears the filter's overlap-save
    # tail: the next output equals a fresh filter's first output.
    from radiorust_tpu.blocks.filters import Filter
    from radiorust_tpu.runtime.flow import new_sender

    def lp(bins, freqs):
        return np.where(np.abs(freqs) <= 200.0, 1.0 + 0.0j, 0.0j)

    async def main():
        rng = np.random.default_rng(0)
        chunks = (rng.standard_normal((3, 32))
                  + 1j * rng.standard_normal((3, 32))).astype(np.complex64)
        sender, conn = new_sender()
        filt = RuntimeBlock(Filter.new(lp))
        sink = ArraySink()
        filt.receiver_connector.connect(conn)
        sink.feed_from(filt)
        await sender.send(Samples(1000.0, chunks[0]))
        await sender.send(Samples(1000.0, chunks[1]))
        await sender.send(Disconnection())
        await sender.send(Samples(1000.0, chunks[2]))
        await until(lambda: len(sink.chunks) >= 3)
        # Output 3 (after interrupt) == a fresh filter's first chunk.
        from radiorust_tpu.blocks.base import StreamSig, scan
        import jax.numpy as jnp
        b = Filter.new(lp).bind(StreamSig(1, 32, 1000.0))
        _, want = scan(b, b.params, b.init_state(),
                       jnp.asarray(chunks[2][None, None, :]))
        np.testing.assert_allclose(sink.chunks[2],
                                   np.asarray(want)[0, 0], atol=1e-5)

    run(main())


# ---------------------------------------------------------------------------
# Teardown semantics (src/sync/broadcast_bp.rs:170-205 Drop impls;
# src/blocks/mod.rs:213-230 task exit on channel close)
# ---------------------------------------------------------------------------

def test_teardown_cascades_down_chain():
    """When a finite source finishes, every downstream block task exits
    (the reference: RecvError propagates task exit block by block)."""
    async def main():
        data = np.arange(64, dtype=np.complex64)
        src = ArraySource(data, chunk_len=8, sample_rate=1000.0)
        mid = Rechunker(16)
        gain = RuntimeBlock(GainControl(1.0))
        sink = ArraySink()
        mid.feed_from(src)
        gain.feed_from(mid)
        sink.feed_from(gain)
        tasks = [src._task, mid._task, gain._task, sink._task]
        await asyncio.wait_for(asyncio.gather(*tasks), 20.0)
        np.testing.assert_array_equal(sink.samples, data)

    run(main())


def test_send_unblocks_when_peer_endpoints_dropped():
    """A sender blocked in send() is released with ChannelClosed when the
    subscription point and all receivers are gone (Enlister/Receiver Drop
    parity, broadcast_bp.rs:181-205)."""
    async def main():
        import gc
        sender, connector = new_sender()
        receiver, rc = new_receiver()
        rc.connect(connector)
        recv_task = asyncio.ensure_future(receiver.recv())
        await sender.send(Samples(1000.0, np.zeros(4, np.complex64)))
        await recv_task  # subscribed and drained
        # Slot refill completes; the next send must wait for the receiver.
        await sender.send(Samples(1000.0, np.ones(4, np.complex64)))
        send_task = asyncio.ensure_future(
            sender.send(Samples(1000.0, np.ones(4, np.complex64))))
        await asyncio.sleep(0.05)
        assert not send_task.done()  # backpressure: receiver hasn't drained

        receiver.close()
        del receiver, rc, connector
        gc.collect()
        with pytest.raises(ChannelClosed):
            await asyncio.wait_for(send_task, 5.0)

    run(main())


def test_stop_releases_peers():
    """block.stop() (struct-drop analog) closes its endpoints so blocked
    peers observe closure instead of hanging."""
    async def main():
        src = ArraySource(np.arange(1 << 20, dtype=np.complex64),
                          chunk_len=256, sample_rate=1e6, repeat=True)
        sink = ArraySink()
        sink.feed_from(src)
        await until(lambda: len(sink.chunks) >= 2)
        sink.stop()
        # Source's send must observe closure (no receivers, then its own
        # endpoints close when its task unwinds)... the source task keeps
        # waiting for a new subscriber, which matches the reference: its
        # Enlister (sender_connector) is still alive. Now drop the source:
        src.stop()
        await asyncio.wait_for(
            asyncio.gather(src._task, sink._task, return_exceptions=True),
            10.0)
        assert src._task.done() and sink._task.done()

    run(main())


def test_rechunker_zero_copy_and_pool_recycling():
    """Steady-state rechunking is O(1) allocations: aligned splits are
    zero-copy views; boundary-straddling outputs cycle through the pool
    (``src/blocks/chunks.rs:61-160`` + ``src/bufferpool.rs:82-90``)."""
    async def main():
        import gc
        # Aligned case: input multiple of output -> no pool allocations.
        sender, connector = new_sender()
        rk = Rechunker(32)
        sink = Blackhole()
        rk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(rk)
        for i in range(10):
            await sender.send(Samples(1000.0, np.zeros(64, np.complex64)))
        await until(lambda: sink.samples_seen >= 640)
        assert rk.pool.allocated == 0, "aligned splits must be zero-copy"

        # Straddling case: 48 -> 32 exercises the patchwork on every
        # output; allocations must plateau (recycling), not grow per chunk.
        sender2, connector2 = new_sender()
        rk2 = Rechunker(32)
        sink2 = Blackhole()
        rk2.feed_from(type("P", (), {"sender_connector": connector2})())
        sink2.feed_from(rk2)
        for i in range(100):
            await sender2.send(Samples(1000.0, np.zeros(48, np.complex64)))
            if i % 10 == 0:
                gc.collect()
        await until(lambda: sink2.samples_seen >= 4780)
        assert rk2.pool.allocated <= 4, (
            f"pool must recycle: allocated {rk2.pool.allocated}")
        assert rk2.pool.recycled > 0

    run(main())


def test_block_stats_recorded():
    """RuntimeBlock wires per-block counters into the global stats registry
    (the tracing subsystem the reference lacks, SURVEY.md §5)."""
    from radiorust_tpu.utils.profiling import GLOBAL_STATS

    async def main():
        data = np.arange(64, dtype=np.complex64)
        src = ArraySource(data, chunk_len=16, sample_rate=1000.0)
        gain = RuntimeBlock(GainControl(0.5))
        sink = ArraySink()
        gain.feed_from(src)
        sink.feed_from(gain)
        await until(lambda: len(sink.samples) >= 64)
        assert gain.stats.chunks == 4
        assert gain.stats.samples == 64
        assert gain.stats.wall_seconds > 0.0
        assert gain.stats.name in GLOBAL_STATS.report()

    run(main())


def test_warmup_event_on_zero_primed_history():
    """Blocks whose fixed-shape formulation emits zero-primed warmup chunks
    (Filter's overlap-save) announce it with a Warmup event, so bulk
    consumers can't silently meter garbage."""
    from radiorust_tpu.blocks.filters import Filter
    from radiorust_tpu.signal import Warmup
    import numpy as _np

    def lp(bins, freqs):
        return _np.where(_np.abs(freqs) <= 200.0, 1.0 + 0.0j, 0.0j)

    async def main():
        data = np.ones(64, np.complex64)
        src = ArraySource(data, chunk_len=16, sample_rate=1000.0)
        filt = RuntimeBlock(Filter.new(lp))
        sink = ArraySink()
        filt.feed_from(src)
        sink.feed_from(filt)
        await until(lambda: len(sink.chunks) >= 4)
        warms = [e for e in sink.events if isinstance(e, Warmup)]
        assert len(warms) == 1 and warms[0].steps == 1

    run(main())


def test_runtime_batched_serving_matches_per_stream():
    """2-D [streams, n] chunks (batched serving) through a RuntimeBlock
    produce exactly what each stream gets when served alone, and outputs
    stay 2-D with per-stream state carried across chunks."""
    rng = np.random.default_rng(3)
    data = (rng.standard_normal((3, 4, 16))
            + 1j * rng.standard_normal((3, 4, 16))).astype(np.complex64)

    def spec():
        return FreqShifter.with_shift(125.0)

    async def batched():
        sender, connector = new_sender()
        blk = RuntimeBlock(spec())
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        for t in range(4):
            await sender.send(Samples(1000.0, data[:, t, :]))
        await until(lambda: len(sink.chunks) >= 4)
        assert all(c.shape == (3, 16) for c in sink.chunks)
        return sink.samples                                # [3, 64]

    async def single(s):
        sender, connector = new_sender()
        blk = RuntimeBlock(spec())
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        for t in range(4):
            await sender.send(Samples(1000.0, data[s, t, :]))
        await until(lambda: len(sink.chunks) >= 4)
        return sink.samples                                # [64]

    got = run(batched())
    for s in range(3):
        want = run(single(s))
        np.testing.assert_allclose(got[s], want, atol=1e-6)


def test_runtime_pipeline_depth_matches_sync():
    """``pipeline_depth`` keeps device work in flight (JAX async dispatch)
    without changing values or sample/event ordering: the device analog of the
    reference's task-per-block pipelining (src/blocks/mod.rs:27-34)."""
    rng = np.random.default_rng(7)
    data = (rng.standard_normal((8, 16))
            + 1j * rng.standard_normal((8, 16))).astype(np.complex64)

    async def drive(depth):
        sender, connector = new_sender()
        blk = RuntimeBlock(FreqShifter.with_shift(100.0),
                           pipeline_depth=depth)
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        chunks_at_event = []
        guard = sink.on_event(
            lambda e: chunks_at_event.append(len(sink.chunks)))
        for i in range(4):
            await sender.send(Samples(1000.0, data[i]))
        await sender.send(Disconnection())
        for i in range(4, 8):
            await sender.send(Samples(1000.0, data[i]))
        await until(lambda: len(sink.chunks) >= 8)
        del guard
        return sink.samples, chunks_at_event

    async def main():
        got_sync, order_sync = await drive(0)
        got_pipe, order_pipe = await drive(3)
        np.testing.assert_array_equal(got_pipe, got_sync)
        # The interrupt event flushes the pipeline: in both modes it is
        # delivered after exactly the 4 chunks that preceded it.
        assert order_sync == [4]
        assert order_pipe == [4]

    run(main())


def test_runtime_set_map_params():
    from radiorust_tpu.blocks.transform import MapSample

    async def main():
        sender, connector = new_sender()
        blk = RuntimeBlock(
            MapSample.with_params(lambda x, p: x * p, np.float32(3.0)))
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        ones = np.ones(8, np.complex64)
        await sender.send(Samples(1000.0, ones))
        await until(lambda: len(sink.chunks) >= 1)
        blk.set_map_params(np.float32(5.0))
        await sender.send(Samples(1000.0, ones))
        await until(lambda: len(sink.chunks) >= 2)
        np.testing.assert_allclose(sink.chunks[0], ones * 3.0)
        np.testing.assert_allclose(sink.chunks[1], ones * 5.0)

    run(main())


def test_set_deviation_retunes_demod_in_chains():
    """set_deviation must reach the traced factor of an FmDemod inside a
    filter chain and of the per-channel FmDemod behind a Channelizer
    (which runs at the channel rate) — recompile-free retune."""
    from radiorust_tpu.blocks.base import Chain
    from radiorust_tpu.blocks.filters import Filter
    from radiorust_tpu.models.channelizer import channelized_receiver
    from radiorust_tpu.numbers import TAU

    def lp(bins, freqs):
        return np.where(np.abs(freqs) <= 100000.0, 1.0 + 0.0j, 0.0j)

    async def main():
        rate = 1024000.0
        blk = RuntimeBlock(Chain(Filter.new(lp), FmDemod(150000.0),
                                 Filter.new(lp)))
        sender, connector = new_sender()
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        x = np.ones((2, 4096), np.complex64)
        await sender.send(Samples(rate, x))
        await until(lambda: len(sink.chunks) >= 1)
        blk.set_deviation(75000.0)
        got = float(blk._bound.params[1])
        assert got == np.float32(rate / 75000.0 / TAU)
        assert blk.deviation() == pytest.approx(75000.0, rel=1e-6)

        blk2 = RuntimeBlock(channelized_receiver(64, input_rate=rate,
                                                 deviation_fraction=
                                                 4000.0 / (rate / 64)))
        sender2, connector2 = new_sender()
        sink2 = ArraySink()
        blk2.feed_from(type("P", (), {"sender_connector": connector2})())
        sink2.feed_from(blk2)
        await sender2.send(Samples(rate, np.ones(1024, np.complex64)))
        await until(lambda: len(sink2.chunks) >= 1)
        blk2.set_deviation(8000.0)
        ch_rate = rate / 64
        got2 = float(blk2._bound.params[1])
        assert got2 == np.float32(ch_rate / 8000.0 / TAU)

    run(main())


def test_rechunker_rejects_batched_chunks():
    """Batched [streams, n] chunks have no single time axis to regroup;
    the Rechunker fails loudly instead of slicing the stream axis."""
    async def main():
        sender, connector = new_sender()
        rk = Rechunker(8)
        sink = ArraySink()
        rk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(rk)
        await sender.send(Samples(1000.0, np.ones((4, 16), np.complex64)))
        # Failure surfacing contract: the error is recorded on the block
        # and the channels tear down (peers see ChannelClosed).
        await until(lambda: rk.failure is not None)
        assert isinstance(rk.failure, TypeError)
        assert "1-D" in str(rk.failure)
        await until(lambda: sink._task.done())

    run(main())


def test_rechunker_preserves_stream_dtype_across_boundaries():
    """Boundary-straddling remainders must keep the stream dtype (a real
    float stream must not come out complex64 on patchwork chunks only)."""
    async def main():
        sender, connector = new_sender()
        rk = Rechunker(10)
        sink = ArraySink()
        rk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(rk)
        for i in range(5):
            await sender.send(Samples(
                1000.0, np.arange(i * 4, i * 4 + 4, dtype=np.float64)))
        await until(lambda: len(sink.chunks) >= 2)
        assert all(np.asarray(c).dtype == np.float64 for c in sink.chunks)
        np.testing.assert_array_equal(sink.samples[:20], np.arange(20.0))

    run(main())


def test_blackhole_counts_batched_samples():
    """samples_seen advances by the per-stream time length for batched
    2-D chunks (same semantics as Samples.duration)."""
    async def main():
        sender, connector = new_sender()
        bh = Blackhole()
        bh.feed_from(type("P", (), {"sender_connector": connector})())
        await sender.send(Samples(1000.0, np.ones((4, 16), np.complex64)))
        await sender.send(Samples(1000.0, np.ones(32, np.complex64)))
        await until(lambda: bh.samples_seen >= 48)
        assert bh.samples_seen == 48

    run(main())


def test_stats_registry_drop():
    from radiorust_tpu.utils.profiling import GLOBAL_STATS
    s = GLOBAL_STATS.unique("EphemeralBlock")
    assert s.name in GLOBAL_STATS.report()
    GLOBAL_STATS.drop(s)
    assert s.name not in GLOBAL_STATS.report()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_actor_pipeline_matches_compiled_scan(seed):
    """Property-style integration: a random chain driven through the full
    actor plumbing (irregular source chunks -> Rechunker -> RuntimeBlock)
    produces exactly what the compiled scan of the same chain produces
    over the same samples (both start zero-primed)."""
    import jax.numpy as jnp

    from radiorust_tpu.blocks.base import Chain, StreamSig, scan
    from radiorust_tpu.blocks.filters import Filter
    from radiorust_tpu.blocks.modulation import FmDemod

    rng = np.random.default_rng(seed)
    # total divisible by both the irregular source chunk (24) and the
    # rechunk length (32), so nothing is dropped at either granularity.
    rate, n, total = 1000.0, 32, 288

    def lp(bins, freqs):
        return np.where(np.abs(freqs) <= 300.0, 1.0 + 0.0j, 0.0j)

    menu = [lambda: FreqShifter.with_shift(float(rng.integers(10, 400))),
            lambda: GainControl(float(rng.uniform(0.5, 2.0))),
            lambda: Filter.new(lp),
            lambda: FmDemod(float(rng.integers(100, 400)))]
    chain = Chain(*[menu[i]() for i in
                    rng.integers(0, len(menu), rng.integers(2, 5))])
    data = (rng.standard_normal(total)
            + 1j * rng.standard_normal(total)).astype(np.complex64)

    async def actor():
        src = ArraySource(data, chunk_len=24, sample_rate=rate)
        rk = Rechunker(n)
        blk = RuntimeBlock(chain)
        sink = ArraySink()
        rk.feed_from(src)
        blk.feed_from(rk)
        sink.feed_from(blk)
        await until(lambda: len(sink.chunks) >= total // n, timeout=40)
        return sink.samples

    got = run(actor(), timeout=60)
    bound = chain.bind(StreamSig(1, n, rate))
    _, want = scan(bound, bound.params, bound.init_state(),
                   jnp.asarray(data.reshape(total // n, 1, n)))
    want = np.asarray(want).reshape(-1)
    np.testing.assert_allclose(got, want[: len(got)], atol=2e-5)
    assert len(got) == want.size


def test_runtime_graph_fanout():
    """RuntimeGraph: one input actor, two named outputs on separate
    capacity-1 senders; each equals the corresponding RuntimeBlock chain,
    and the shared prefix runs once per chunk (chunks_processed)."""
    from radiorust_tpu.blocks.graph import Graph
    from radiorust_tpu.blocks.transform import FreqShifter, GainControl
    from radiorust_tpu.runtime import RuntimeGraph

    def build_graph():
        g = Graph()
        src = g.input("iq")
        mid = g.add(FreqShifter.with_shift(500.0), src)
        g.output("loud", g.add(GainControl(2.0), mid))
        g.output("quiet", g.add(GainControl(0.25), mid))
        return g

    rng = np.random.default_rng(0)
    data = (rng.standard_normal(64) + 1j * rng.standard_normal(64)
            ).astype(np.complex64)

    async def main():
        src = ArraySource(data, chunk_len=16, sample_rate=8000.0)
        rg = RuntimeGraph(build_graph())
        sink_a = ArraySink()
        sink_b = ArraySink()
        rg.feed_from(src)
        sink_a.feed_from(rg.out("loud"))
        sink_b.feed_from(rg.out("quiet"))
        await until(lambda: len(sink_a.samples) >= 64
                    and len(sink_b.samples) >= 64)
        assert rg.chunks_processed == 4  # shared prefix ran once per chunk
        return np.asarray(sink_a.samples), np.asarray(sink_b.samples)

    got_loud, got_quiet = run(main())

    async def reference(gain):
        from radiorust_tpu.blocks.base import Chain
        src = ArraySource(data, chunk_len=16, sample_rate=8000.0)
        blk = RuntimeBlock(Chain(FreqShifter.with_shift(500.0),
                                 GainControl(gain)))
        sink = ArraySink()
        blk.feed_from(src)
        sink.feed_from(blk)
        await until(lambda: len(sink.samples) >= 64)
        return np.asarray(sink.samples)

    np.testing.assert_allclose(got_loud, run(reference(2.0)), atol=2e-4)
    np.testing.assert_allclose(got_quiet, run(reference(0.25)), atol=2e-4)


def test_runtime_graph_events_and_retune():
    """Events forward to every connected output; interrupts reset DAG
    state; the inherited typed setters (set_gain) retune per node."""
    from radiorust_tpu.blocks.graph import Graph
    from radiorust_tpu.blocks.transform import GainControl
    from radiorust_tpu.runtime import RuntimeGraph
    from radiorust_tpu.runtime.flow import new_sender

    async def main():
        sender, connector = new_sender()
        g = Graph()
        src = g.input("x")
        g.output("a", g.add(GainControl(1.0), src))
        g.output("b", g.add(GainControl(1.0), src))
        rg = RuntimeGraph(g)
        rg.feed_from(type("P", (), {"sender_connector": connector})())
        sink_a, sink_b = ArraySink(), ArraySink()
        sink_a.feed_from(rg.out("a"))
        sink_b.feed_from(rg.out("b"))
        await sender.send(Samples(8000.0, np.ones(8, np.complex64)))
        await until(lambda: len(sink_a.samples) >= 8)
        rg.set_gain(3.0)
        await sender.send(Disconnection())
        await sender.send(Samples(8000.0, np.ones(8, np.complex64)))
        await until(lambda: len(sink_a.samples) >= 16
                    and len(sink_b.samples) >= 16)
        assert any(isinstance(e, Disconnection) for e in sink_a.events)
        assert any(isinstance(e, Disconnection) for e in sink_b.events)
        np.testing.assert_allclose(np.asarray(sink_a.samples)[8:], 3.0,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(sink_b.samples)[8:], 3.0,
                                   atol=1e-6)

    run(main())


def test_runtime_graph_unconnected_output_drops():
    """An output without a consumer must not stall the connected ones
    (drop semantics); a late subscriber starts at the live position."""
    from radiorust_tpu.blocks.graph import Graph
    from radiorust_tpu.blocks.transform import GainControl
    from radiorust_tpu.runtime import RuntimeGraph

    rng = np.random.default_rng(3)
    data = (rng.standard_normal(64) + 1j * rng.standard_normal(64)
            ).astype(np.complex64)

    async def main():
        g = Graph()
        src = g.input("x")
        g.output("a", g.add(GainControl(2.0), src))
        g.output("b", g.add(GainControl(0.5), src))  # never connected
        rg = RuntimeGraph(g)
        sink_a = ArraySink()
        rg.feed_from(ArraySource(data, chunk_len=16, sample_rate=8000.0))
        sink_a.feed_from(rg.out("a"))
        # All 4 chunks must flow through "a" even though "b" has no
        # consumer (pre-fix this deadlocked after the first chunk).
        await until(lambda: len(sink_a.samples) >= 64)
        np.testing.assert_allclose(np.asarray(sink_a.samples), data * 2.0,
                                   atol=2e-4)

    run(main())


def test_runtime_block_event_handling_mid_chain():
    """Every block exposes on_event/wait_for_event, the reference's
    impl_block_trait! EventHandling (src/blocks/mod.rs:126-142): events
    riding the stream invoke handlers on mid-chain blocks, not just
    sinks."""
    from radiorust_tpu.runtime import MapSignal

    async def main():
        sender, connector = new_sender()
        blk = RuntimeBlock(GainControl(2.0))
        mapper = MapSignal()
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        mapper.feed_from(blk)
        sink.feed_from(mapper)

        seen_blk, seen_map = [], []
        g1 = blk.on_event(seen_blk.append)
        g2 = mapper.on_event(seen_map.append)
        waiter = asyncio.ensure_future(
            blk.wait_for_event(lambda e: isinstance(e, Disconnection)))

        await sender.send(Samples(1000.0, np.ones(8, np.complex64)))
        await sender.send(Disconnection())
        await sender.send(Samples(1000.0, np.ones(8, np.complex64)))
        await until(lambda: len(sink.chunks) >= 2)
        await asyncio.wait_for(waiter, timeout=5.0)

        assert len(seen_blk) == 1 and isinstance(seen_blk[0], Disconnection)
        assert len(seen_map) == 1 and isinstance(seen_map[0], Disconnection)
        g1.unregister()
        g2.unregister()

    run(main())


def test_runtime_block_failure_surfaces():
    """A user-code exception inside the actor (here: a filter design
    closure that raises) must record ``block.failure`` and tear the
    block's channels down (peers see ChannelClosed) instead of dying
    silently (the reference's task panics visibly)."""
    from radiorust_tpu.blocks.filters import Filter

    async def main():
        sender, connector = new_sender()
        # Scalar-style closure: the vectorized design call raises
        # ValueError (truth value of an array).
        blk = RuntimeBlock(Filter.new(lambda b, f: 1.0 if f > 0 else 0.0))
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        await sender.send(Samples(8000.0, np.ones(64, np.complex64)))
        await until(lambda: blk.failure is not None)
        assert isinstance(blk.failure, ValueError)
        # Teardown cascades: the sink's task observes ChannelClosed and
        # exits rather than parking forever.
        await until(lambda: sink._task.done())

    run(main())


def test_buffer_rechunker_event_handling():
    """Buffer and Rechunker expose on_event too (they sit mid-chain most
    often); handlers fire when the block receives the event."""
    async def main():
        sender, connector = new_sender()
        rechunk = Rechunker(8)
        buf = Buffer(0.0, 0.0, 10.0, 10.0)
        sink = ArraySink()
        rechunk.feed_from(type("P", (), {"sender_connector": connector})())
        buf.feed_from(rechunk)
        sink.feed_from(buf)
        seen_r, seen_b = [], []
        g1 = rechunk.on_event(seen_r.append)
        g2 = buf.on_event(seen_b.append)
        await sender.send(Samples(1000.0, np.ones(8, np.complex64)))
        await sender.send(Disconnection())
        await sender.send(Samples(1000.0, np.ones(8, np.complex64)))
        await until(lambda: len(seen_r) >= 1 and len(seen_b) >= 1)
        assert isinstance(seen_r[0], Disconnection)
        assert isinstance(seen_b[0], Disconnection)
        g1.unregister()
        g2.unregister()

    run(main())


def test_mapsignal_failure_surfaces():
    """A raising MapSignal closure records .failure and tears down."""
    from radiorust_tpu.runtime import MapSignal

    async def main():
        sender, connector = new_sender()
        def boom(msg):
            raise RuntimeError("closure failed")
        mapper = MapSignal(boom)
        sink = ArraySink()
        mapper.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(mapper)
        await sender.send(Samples(1000.0, np.ones(8, np.complex64)))
        await until(lambda: mapper.failure is not None)
        assert isinstance(mapper.failure, RuntimeError)
        await until(lambda: sink._task.done())

    run(main())


def test_interrupt_invalidates_restored_checkpoint(tmp_path):
    """An interrupt event arriving between load_checkpoint and the first
    chunk declares the stream discontinuous: the restored history must be
    discarded (fresh zero state + Warmup), not spliced onto the new
    stream."""
    from radiorust_tpu.blocks.filters import Filter
    from radiorust_tpu.signal import Warmup

    def spec():
        return Filter.new(lambda b, f: np.where(np.abs(f) <= 200.0,
                                                1.0, 0.0))

    x = (np.linspace(0, 1, 256) + 1j).astype(np.complex64)

    async def save(path):
        sender, connector = new_sender()
        blk = RuntimeBlock(spec())
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        await sender.send(Samples(8000.0, x))
        await until(lambda: len(sink.chunks) >= 1)
        blk.save_checkpoint(path)

    async def resume_after_interrupt(path):
        sender, connector = new_sender()
        blk = RuntimeBlock(spec())
        blk.load_checkpoint(path)
        # save_checkpoint of a pending restored state round-trips too.
        blk.save_checkpoint(str(tmp_path / "resaved.npz"))
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        events = []
        guard = sink.on_event(events.append)
        await sender.send(Disconnection())       # before any chunk
        await sender.send(Samples(8000.0, x))
        await until(lambda: len(sink.chunks) >= 1)
        guard.unregister()
        return sink.chunks[0], events

    async def cold():
        sender, connector = new_sender()
        blk = RuntimeBlock(spec())
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        await sender.send(Samples(8000.0, x))
        await until(lambda: len(sink.chunks) >= 1)
        return sink.chunks[0]

    path = str(tmp_path / "pre.npz")
    run(save(path))
    got, events = run(resume_after_interrupt(path))
    want = run(cold())
    # Output equals a cold start (restored history dropped), and Warmup
    # was re-emitted because the first window is zero-primed again.
    np.testing.assert_array_equal(got, want)
    assert any(isinstance(e, Warmup) for e in events)
    # The re-saved pending state equals the original checkpoint.
    from radiorust_tpu.utils.checkpoint import load_state
    a = load_state(path)
    b = load_state(str(tmp_path / "resaved.npz"))
    import jax
    for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(la, lb)


# ---------------------------------------------------------------------------
# Typed-setter dispatch inside composed chains (review regressions)
# ---------------------------------------------------------------------------

def test_set_shift_reaches_front_end_shifter():
    """set_shift on the WFM front end (FreqShifter + Downsampler) retunes
    phase-continuously: an actor retuned mid-stream matches a sequential
    scan retuned at the same chunk boundary through the block's own
    retune, and differs from the un-retuned stream."""
    from radiorust_tpu.blocks.base import Chain, scan
    from radiorust_tpu.blocks.resampling import Downsampler
    from radiorust_tpu.blocks.transform import _BoundFreqShifter

    rng = np.random.default_rng(21)
    xs = (rng.standard_normal((4, 2048))
          + 1j * rng.standard_normal((4, 2048))).astype(np.complex64)

    async def drive(spec):
        sender, connector = new_sender()
        blk = RuntimeBlock(spec)
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        for i in range(4):
            await sender.send(Samples(1024000.0, xs[i]))
            if i == 1:
                await until(lambda: len(sink.chunks) >= 2)
                blk.set_shift(-25000.0)
        await until(lambda: len(sink.chunks) >= 4)
        assert blk.failure is None
        return sink.chunks

    spec = Chain(FreqShifter.with_shift(-57000.0),
                 Downsampler(384000.0, 200000.0))
    got = run(drive(spec))
    assert len(got) == 4
    bound = spec.bind(StreamSig(1, 2048, 1024000.0))
    st, ya = scan(bound, bound.params, bound.init_state(),
                  jnp.asarray(xs[:2, None, :]))
    params, state = list(bound.params), list(st)
    for i, blk in enumerate(bound.blocks):
        if isinstance(blk, _BoundFreqShifter):
            params[i], state[i] = blk.retune(
                params[i], jax.tree.map(np.asarray, state[i]), -25000.0)
    _, yb = scan(bound, tuple(params), tuple(state),
                 jnp.asarray(xs[2:, None, :]))
    want = np.concatenate([np.asarray(ya), np.asarray(yb)])[:, 0]
    # Chunks 2-3 prove the retune landed phase-continuously.
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-4)
    _, ynot = scan(bound, bound.params, bound.init_state(),
                   jnp.asarray(xs[:, None, :]))
    assert np.abs(np.asarray(ynot)[3, 0] - want[3]).max() > 1e-2


def test_update_filter_reaches_filter_in_wfm_mid_chain():
    """update_filter must redesign the channel filter of a WFM mid chain
    (Filter -> FmDemod), leaving the demodulator's params alone."""
    from radiorust_tpu.blocks.base import Chain, StreamSig
    from radiorust_tpu.blocks.filters import Filter

    def lp(cut):
        def resp(bins, freqs):
            return np.where(np.abs(freqs) <= cut, 1.0 + 0.0j, 0.0j)
        return resp

    spec = Chain(Filter.new(lp(100000.0)), FmDemod(150000.0))
    rng = np.random.default_rng(22)
    xs = (rng.standard_normal((2, 2, 512))
          + 1j * rng.standard_normal((2, 2, 512))).astype(np.complex64)

    async def main():
        sender, connector = new_sender()
        blk = RuntimeBlock(spec)
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)
        await sender.send(Samples(384000.0, xs[0]))
        await until(lambda: len(sink.chunks) >= 1)
        blk.update_filter(lp(50000.0))
        await sender.send(Samples(384000.0, xs[1]))
        await until(lambda: len(sink.chunks) >= 2)
        assert blk.failure is None
        return blk._bound

    bound = run(main())
    want = Chain(Filter.new(lp(50000.0)), FmDemod(150000.0)
                 ).bind(StreamSig(2, 512, 384000.0))
    np.testing.assert_array_equal(
        np.asarray(bound.params[0]["response"]),
        np.asarray(want.params[0]["response"]))
    assert float(bound.params[1]) == float(want.params[1])


def test_rechunker_shrink_to_exact_patchwork_emits_not_drops():
    """A live shrink to exactly the buffered patchwork length emits the
    complete chunk instead of raising SamplesLost (off-by-one guard)."""
    async def main():
        sender, connector = new_sender()
        rc = Rechunker(8)
        sink = ArraySink()
        rc.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(rc)
        data = np.arange(1, 5, dtype=np.complex64)      # patchwork of 4
        await sender.send(Samples(8000.0, data))
        await asyncio.sleep(0.05)                       # let it buffer
        rc.set_output_chunk_len(4)
        more = np.arange(5, 9, dtype=np.complex64)
        await sender.send(Samples(8000.0, more))
        await until(lambda: len(sink.chunks) >= 2)
        return sink.chunks, sink.events

    chunks, events = run(main())
    assert not any(isinstance(e, SamplesLost) for e in events)
    np.testing.assert_array_equal(chunks[0], np.arange(1, 5))
    np.testing.assert_array_equal(chunks[1], np.arange(5, 9))


# ---------------------------------------------------------------------------
# Two-phase send: a Reservation claims the slot (broadcast_bp.rs:225-292)
# ---------------------------------------------------------------------------

def test_reservation_claims_slot_against_competing_send():
    async def main():
        sender, connector = new_sender()
        receiver, rc = new_receiver()
        rc.connect(connector)
        recv1 = asyncio.ensure_future(receiver.recv())
        await asyncio.sleep(0)  # let the receiver subscribe
        # Claim the slot, then race a plain send against it: the plain
        # send must wait for the reservation's commit (the reference holds
        # the channel guard inside Reservation).
        res = await sender.reserve()
        plain = asyncio.ensure_future(sender.send("second"))
        await asyncio.sleep(0.05)
        assert not plain.done()  # blocked on the outstanding reservation
        res.send("first")
        assert await recv1 == "first"
        assert await receiver.recv() == "second"
        await plain
    run(main())


def test_reservation_cancel_releases_slot():
    async def main():
        sender, connector = new_sender()
        receiver, rc = new_receiver()
        rc.connect(connector)
        recv1 = asyncio.ensure_future(receiver.recv())
        await asyncio.sleep(0)  # let the receiver subscribe
        res = await sender.reserve()
        plain = asyncio.ensure_future(sender.send("x"))
        await asyncio.sleep(0.02)
        assert not plain.done()
        res.cancel()
        await plain  # proceeds once the claim is dropped
        assert await recv1 == "x"
        with pytest.raises(RuntimeError):
            res.send("y")  # a cancelled reservation cannot commit
    run(main())


def test_reservation_send_raises_when_channel_closed():
    async def main():
        sender, connector = new_sender()
        receiver, rc = new_receiver()
        rc.connect(connector)
        recv1 = asyncio.ensure_future(receiver.recv())
        await asyncio.sleep(0)  # let the receiver subscribe
        res = await sender.reserve()
        recv1.cancel()
        try:
            await recv1
        except asyncio.CancelledError:
            pass
        receiver.close()
        connector.close()
        with pytest.raises(ChannelClosed):
            res.send("lost")  # all receivers and the enlister are gone
    run(main())


def test_typed_setters_compose_across_rebind():
    # set_gain then set_deviation: BOTH must survive a mid-stream rebind
    # (one override slot per tunable; previously last-writer-wins).
    from radiorust_tpu.blocks.base import Chain
    from radiorust_tpu.blocks.modulation import FmDemod, FmMod

    async def main():
        sender, connector = new_sender()
        blk = RuntimeBlock(Chain(FmMod(5000.0), FmDemod(5000.0),
                                 GainControl(1.0)), name="c")
        sink = ArraySink()
        blk.feed_from(type("P", (), {"sender_connector": connector})())
        sink.feed_from(blk)

        x = (0.25 * np.ones(256)).astype(np.complex64)
        await sender.send(Samples(8000.0, x))
        await until(lambda: len(sink.chunks) == 1)
        blk.set_gain(2.0)
        blk.set_deviation(2500.0)  # mod+demod retune together: passthrough
        # Different chunk length forces a rebind: both retunes re-apply.
        await sender.send(Samples(8000.0, np.resize(x, 128)))
        await until(lambda: len(sink.chunks) == 2)
        assert blk.failure is None
        # mod/demod deviations cancel; gain doubles the steady level.
        got = np.real(sink.chunks[1][8:])
        np.testing.assert_allclose(got, 0.5, atol=1e-3)

    run(main())


def test_array_source_emits_partial_tail():
    async def main():
        data = np.arange(10, dtype=np.complex64)
        src = ArraySource(data, chunk_len=4, sample_rate=1000.0)
        sink = ArraySink()
        sink.feed_from(src)
        await until(lambda: sum(len(c) for c in sink.chunks) >= 10)
        assert [len(c) for c in sink.chunks] == [4, 4, 2]
        np.testing.assert_array_equal(sink.samples, data)

    run(main())


def test_array_source_repeat_is_gap_free():
    # The wrap-straddling tail stitches onto the next cycle: the repeated
    # stream is data tiled with no dropped samples (no silent splice).
    async def main():
        data = np.arange(10, dtype=np.complex64)
        src = ArraySource(data, chunk_len=4, sample_rate=1000.0,
                          repeat=True)
        sink = ArraySink()
        sink.feed_from(src)
        await until(lambda: sum(len(c) for c in sink.chunks) >= 30)
        src.stop()
        got = sink.samples[:30]
        np.testing.assert_array_equal(got, np.resize(data, 30))

    run(main())
