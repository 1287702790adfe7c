#!/usr/bin/env python
"""Scale-out receiver fleet on a device mesh — the multi-chip serving APIs.

The radiorust way to serve many receivers is many independent block
graphs, one per stream, scheduled by Tokio across cores
(``src/blocks/mod.rs:27-34``).  Here a *mesh* serves them:

1. **Data-parallel serving**: one ``RuntimeBlock(wfm_receiver(),
   mesh=...)`` actor demodulates a fleet of independent FM streams —
   batched ``[streams, n]`` chunks shard their stream axis across the
   mesh (per-stream state splits, params replicate, no collectives).
2. **Channel (expert) parallelism**: one wideband input splits into 64
   channels via the polyphase filterbank, with the PFB's branch groups,
   DFT channel columns, and per-channel FM demod all sharded over the
   same devices (``ChannelShardedChain`` — one ``all_gather`` per step).

Runs on several GPUs and, as here, on a virtual 8-device CPU mesh.
"""

import asyncio
import os
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

# A virtual 8-device mesh when no multi-chip hardware is present.
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax
import numpy as np
from jax.sharding import Mesh

from radiorust_tpu.blocks.base import StreamSig
from radiorust_tpu.models.channelizer import channelized_receiver
from radiorust_tpu.models.wfm import WFM_INPUT_RATE, wfm_receiver
from radiorust_tpu.parallel.channel_shard import ChannelShardedChain
from radiorust_tpu.runtime import ArraySink, RuntimeBlock, wait_until
from radiorust_tpu.runtime.flow import new_sender
from radiorust_tpu.signal import Samples

CHUNK = 2048
STEPS = 4


def fm_modulate(tone_hz, rate, n, deviation, phase0=0.0):
    t = np.arange(n) / rate
    audio = 0.5 * np.sin(2 * np.pi * tone_hz * t)
    phase = phase0 + 2 * np.pi * deviation * np.cumsum(audio) / rate
    return np.exp(1j * phase).astype(np.complex64)


def dominant_tone(audio, rate):
    w = np.abs(np.fft.rfft(audio * np.hanning(audio.size)))
    return (np.argmax(w[1:]) + 1) * rate / audio.size


async def serve_fleet(mesh):
    """16 independent FM stations through ONE mesh-sharded actor."""
    tones = np.linspace(400.0, 3400.0, 16)
    xs = np.stack([
        fm_modulate(t, WFM_INPUT_RATE, STEPS * CHUNK, 75000.0, phase0=i)
        for i, t in enumerate(tones)])                  # [16, steps*n]
    xs = np.moveaxis(xs.reshape(16, STEPS, CHUNK), 1, 0)

    sender, connector = new_sender()
    fleet = RuntimeBlock(wfm_receiver(), mesh=mesh, name="fleet")
    sink = ArraySink()
    fleet.feed_from(type("P", (), {"sender_connector": connector})())
    sink.feed_from(fleet)
    for s in range(STEPS):
        await sender.send(Samples(WFM_INPUT_RATE, xs[s]))
    await wait_until(  # fail fast if the actor failed
        lambda: len(sink.chunks) >= STEPS, fleet, sink)

    audio = np.concatenate(sink.chunks, axis=-1).real  # [16, steps*out]
    audio_rate = sink.sample_rate
    hits = sum(
        abs(dominant_tone(audio[i, CHUNK // 64:], audio_rate) - tones[i])
        < audio_rate / audio.shape[-1] * 2
        for i in range(16))
    print(f"fleet: {hits}/16 streams demodulated to their tone "
          f"({len(mesh.devices.flat)} devices, stream axis sharded)")


def wideband(mesh):
    """One 16.4 Msps wideband stream -> 64 channels, channel-sharded."""
    rate = 16384000.0
    chain = channelized_receiver(num_channels=64, input_rate=rate)
    bound = chain.bind(StreamSig(1, 8192, rate))
    cs = ChannelShardedChain(bound, mesh, axis="c")

    # Stations on channels 7, 21, 42.
    n_total = STEPS * 8192
    t = np.arange(n_total) / rate
    x = np.zeros(n_total, np.complex128)
    stations = {7: 700.0, 21: 2100.0, 42: 1300.0}
    for c, tone in stations.items():
        iq = fm_modulate(tone, rate, n_total, 0.25 * rate / 64)
        x += iq * np.exp(2j * np.pi * (c * rate / 64) * t)
    xs = x.astype(np.complex64).reshape(STEPS, 1, 8192)

    # Drive the sharded program through the wire-safe step: complex leaves
    # cross the jit boundary as packed float32 planes (the way
    # RuntimeBlock drives it).
    from radiorust_tpu.blocks.base import pack_wire, unpack_wire
    step = cs.jit_step()
    pstate = pack_wire(cs.init_state())
    pparams = pack_wire(cs.params)
    reset = np.zeros((1,), dtype=bool)
    outs = []
    for s in range(STEPS):
        pstate, py = step(pparams, pstate, pack_wire(xs[s]), reset)
        outs.append(np.asarray(unpack_wire(jax.tree.map(np.asarray, py))))
    audio = np.concatenate(outs[1:], axis=-1).real      # skip warmup chunk
    ch_rate = rate / 64
    ok = 0
    for c, tone in stations.items():
        got = dominant_tone(audio[c], ch_rate)
        ok += abs(got - tone) < ch_rate / audio.shape[-1] * 2
    print(f"wideband: {ok}/{len(stations)} stations found on their "
          f"channels (64-ch PFB, channel axis sharded)")


async def single_stream_time_sharded(mesh):
    """ONE stream served by the whole mesh: ``shard="time"`` splits each
    group chunk of D*chunk_len samples into D consecutive device chunks
    with halo exchange (the single-stream speedup axis — ~92% predicted
    efficiency at batch 1, docs/SCALING.md)."""
    d = len(mesh.devices.flat)
    tone = 1200.0
    x = fm_modulate(tone, WFM_INPUT_RATE, STEPS * d * CHUNK, 75000.0)
    groups = x.reshape(STEPS, 1, d * CHUNK)

    sender, connector = new_sender()
    rx = RuntimeBlock(wfm_receiver(), mesh=mesh, shard="time",
                      name="single")
    sink = ArraySink()
    rx.feed_from(type("P", (), {"sender_connector": connector})())
    sink.feed_from(rx)
    for s in range(STEPS):
        await sender.send(Samples(WFM_INPUT_RATE, groups[s]))
    await wait_until(lambda: len(sink.chunks) >= STEPS, rx, sink)

    audio = np.concatenate(sink.chunks, axis=-1).real[0]
    got = dominant_tone(audio[CHUNK // 8:], sink.sample_rate)
    ok = abs(got - tone) < sink.sample_rate / audio.size * 4
    print(f"single stream: tone {got:.0f} Hz recovered "
          f"({'ok' if ok else 'WRONG'}; {d} devices, time axis sharded)")


def main():
    devs = jax.devices()
    mesh = Mesh(np.array(devs), ("streams",))
    asyncio.run(serve_fleet(mesh))
    wideband(Mesh(np.array(devs), ("c",)))
    asyncio.run(single_stream_time_sharded(Mesh(np.array(devs), ("t",))))


if __name__ == "__main__":
    main()
