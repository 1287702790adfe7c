"""Pipeline parallelism: one chain stage per device, overlapped in flight.

The reference's *only* parallelism is task/pipeline parallelism — every
block spawns a Tokio task and a chain of k blocks runs up to k CPU cores
deep, with pipelining depth bounded by the capacity-1 channels
(``src/blocks/mod.rs:27-34``, ``src/flow.rs:44-52``).  This module is the
device analog of that execution model: a bound chain is partitioned
into contiguous *stages*, each stage is compiled into its own XLA program
resident on its own device (params and carried state stay device-local),
and a software pipeline drives one chunk per stage per tick.  All stage
dispatches in a tick are issued before any result is awaited, so JAX's
async dispatch runs the stages concurrently — the device-level analog of
k parked tasks each holding one in-flight chunk.  Inter-stage handoffs
are device-to-device transfers (NVLink between GPUs of one host).

When to use which parallel axis:

- ``time_shard`` (sequence parallelism) scales a *single* chain with no
  pipeline bubble, but requires every block to have a halo-expressible
  state (``_HANDLERS``).  Blocks with sequential per-sample recurrences —
  ``SlewRateLimiter`` (``src/blocks/filters.rs:338-349``) — cannot.
- ``PipelinedChain`` scales *any* chain, because each stage keeps its
  own sequential state locally; throughput is set by the slowest stage
  and a warm-up bubble of (stages - 1) chunks, exactly like the
  reference's chain latency of one chunk per channel hop
  (``src/flow.rs:51-52``).

Wire discipline: every jit boundary uses the packed float32-plane format
(:func:`radiorust_tpu.blocks.base.pack_wire`) — complex values never
cross a program boundary; inter-stage chunks travel packed and are
reconstructed inside the next stage's program.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..blocks.base import (BoundBlock, _BoundChain, pack_wire, unpack_wire)

__all__ = ["PipelinedChain", "CrossProcessPipeline", "balance_partition"]


def balance_partition(n_blocks: int, n_stages: int) -> List[int]:
    """Contiguous block counts per stage, as even as possible.

    With no per-block cost model the best static split is equal block
    counts; pass an explicit ``partition`` to :class:`PipelinedChain` to
    encode measured stage costs instead.
    """
    if not (1 <= n_stages <= n_blocks):
        raise ValueError(f"need 1 <= stages ({n_stages}) <= blocks "
                         f"({n_blocks})")
    base, extra = divmod(n_blocks, n_stages)
    return [base + (i < extra) for i in range(n_stages)]


class _Stage:
    """One pipeline stage: a contiguous sub-chain compiled for one device."""

    def __init__(self, blocks: Sequence[BoundBlock], device):
        self.bound = blocks[0] if len(blocks) == 1 else _BoundChain(blocks)
        self.device = device
        in_b = self.bound.in_sig.batch
        out_b = self.bound.out_sig.batch
        bound = self.bound

        def step(pp, ps, px, reset):
            state, y = bound.process(unpack_wire(pp), unpack_wire(ps),
                                     unpack_wire(px), reset)
            # Batch-growing stages (channelizer) expand the reset mask so
            # the next stage sees one flag per output stream.
            out_reset = (jnp.repeat(reset, out_b // in_b)
                         if out_b != in_b else reset)
            return pack_wire(state), pack_wire(y), out_reset

        self.step = jax.jit(step)
        self.params = jax.device_put(pack_wire(self.bound.params), device)
        self.state = jax.device_put(pack_wire(self.bound.init_state()),
                                    device)

    def reset_state(self):
        self.state = jax.device_put(pack_wire(self.bound.init_state()),
                                    self.device)


class PipelinedChain:
    """Executes a bound chain with one stage per device, pipelined.

    ``push(x, reset)`` feeds one input chunk and returns the output chunk
    that left the last stage this tick, or ``None`` during the initial
    fill (the first output returns on the ``len(stages)``-th push).
    ``push(None)`` ticks the pipeline without feeding (drain).  ``run(xs)``
    is the bulk helper: feed T chunks, drain, return ``[T, batch, n]``.

    Semantically identical to scanning the chain sequentially — the
    pipeline only changes *where* and *when* each stage executes.
    """

    def __init__(self, bound_chain: _BoundChain, devices=None,
                 partition: Optional[Sequence[int]] = None):
        blocks = list(bound_chain.blocks)
        if devices is None:
            devices = jax.devices()[:len(blocks)]
        devices = list(devices)
        if partition is None:
            partition = balance_partition(len(blocks), len(devices))
        if len(partition) != len(devices):
            raise ValueError("partition and devices length mismatch")
        if sum(partition) != len(blocks):
            raise ValueError(f"partition {partition} does not cover "
                             f"{len(blocks)} blocks")
        self.bound = bound_chain
        self.in_sig = bound_chain.in_sig
        self.out_sig = bound_chain.out_sig
        self.stages: List[_Stage] = []
        i = 0
        for cnt, dev in zip(partition, devices):
            self.stages.append(_Stage(blocks[i:i + cnt], dev))
            i += cnt
        # buf[s] = packed (chunk, reset) waiting at stage s's door (already
        # on stage s's device), or None while the pipeline fills/drains.
        self._buf: List[Optional[tuple]] = [None] * len(self.stages)

    @property
    def depth(self) -> int:
        return len(self.stages)

    def reset(self):
        """Drop all in-flight chunks and re-init every stage's state."""
        self._buf = [None] * len(self.stages)
        for st in self.stages:
            st.reset_state()

    def push(self, x=None, reset=None):
        """One pipeline tick.  ``x``: [batch, chunk_len] complex (host or
        device) or None to drain.  The fed chunk enters stage 0 *this*
        tick, so the first output returns on the ``len(stages)``-th push
        (warm-up bubble = stages-1 chunks).  Returns the last stage's
        output chunk (packed device value — use :func:`radiorust_tpu.
        blocks.base.unpack_wire` or :meth:`run` for host complex), or
        None."""
        stages = self.stages
        if x is not None:
            if reset is None:
                reset = np.zeros((self.in_sig.batch,), dtype=bool)
            # Pack on the HOST (numpy) before any jax op: complex values
            # cross program boundaries only in the wire format.
            self._buf[0] = (
                jax.device_put(pack_wire(np.asarray(x)), stages[0].device),
                jax.device_put(np.asarray(reset), stages[0].device))
        outs: List[Optional[tuple]] = [None] * len(stages)
        # Dispatch every occupied stage this tick before awaiting anything:
        # JAX async dispatch overlaps the stage programs across devices.
        for s, stage in enumerate(stages):
            item = self._buf[s]
            if item is None:
                continue
            px, rst = item
            stage.state, y, out_rst = stage.step(stage.params, stage.state,
                                                 px, rst)
            outs[s] = (y, out_rst)
        # Shift: stage s's output becomes stage s+1's pending input.
        for s in range(len(stages) - 1, 0, -1):
            prev = outs[s - 1]
            if prev is None:
                self._buf[s] = None
            else:
                y, rst = prev
                self._buf[s] = (
                    jax.device_put(y, stages[s].device),
                    jax.device_put(rst, stages[s].device))
        self._buf[0] = None
        tail = outs[-1]
        return None if tail is None else tail[0]

    def save_checkpoint(self, path: str) -> None:
        """Serialize the full pipeline snapshot mid-stream: every stage's
        carried state **and** the in-flight inter-stage chunks.  A pipeline
        holds up to ``depth - 1`` chunks in flight between pushes; dropping
        them would lose samples on resume, so they are part of the
        checkpoint (the analog of the reference's capacity-1 channel slots,
        ``src/flow.rs:44-52``, being persisted along with block state).
        Restore with :meth:`load_checkpoint` on a pipeline built from the
        same chain and partition."""
        from ..utils.checkpoint import save_state
        stages = [unpack_wire(jax.device_get(st.state))
                  for st in self.stages]
        bufs = [() if b is None else
                (unpack_wire(jax.device_get(b[0])),
                 np.asarray(jax.device_get(b[1])))
                for b in self._buf]
        save_state(path, {"stages": stages, "bufs": bufs})

    def load_checkpoint(self, path: str) -> None:
        """Resume from :meth:`save_checkpoint` (possibly in another
        process): stage states and in-flight chunks land back on their
        stages' devices; the next ``push`` continues bit-exactly."""
        from ..utils.checkpoint import load_state
        data = load_state(path)
        if len(data["stages"]) != len(self.stages):
            raise ValueError(
                f"checkpoint has {len(data['stages'])} stages, pipeline "
                f"has {len(self.stages)}: partition must match")
        for st, s in zip(self.stages, data["stages"]):
            st.state = jax.device_put(pack_wire(s), st.device)
        self._buf = [
            None if len(b) == 0 else
            (jax.device_put(pack_wire(b[0]), self.stages[i].device),
             jax.device_put(np.asarray(b[1]), self.stages[i].device))
            for i, b in enumerate(data["bufs"])]

    def run(self, xs, resets=None):
        """Bulk: feed ``xs[T, batch, chunk_len]``, drain, return host
        complex outputs ``[T, batch, out_chunk_len]`` in order."""
        t_total = len(xs)
        if t_total == 0:
            return np.zeros((0, self.out_sig.batch, self.out_sig.chunk_len),
                            dtype=np.complex64)
        outs = []
        for t in range(t_total + self.depth - 1):
            x = xs[t] if t < t_total else None
            rst = None if (resets is None or t >= t_total) else resets[t]
            y = self.push(x, rst)
            if y is not None:
                outs.append(unpack_wire(jax.device_get(y)))
        assert len(outs) == t_total, (len(outs), t_total)
        return np.stack(outs)


class CrossProcessPipeline:
    """Pipeline parallelism ACROSS PROCESSES (multi-host): stage *i* of a
    bound chain runs in process *i*; chunks hop host-to-host through a
    compiled collective permute on a one-device-per-process ``stage``
    mesh.

    :class:`PipelinedChain` is single-controller — it ``device_put``\\ s
    chunks onto specific devices, which only works when every stage's
    device is addressable.  On a pod, each host addresses only its own
    chips, so the inter-stage handoff must itself be a collective: every
    tick, all processes enter one tiny SPMD program that ppermutes a
    ``[P, L]`` buffer of wire-packed chunks one stage to the right
    (stage *i* -> *i+1*, the device analog of the reference's
    capacity-1 channel hop, ``src/flow.rs:44-52``), then each process
    runs its OWN stage's locally-jitted program on what it received.
    Per-stage carried state never leaves its process.

    Stage boundaries may change the chunk signature (resamplers,
    channelizers): rows are zero-padded to the largest stage output's
    packed length and re-sliced by the receiver using the chain's
    structural binding (every process binds the full chain host-side —
    cheap design math — but compiles only its own stage).

    Warm-up bubble: stage *i* idles for the first *i* ticks (its state
    is untouched while no valid chunk has reached it), exactly like the
    reference's one-chunk-per-hop chain latency (``src/flow.rs:51-52``);
    ``run`` drives ``T + S - 1`` ticks and each group's LAST stage
    process returns the ``T`` outputs (other processes return ``None``).
    v1 scope: no mid-stream resets/events (use the single-host pipeline
    for those).

    ``groups=G`` composes the pipeline axis with the channel (stream)
    axis: the P processes form a (G groups x S stages) grid of G
    independent pipeline replicas, each serving its own batch slice —
    the serving-fleet layout where both scaling axes are populated at
    once (one big mesh dimension hides process-count assumptions that a
    single-axis layout never exercises).
    """

    def __init__(self, bound_chain: _BoundChain,
                 partition: Optional[Sequence[int]] = None,
                 groups: int = 1):
        import jax as _jax
        from jax.sharding import Mesh, NamedSharding
        from jax.sharding import PartitionSpec as P

        self.pid = _jax.process_index()
        nproc = _jax.process_count()
        if nproc < 2:
            raise ValueError("CrossProcessPipeline needs a multi-process "
                             "job (jax.distributed.initialize)")
        # ``groups`` composes the pipeline axis with the channel (stream)
        # axis: the processes form a (group, stage) grid — G independent
        # pipeline replicas of S stages each, every replica serving its
        # own slice of the stream batch.  ``bound_chain`` is the
        # PER-GROUP chain (its batch = streams per group); ``run`` takes
        # the full [T, groups*batch, n] stream and routes rows
        # g*batch:(g+1)*batch into group g's stage 0.
        if groups < 1 or nproc % groups:
            raise ValueError(f"groups={groups} must divide the process "
                             f"count ({nproc})")
        self.groups = groups
        stages = nproc // groups
        if stages < 2:
            raise ValueError("each pipeline group needs >= 2 stages")
        self.stages = stages
        self.gid, self.sid = divmod(self.pid, stages)
        blocks = list(bound_chain.blocks)
        if partition is None:
            partition = balance_partition(len(blocks), stages)
        if len(partition) != stages:
            raise ValueError(f"partition {partition} must have one stage "
                             f"per group process ({stages})")
        if sum(partition) != len(blocks) or min(partition) < 1:
            raise ValueError(f"partition {partition} does not cover "
                             f"{len(blocks)} blocks with >=1 per stage")
        self.bound = bound_chain
        self.in_sig = bound_chain.in_sig
        self.out_sig = bound_chain.out_sig
        self.depth = nproc
        # Structural binding of EVERY stage (host design math only), so
        # each process knows each handoff's packed layout; compile only
        # this process's stage, on its first local device.
        bounds = []
        i = 0
        for cnt in partition:
            sub = blocks[i:i + cnt]
            bounds.append(sub[0] if len(sub) == 1 else _BoundChain(sub))
            i += cnt
        from ..numbers import stream_complex, stream_real
        self._row_dtype = stream_real()   # handoff rows follow the policy
        self._stage_out_tpl = []     # per-stage packed-output template
        for bnd in bounds:
            z = np.zeros((bnd.out_sig.batch, bnd.out_sig.chunk_len),
                         stream_complex())
            packed = pack_wire(z)
            leaves, tdef = _jax.tree.flatten(packed)
            self._stage_out_tpl.append(
                (tdef, [l.shape for l in leaves],
                 int(sum(np.prod(l.shape) for l in leaves))))
        self._row_len = max(t[2] for t in self._stage_out_tpl)
        self.stage = _Stage([bounds[self.sid]]
                            if not hasattr(bounds[self.sid], "blocks")
                            else list(bounds[self.sid].blocks),
                            _jax.local_devices()[0])
        # One-device-per-process handoff mesh + the shift program.  Must
        # pick each process's FIRST device — the same one the stage
        # programs and `run`'s device_puts use (a dict comprehension
        # would keep the last, breaking make_array_from_single_device_
        # arrays on multi-device hosts).
        devs: dict = {}
        for d in _jax.devices():
            devs.setdefault(d.process_index, d)
        mesh = Mesh(np.array([devs[p] for p in range(nproc)]), ("stage",))
        self._sharding = NamedSharding(mesh, P("stage"))
        # Handoffs stay INSIDE each group's stage run: no pair crosses a
        # group boundary, so the G pipelines are independent replicas.
        perm = [(g * stages + i, g * stages + i + 1)
                for g in range(groups) for i in range(stages - 1)]
        self._shift = _jax.jit(_jax.shard_map(
            lambda r: _jax.lax.ppermute(r, "stage", perm),
            mesh=mesh, in_specs=P("stage"), out_specs=P("stage")))

    def _pack_row(self, packed_out) -> np.ndarray:
        import jax as _jax
        rdt = self._row_dtype
        leaves = _jax.tree.leaves(_jax.device_get(packed_out))
        flat = np.concatenate([np.asarray(l, rdt).ravel()
                               for l in leaves]) if leaves else \
            np.zeros((0,), rdt)
        row = np.zeros((self._row_len,), rdt)
        row[:flat.size] = flat
        return row

    def _unpack_row(self, row: np.ndarray, stage: int):
        import jax as _jax
        tdef, shapes, _ = self._stage_out_tpl[stage]
        leaves, pos = [], 0
        for shp in shapes:
            k = int(np.prod(shp))
            leaves.append(row[pos:pos + k].reshape(shp))
            pos += k
        return unpack_wire(_jax.tree.unflatten(tdef, leaves))

    def run(self, xs):
        """Feed ``xs`` ([T, groups*batch, chunk_len] complex, identical on
        every process — group g's stage 0 consumes rows
        ``g*batch:(g+1)*batch``), run ``T + S - 1`` ticks, and return the
        ``T`` output chunks on each group's LAST stage process (``None``
        elsewhere).  Every process must call this with the same T."""
        import jax as _jax
        t_total = len(xs)
        sid, stages = self.sid, self.stages
        bs = self.in_sig.batch
        if xs[0].shape[0] != self.groups * bs:
            raise ValueError(
                f"xs batch {xs[0].shape[0]} != groups*batch "
                f"({self.groups}x{bs})")
        recv = np.zeros((self._row_len,), self._row_dtype)
        outs = []
        no_reset = np.zeros((self.stage.bound.in_sig.batch,), bool)
        for t in range(t_total + stages - 1):
            have = sid <= t < t_total + sid
            if have:
                if sid == 0:
                    xin = np.asarray(
                        xs[t][self.gid * bs:(self.gid + 1) * bs])
                else:
                    xin = np.asarray(self._unpack_row(recv, sid - 1))
                self.stage.state, py, _ = self.stage.step(
                    self.stage.params, self.stage.state,
                    pack_wire(xin), no_reset)
                if sid == stages - 1:
                    outs.append(unpack_wire(_jax.device_get(py)))
                    # The shift permutation sends the last stage's row
                    # nowhere: skip the redundant device fetch of the
                    # largest packed row per tick.
                    row = np.zeros((self._row_len,), self._row_dtype)
                else:
                    row = self._pack_row(py)
            else:
                row = np.zeros((self._row_len,), self._row_dtype)
            shard = _jax.device_put(row[None, :],
                                    _jax.local_devices()[0])
            g = _jax.make_array_from_single_device_arrays(
                (self.depth, self._row_len), self._sharding, [shard])
            shifted = self._shift(g)
            recv = np.asarray(
                next(iter(shifted.addressable_shards)).data)[0]
        if sid == stages - 1:
            assert len(outs) == t_total, (len(outs), t_total)
            return np.stack(outs)
        return None
