"""Runtime block actors.

Each runtime block mirrors the reference's uniform block pattern
(``src/blocks/mod.rs:193-239``): construction spawns an asyncio task that
loops ``recv -> process -> send``, forwards events transparently, and
resets stream state on interrupt events.  :class:`RuntimeBlock` wraps *any*
compiled block spec (:class:`radiorust_tpu.blocks.base.Block`): the spec is
re-bound whenever the incoming chunk length or sample rate changes (the
analog of the reference recomputing designs on change,
``src/blocks/filters.rs:179-183``), and every chunk's math runs on device
through the bound block's jitted ``process``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import numpy as np

from ..blocks.base import Block, StreamSig
from ..bufferpool import Chunk, ChunkBuf, ChunkBufPool
from ..signal import (BufferOverflow, Disconnection, Event, EventHandlers,
                      EventHandling, Samples, SamplesLost, Warmup)
from .flow import (ChannelClosed, Receiver, ReceiverConnector, Sender,
                   SenderConnector, new_receiver, new_sender)

__all__ = [
    "RuntimeBlock", "RuntimeGraph", "MapSignal", "Silence", "Blackhole",
    "Buffer", "Rechunker", "KeyerSource", "ArraySource", "ArraySink",
    "FileSink", "wait_until",
]


async def wait_until(predicate: Callable[[], bool], *actors,
                     poll: float = 0.02,
                     timeout: Optional[float] = 120.0) -> None:
    """Await ``predicate()`` becoming true while watching ``actors``.

    A failed actor stops emitting, so a bare "wait for N output chunks"
    loop would hang forever; this surfaces any recorded ``.failure`` as
    the error instead (chained), and raises :class:`TimeoutError` after
    ``timeout`` seconds (``None`` disables the deadline)."""
    loop = asyncio.get_running_loop()
    deadline = None if timeout is None else loop.time() + timeout
    while not predicate():
        for a in actors:
            f = getattr(a, "failure", None)
            if f is not None:
                raise RuntimeError(
                    f"{getattr(a, 'name', type(a).__name__)} failed") from f
        if deadline is not None and loop.time() > deadline:
            raise TimeoutError("condition not reached before timeout")
        await asyncio.sleep(poll)


def _resolve_mesh_axis(mesh, mesh_axis: Optional[str]) -> Optional[str]:
    """Validate/default the data-parallel serving axis at construction so
    a typo'd axis name raises where it was made, not as a deferred
    KeyError inside the actor coroutine (where _record_failure would bury
    it)."""
    if mesh is None:
        if mesh_axis is not None:
            raise ValueError("mesh_axis given without a mesh")
        return None
    if mesh_axis is None:
        return mesh.axis_names[0]
    if mesh_axis not in mesh.axis_names:
        raise ValueError(f"mesh_axis {mesh_axis!r} not an axis of the mesh "
                         f"(axes: {mesh.axis_names})")
    return mesh_axis


class _TaskMixin:
    failure: Optional[Exception] = None  # fatal error, if any

    def _record_failure(self, exc: Exception) -> None:
        """A failure in user code (filter design closure, map closure) or
        device dispatch must not die silently: the reference's task would
        panic visibly on stderr.  Record it and log it; the caller falls
        through to its teardown so peers observe ChannelClosed instead of
        a silent stall."""
        self.failure = exc
        logging.getLogger(__name__).exception(
            "block %r failed; tearing down its channels",
            getattr(self, "name", type(self).__name__))

    def stop(self) -> None:
        """Cancel this block's task (the reference's struct-drop analog:
        the task exits and its endpoints close, releasing blocked peers)."""
        task = getattr(self, "_task", None)
        if task is not None:
            task.cancel()


class _ProducerMixin(_TaskMixin):
    sender_connector: SenderConnector

    def feed_into(self, consumer) -> None:
        consumer.receiver_connector.connect(self.sender_connector)


class _ConsumerMixin(_TaskMixin):
    receiver_connector: ReceiverConnector

    def feed_from(self, producer) -> None:
        self.receiver_connector.connect(producer.sender_connector)

    def feed_from_none(self) -> None:
        self.receiver_connector.disconnect()


def _spawn(coro):
    return asyncio.get_running_loop().create_task(coro)


def _trace_check(step, params, state, in_sig):
    """Abstractly trace a wire-packed sharded group step at construction
    (``jax.eval_shape``: no compile, no device work, no eager complex).
    The sharded executors reject unsupported configurations with
    ValueError/NotImplementedError *inside* their traced handlers; without
    this, a lazily-jitted step defers those errors to the actor's first
    chunk — past the caller's single-device fallback window."""
    import numpy as _np

    from ..blocks.base import pack_wire as _pw

    def ab(tree):
        return jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(_np.shape(a),
                                           _np.result_type(a)), tree)

    # Probe dtype follows the stream policy (c128 under f64 stream mode),
    # so the traced step sees the same wire planes the actor's real chunks
    # will produce.
    from .. import numbers as _nums
    x = _np.zeros((in_sig.batch, in_sig.chunk_len), _nums.stream_complex())
    jax.eval_shape(step, ab(_pw(params)), ab(_pw(state)), ab(_pw(x)),
                   jax.ShapeDtypeStruct((in_sig.batch,), bool))


class RuntimeBlock(_ProducerMixin, _ConsumerMixin, EventHandling):
    """Streaming actor around a compiled block spec.

    The device-side program recompiles only when (batch, chunk_len,
    sample_rate) changes; bindings are cached.  Stream state carries
    across chunks and resets on interrupt events or rebinds.

    Chunks may be 1-D ``[n]`` (one stream, the reference's model) or 2-D
    ``[streams, n]`` — batched serving: one message carries a chunk step
    of many independent streams through one device program, amortizing
    the per-dispatch cost across the batch (outputs stay 2-D downstream).
    """

    def __init__(self, spec: Block, name: Optional[str] = None,
                 pipeline_depth: int = 0, mesh=None,
                 mesh_axis: Optional[str] = None, shard: str = "streams",
                 overlap: int = 1):
        from ..utils.profiling import GLOBAL_STATS
        self.spec = spec
        self.name = name or type(spec).__name__
        self.stats = GLOBAL_STATS.unique(self.name)
        # Mesh serving, two modes:
        # - shard="streams" (default): batched [streams, n] chunks shard
        #   their stream axis across mesh_axis — one actor serving a fleet
        #   of independent streams over the pod slice.  Chunks whose batch
        #   cannot shard (not divisible by the axis size, 1-D
        #   single-stream chunks, or a per-shard kernel constraint like
        #   the pair-packed blocks' even local batch) fall back to the
        #   single-device program.
        # - shard="channels": a channelizer-led chain splits its M
        #   channels (PFB branch groups + all downstream per-channel
        #   processing) across mesh_axis — one wideband stream served by
        #   the whole mesh (parallel.channel_shard.ChannelShardedChain).
        #   Falls back to the single-device program if the bound chain
        #   cannot channel-shard.
        # - shard="time": ONE stream (or a small batch) served by the
        #   whole mesh via sequence parallelism — each incoming chunk of
        #   D*chunk_len samples splits into D consecutive device chunks
        #   with ppermute halo exchange (parallel.time_shard.
        #   TimeShardedChain), the single-stream speedup regime
        #   (docs/SCALING.md efficiency table).  Falls back to the
        #   single-device program when the chunk length does not divide
        #   or a block cannot time-shard.  ``overlap=S`` enables
        #   sub-batch software pipelining of the halo exchanges
        #   (SCALING.md "Halo/compute overlap"; batch % S must be 0).
        if shard not in ("streams", "channels", "time"):
            raise ValueError(f"shard must be 'streams', 'channels' or "
                             f"'time', got {shard!r}")
        if shard in ("channels", "time") and mesh is None:
            raise ValueError(f"shard={shard!r} requires a mesh")
        self.shard = shard
        self.mesh = mesh
        self.overlap = overlap
        self.mesh_axis = _resolve_mesh_axis(mesh, mesh_axis)
        # Pipeline parallelism: with depth d > 0 the actor
        # keeps up to d chunks' device work in flight (JAX async dispatch)
        # and fetches d chunks behind, overlapping device compute with
        # downstream host work — the analog of the reference's
        # task-per-block pipelining across cores (src/blocks/mod.rs:27-34,
        # one in-flight chunk per edge).  Events flush the pipeline so
        # sample/event ordering is preserved exactly.  Depth 0 fetches
        # synchronously (adds no latency).
        self.pipeline_depth = pipeline_depth
        self._init_actor_fields()
        receiver, self.receiver_connector = new_receiver()
        self.sender, self.sender_connector = new_sender()
        self._bindings: Dict[Tuple[int, float], Any] = {}
        self._task = _spawn(self._run(receiver))

    def _init_actor_fields(self) -> None:
        """Shared actor state (RuntimeGraph.__init__ calls this too)."""
        # Events riding the stream are observable on any block, as the
        # reference's impl_block_trait! EventHandling provides
        # (src/blocks/mod.rs:126-142; invocation template
        # src/blocks/mod.rs:193-239).
        self.event_handlers = EventHandlers()
        self._bound = None
        self._state = None
        self._pstate = None  # packed (wire-format) device state
        self._pparams = None  # packed params cache (device-resident)
        self._pparams_src = None  # identity of the params it was built from
        self._sched_phase = None  # ragged-tail valid-prefix schedule mirror
        self._restored_state = None  # pending load_checkpoint state
        self.failure: Optional[Exception] = None  # fatal error, if any
        self._pending_reset = False
        # One override slot per tunable (the reference keeps one watch
        # channel per parameter): a rebind re-applies ALL live retunes,
        # not just the most recent one.
        self._param_overrides: Dict[str, Callable] = {}
        # Last value per typed setter, so the getters reflect a
        # pre-binding retune (the override only APPLIES at first bind).
        self._typed_values: Dict[str, float] = {}
        self.chunks_processed = 0


    def _get_bound(self, chunk_len: int, sample_rate: float,
                   batch: int = 1):
        key = (batch, chunk_len, sample_rate)
        bound = self._bindings.get(key)
        if bound is None:
            from ..blocks.base import jit_step, jit_step_sharded
            bound = self.spec.bind(StreamSig(batch, chunk_len, sample_rate))
            if (self.mesh is not None and self.shard in ("channels", "time")
                    and getattr(bound, "ragged_output", False)):
                # The channel/time mesh wrappers would emit un-trimmed
                # padded chunks — their group steps bypass the schedule
                # mirror.  Surface at bind time, not as silent padding
                # downstream.  (Data-parallel shard="streams" is FINE:
                # the batch axis shards, per-chunk schedule trimming is
                # batch-agnostic — tests/test_parallel.py proves the
                # sharded step bit-equal.)
                raise ValueError(
                    "phase-mode (arbitrary-ratio) resampler tails are not "
                    "supported under channel/time mesh serving; serve "
                    "single-device or data-parallel, or re-chunk to a "
                    "multiple of the resampling period")
            # Wire-safe step: complex leaves cross the jit boundary as
            # packed float32 planes.
            if self.mesh is not None and self.shard == "channels":
                from ..parallel.channel_shard import ChannelShardedChain
                try:
                    cs = ChannelShardedChain(bound, self.mesh,
                                             axis=self.mesh_axis)
                    cs._jit = cs.jit_step()
                    bound = cs
                except ValueError as e:
                    logging.getLogger(__name__).warning(
                        "%s: cannot channel-shard (%s); using the "
                        "single-device program", self.name, e)
                    bound._jit = jit_step(bound)
            elif self.mesh is not None and self.shard == "time":
                from ..parallel.time_shard import TimeShardedChain
                d = self.mesh.shape[self.mesh_axis]
                try:
                    if chunk_len % d:
                        raise ValueError(
                            f"chunk {chunk_len} not divisible by the "
                            f"time axis ({d} devices)")
                    inner = self.spec.bind(
                        StreamSig(batch, chunk_len // d, sample_rate))
                    ts = TimeShardedChain(inner, self.mesh,
                                          t_axis=self.mesh_axis,
                                          overlap=self.overlap)
                    ts._jit = ts.jit_step()
                    # The actor consumes/produces GROUP chunks.
                    ts.in_sig, ts.out_sig = ts.group_sigs()
                    # Force the trace NOW (abstract, no compile): the
                    # sharded handlers' capability rejections (overlap
                    # divisibility, halo-vs-chunk bounds) are raised at
                    # trace time, and they must land inside THIS
                    # fallback window, not at the actor's first chunk.
                    _trace_check(ts._jit, ts.params, ts.init_state(),
                                 ts.in_sig)
                    bound = ts
                except (ValueError, NotImplementedError) as e:
                    logging.getLogger(__name__).warning(
                        "%s: cannot time-shard (%s); using the "
                        "single-device program", self.name, e)
                    bound._jit = jit_step(bound)
            elif (self.mesh is not None
                    and bound.shard_batch_ok(
                        self.mesh.shape[self.mesh_axis])):
                bound._jit = jit_step_sharded(bound, self.mesh,
                                              self.mesh_axis)
            else:
                bound._jit = jit_step(bound)
            self._bindings[key] = bound
        return bound

    def update_params(self, fn: Callable[[Any, Any], Any],
                      slot: str = "update_params") -> None:
        """Host-side retune: ``fn(bound, params) -> params`` applied to the
        current and future bindings (analog of watch-channel setters).
        ``slot`` names the tunable: a later call with the same slot
        replaces it, while calls with different slots compose — each typed
        setter uses its own slot so e.g. a ``set_gain`` survives a
        subsequent ``set_deviation`` across rebinds."""
        self._param_overrides[slot] = fn
        if self._bound is not None:
            self._bound.params = fn(self._bound, self._bound.params)
            # Explicit cache drop: a user fn may mutate params IN PLACE
            # and return the same object, which the identity check in
            # the dispatch loop would read as "unchanged".
            self._pparams = None
            self._pparams_src = None

    # -- typed convenience setters (the reference's watch-channel API) -----
    #
    # Each setter locates the matching sub-block when this runtime block
    # wraps a Chain, mirroring the reference where every block has its own
    # watch channel.

    @staticmethod
    def _map_blocks(bound, params, fn):
        """Apply fn(block, block_params) -> new_params over a bound block,
        every sub-block of a bound chain, or every node of a bound graph;
        None leaves params unchanged."""
        from ..blocks.graph import BoundGraph
        if isinstance(bound, BoundGraph):
            out = []
            for node, pp in zip(bound.bound, params):
                if node is None:
                    out.append(pp)
                    continue
                new = fn(node, pp)
                out.append(pp if new is None else new)
            return tuple(out)
        # Anything exposing aligned .blocks/params tuples: _BoundChain and
        # the sharded chain wrappers (parallel.channel_shard).
        blocks = getattr(bound, "blocks", None)
        if blocks is not None:
            out = []
            for blk, pp in zip(blocks, params):
                new = fn(blk, pp)
                out.append(pp if new is None else new)
            return tuple(out)
        new = fn(bound, params)
        return params if new is None else new

    def _sync_state(self) -> None:
        """Pull the live (packed, device) stream state back into host form
        so host-side retunes can rewrite it."""
        if self._pstate is not None:
            from ..blocks.base import unpack_wire
            self._state = unpack_wire(jax.tree.map(np.asarray, self._pstate))
            self._pstate = None

    def _apply_typed(self, fn, slot: str) -> None:
        def override(bound, params):
            return self._map_blocks(bound, params, fn)
        self.update_params(override, slot=slot)

    def set_gain(self, gain: float) -> None:
        """``GainControl::set`` analog (src/blocks/transform.rs:89-91)."""
        import numpy as _np
        from ..blocks.transform import _BoundGain
        self._typed_values["set_gain"] = float(gain)
        self._apply_typed(lambda blk, p: _np.float32(gain)
                          if isinstance(blk, _BoundGain) else None,
                          slot="set_gain")

    def _blocks_and_params(self):
        from ..blocks.graph import BoundGraph
        bound = self._bound
        if bound is None:
            return None, None
        inner = getattr(bound, "bound", bound)   # sharded wrappers
        if isinstance(inner, (list, tuple)):
            # BoundGraph.bound is the NODE LIST, not a wrapper's inner
            # binding — the graph itself is the binding.
            inner = bound
        if isinstance(inner, BoundGraph):
            pairs = [(b, p) for b, p in zip(inner.bound, inner.params)
                     if b is not None]
            return (tuple(b for b, _ in pairs),
                    tuple(p for _, p in pairs))
        blocks = getattr(inner, "blocks", None)
        if blocks is None:
            return (inner,), (inner.params,)
        return blocks, inner.params

    def gain(self) -> float:
        """``GainControl::get`` analog (src/blocks/transform.rs:85-87):
        the current gain of the (first) GainControl."""
        from ..blocks.transform import _BoundGain
        blocks, params = self._blocks_and_params()
        if blocks is not None:
            for blk, p in zip(blocks, params):
                if isinstance(blk, _BoundGain):
                    return float(np.asarray(p))
        if "set_gain" in self._typed_values:
            # Pre-binding: a setter already registered a retune that the
            # first binding will apply.
            return self._typed_values["set_gain"]
        from ..blocks.transform import GainControl
        for spec in self._iter_specs():
            if isinstance(spec, GainControl):
                return float(spec.gain)
        raise ValueError("no GainControl to read")

    def _iter_specs(self):
        specs = getattr(self.spec, "specs", None)
        if specs is not None:
            return specs
        g = self.spec
        nodes = getattr(g, "_nodes", None)
        if nodes is not None:                       # Graph spec
            out = []
            for kind, payload in nodes:
                if kind not in ("input", "select") and payload:
                    out.append(payload[0])
            return out
        return [g]

    def shift(self) -> float:
        """``FreqShifter::shift`` analog (src/blocks/transform.rs:380-382):
        the current shift of the (first) FreqShifter."""
        from ..blocks.transform import _BoundFreqShifter
        blocks, _ = self._blocks_and_params()
        if blocks is not None:
            for blk in blocks:
                if isinstance(blk, _BoundFreqShifter):
                    return blk.current_shift
        if "set_shift" in self._typed_values:
            return self._typed_values["set_shift"]
        for spec in self._iter_specs():
            if hasattr(spec, "shift") and not callable(spec.shift):
                return float(spec.shift)
        raise ValueError("no FreqShifter to read")

    def update_shift(self, modify) -> None:
        """``FreqShifter::update_shift`` analog
        (src/blocks/transform.rs:388-390): read-modify-write retune with
        phase continuity.  Python closures take and return the value
        instead of mutating a reference:
        ``block.update_shift(lambda s: s + 100.0)``."""
        self.set_shift(float(modify(self.shift())))

    def set_agc(self, reference: float = None, rate: float = None,
                max_gain: float = None) -> None:
        """Retune AgcControl loop knobs (only the given ones) without
        touching the carried gain state."""
        import numpy as _np
        from ..blocks.transform import _BoundAgc

        def upd(blk, p):
            if not isinstance(blk, _BoundAgc):
                return None
            new = dict(p)
            if reference is not None:
                new["reference"] = _np.float32(reference)
            if rate is not None:
                new["rate"] = _np.float32(rate)
            if max_gain is not None:
                new["max_gain"] = _np.float32(max_gain)
            return new
        self._apply_typed(upd, slot="set_agc")

    def set_squelch(self, threshold: float = None,
                    alpha: float = None) -> None:
        """Retune Squelch gating knobs (only the given ones)."""
        import numpy as _np
        from ..blocks.transform import _BoundSquelch

        def upd(blk, p):
            if not isinstance(blk, _BoundSquelch):
                return None
            new = dict(p)
            if threshold is not None:
                new["threshold"] = _np.float32(threshold)
            if alpha is not None:
                new["alpha"] = _np.float32(alpha)
            return new
        self._apply_typed(upd, slot="set_squelch")

    def set_shift(self, shift: float) -> None:
        """``FreqShifter::set_shift`` analog with phase continuity
        (src/blocks/transform.rs:384-386): rewrites both the phasor tables
        and the carried phase state of the current binding."""
        self._typed_values["set_shift"] = float(shift)
        from ..blocks.transform import _BoundFreqShifter as shifters
        self._sync_state()
        if self._bound is not None and self._state is not None:
            bound = self._bound
            blocks = getattr(bound, "blocks", None)
            if blocks is not None:
                # _BoundChain and the sharded chain wrappers; retune's
                # phase fold is elementwise, so it also handles the
                # channel-sharded [batch, M]-shaped state leaves.
                params = list(bound.params)
                state = list(self._state)
                for i, blk in enumerate(blocks):
                    if isinstance(blk, shifters):
                        params[i], state[i] = blk.retune(params[i],
                                                         state[i], shift)
                bound.params = tuple(params)
                self._state = tuple(state)
                self._pparams = None
                self._pparams_src = None
            elif isinstance(bound, shifters):
                bound.params, self._state = bound.retune(
                    bound.params, self._state, shift)
                self._pparams = None
                self._pparams_src = None
        self._apply_typed(lambda blk, p: blk.shift_params(shift)
                          if isinstance(blk, shifters) else None,
                          slot="set_shift")

    def update_filter(self, freq_resp, window=None) -> None:
        """``Filter::update`` analog (src/blocks/filters.rs:279-297)."""
        from ..blocks.filters import _BoundFilter

        def fn(blk, p):
            if isinstance(blk, _BoundFilter):
                return blk.update_params(freq_resp, window)
            return None

        self._apply_typed(fn, slot="update_filter")

    def set_map_params(self, new_params) -> None:
        """Retune a parameterized ``MapSample.with_params`` closure without
        recompiling (the reference hot-swaps map closures over an mpsc,
        src/blocks/transform.rs:132-179; parameter updates are the
        compiled-path equivalent)."""
        from ..blocks.transform import _BoundMap

        def fn(blk, p):
            if isinstance(blk, _BoundMap) and blk._parameterized:
                return new_params
            return None

        self._apply_typed(fn, slot="set_map_params")

    def deviation(self) -> float:
        """``FmMod/FmDemod::deviation`` analog
        (src/blocks/modulation.rs:72-74,150-152): recovered from the
        (first) modulator/demodulator's traced factor param."""
        from ..numbers import TAU as _TAU
        from ..blocks.modulation import _BoundFmDemod, _BoundFmMod
        blocks, params = self._blocks_and_params()
        if blocks is not None:
            for blk, p in zip(blocks, params):
                if isinstance(blk, _BoundFmMod):
                    return float(np.asarray(p)) * blk.in_sig.sample_rate \
                        / _TAU
                if isinstance(blk, _BoundFmDemod):
                    return blk.in_sig.sample_rate / float(np.asarray(p)) \
                        / _TAU
        if "set_deviation" in self._typed_values:
            return self._typed_values["set_deviation"]
        for spec in self._iter_specs():
            if hasattr(spec, "deviation"):
                return float(spec.deviation)
        raise ValueError("no FmMod/FmDemod to read")

    def set_deviation(self, deviation: float) -> None:
        """``FmMod/FmDemod::set_deviation`` analog
        (src/blocks/modulation.rs:76-79,154-157)."""
        self._typed_values["set_deviation"] = float(deviation)
        import numpy as _np
        from ..numbers import TAU as _TAU
        from ..blocks.modulation import _BoundFmDemod, _BoundFmMod

        def fn(blk, p):
            if isinstance(blk, _BoundFmMod):
                return _np.float32(deviation / blk.in_sig.sample_rate * _TAU)
            if isinstance(blk, _BoundFmDemod):
                return _np.float32(blk.in_sig.sample_rate / deviation / _TAU)
            return None

        self._apply_typed(fn, slot="set_deviation")

    # -- checkpoint / resume of the live stream state -----------------------

    def save_checkpoint(self, path: str) -> None:
        """Serialize the live stream state (filter tails, demod previous
        sample, oscillator phase, ...) to ``path``.  Call from the event
        loop between sends (the same contract as the typed setters).  The
        file uses the backend-agnostic wire format of
        :mod:`radiorust_tpu.utils.checkpoint`."""
        from ..utils.checkpoint import save_state
        self._sync_state()
        # A state loaded via load_checkpoint but not yet bound (no chunk
        # processed since) is still a complete, serializable stream state.
        state = self._state if self._state is not None \
            else self._restored_state
        if state is None:
            raise RuntimeError("no stream state yet: the block has not "
                               "processed a chunk")
        save_state(path, state)

    def load_checkpoint(self, path: str) -> None:
        """Resume from a state saved by :meth:`save_checkpoint` (possibly in
        another process).  The next chunk continues the stream bit-exactly,
        provided it has the same (batch, chunk_len, sample_rate) signature
        the state was saved under."""
        from ..utils.checkpoint import load_state
        state = load_state(path)
        self._pstate = None
        self._pending_reset = False
        if self._bound is not None:
            self._state = state
            if getattr(self._bound, "ragged_output", False):
                # Restored phase lands mid-schedule; re-derive the mirror.
                self._sched_phase = self._bound.schedule_phase(state)
        else:
            self._restored_state = state

    # -- output hooks (RuntimeGraph overrides these for multi-output) ------

    async def _emit_event(self, msg) -> None:
        await self.sender.send(msg)

    async def _send_warmup(self, bound, inflight) -> None:
        """Zero-primed history: warn consumers the next valid_from outputs
        are not reference-comparable.  Flush first so the event lands
        before those outputs' peers."""
        if bound.valid_from > 0:
            await self._flush(inflight)
            await self.sender.send(Warmup(bound.valid_from))

    def _close_outputs(self) -> None:
        self.sender.close()

    async def _fetch_send(self, entry) -> None:
        """Fetch one in-flight device result and emit it downstream.

        With ``pipeline_depth > 0`` the recorded wall time is
        dispatch-to-fetch latency (it includes device queue wait);
        throughput numbers remain correct, per-chunk times read higher.
        """
        from ..blocks.base import unpack_wire
        py, bound, n_in, batched, t0, valid = entry
        y = np.asarray(unpack_wire(jax.tree.map(np.asarray, py)))
        self.chunks_processed += 1
        # The np.asarray fetch above synchronizes the device, so the
        # recorded wall time covers the real compute.
        self.stats.record_chunk(n_in, time.perf_counter() - t0)
        if valid is not None:
            # Phase-mode (arbitrary-ratio) resampler tail: the compiled
            # step pads each chunk to a static length; the actor trims to
            # the schedule's valid prefix so downstream consumers see a
            # gapless stream (the reference's variable-count accumulator
            # behavior, src/blocks/resampling.rs:103-133).
            if valid == 0:
                return
            y = y[:, :valid]
        # 1-D input stays 1-D downstream — unless the chain grows the
        # batch (a Channelizer folds channels into it): then the output is
        # genuinely 2-D [channels, t] and y[0] would strip all but one.
        flatten = not batched and bound.out_sig.batch == 1
        await self.sender.send(Samples(bound.out_sig.sample_rate,
                                       y[0] if flatten else y))

    async def _flush(self, inflight) -> None:
        while inflight:
            await self._fetch_send(inflight.popleft())

    async def _run(self, receiver: Receiver):
        from collections import deque
        inflight = deque()
        recv_task = None
        try:
            while True:
                # Under sustained load the next message is already waiting
                # and the pipeline holds `depth` chunks; when input goes
                # idle, drain in-flight work instead of withholding it
                # (capacity-1 channel semantics: peers never starve).
                recv_task = asyncio.ensure_future(receiver.recv())
                while inflight:
                    await asyncio.sleep(0)  # let a ready recv complete
                    done, _ = await asyncio.wait({recv_task}, timeout=0)
                    if done:
                        break
                    await self._fetch_send(inflight.popleft())
                msg = await recv_task
                recv_task = None
                if isinstance(msg, Event):
                    # Events flush pending device work first: ordering
                    # between samples and events is part of the contract.
                    await self._flush(inflight)
                    if msg.is_interrupt:
                        self._pending_reset = True
                    self.stats.record_event()
                    self.event_handlers.invoke(msg)
                    await self._emit_event(msg)
                    continue
                chunk = np.asarray(msg.chunk)
                t0 = time.perf_counter()
                # 2-D [streams, n] chunks batch independent streams through
                # one device program — the device serving axis (the
                # reference is one stream per block task; batching is the
                # deliberate widening that amortizes per-dispatch cost).
                batched = chunk.ndim == 2
                x = chunk if batched else chunk[None, :]
                bound = self._get_bound(x.shape[1], msg.sample_rate,
                                        x.shape[0])
                fresh = bound is not self._bound
                restored = False
                if fresh:
                    self._bound = bound
                    # Re-apply EVERY live retune (one slot per tunable),
                    # not just the most recent setter.
                    for override in self._param_overrides.values():
                        bound.params = override(bound, bound.params)
                    if (self._restored_state is not None
                            and not self._pending_reset):
                        # Resuming a checkpoint: the state is real stream
                        # history, so the stream continues (no zero-primed
                        # warmup, no reset).
                        self._state = self._restored_state
                        self._restored_state = None
                        restored = True
                    else:
                        # An interrupt between load_checkpoint and the
                        # first chunk declares the stream discontinuous:
                        # the restored history is stale, start fresh.
                        self._restored_state = None
                        self._state = bound.init_state()
                    # Ragged (phase-mode resampler) tails: mirror the
                    # schedule phase host-side so each emitted chunk can
                    # be trimmed to its valid prefix.  Derived from the
                    # (host numpy) state, so a checkpoint restore lands
                    # mid-schedule correctly.
                    self._sched_phase = (
                        bound.schedule_phase(self._state)
                        if getattr(bound, "ragged_output", False) else None)
                    self._pstate = None
                    self._pending_reset = False
                reset = np.full((x.shape[0],), self._pending_reset)
                if (fresh or self._pending_reset) and not restored:
                    await self._send_warmup(bound, inflight)
                self._pending_reset = False
                from ..blocks.base import pack_wire
                if self._pstate is None:
                    self._pstate = pack_wire(self._state)
                if (self._pparams is None
                        or self._pparams_src is not bound.params):
                    # Params are constant between retunes (every setter
                    # REASSIGNS bound.params, so identity tracks
                    # validity).  Cache them as DEVICE-resident arrays:
                    # re-packing + re-uploading a few hundred kB of
                    # responses per chunk would dominate the per-chunk
                    # host cost.  Mesh serving keeps host numpy (the
                    # sharded jit handles placement).
                    pp = pack_wire(bound.params)
                    if self.mesh is None:
                        pp = jax.device_put(pp)
                    self._pparams = pp
                    self._pparams_src = bound.params
                self._pstate, py = bound._jit(
                    self._pparams, self._pstate,
                    pack_wire(x), reset)
                valid = None
                if self._sched_phase is not None:
                    valid, self._sched_phase = bound.advance_schedule(
                        self._sched_phase)
                inflight.append((py, bound, x.size, batched, t0, valid))
                while len(inflight) > self.pipeline_depth:
                    await self._fetch_send(inflight.popleft())
        except ChannelClosed:
            # Input closed: drain whatever is still in flight downstream.
            try:
                await self._flush(inflight)
            except ChannelClosed:
                pass
            except Exception as exc:  # device error during the drain
                self._record_failure(exc)
            return
        except Exception as exc:
            self._record_failure(exc)
            return
        finally:
            if recv_task is not None:
                recv_task.cancel()
                try:
                    await recv_task
                except (asyncio.CancelledError, ChannelClosed):
                    pass
            # Task exit drops the task-owned endpoints (reference: the task
            # owns Receiver/Sender, src/blocks/mod.rs:213-230), so teardown
            # cascades down the chain instead of leaving peers parked.
            receiver.close()
            self._close_outputs()


class _OutputHandle:
    """Producer facade for one named output of a :class:`RuntimeGraph`,
    so ``consumer.feed_from(rg.out("audio"))`` works like any producer."""

    def __init__(self, sender_connector: SenderConnector):
        self.sender_connector = sender_connector

    def feed_into(self, consumer) -> None:
        consumer.receiver_connector.connect(self.sender_connector)


class RuntimeGraph(RuntimeBlock):
    """Streaming actor around a compiled DAG with one input and N named
    outputs.

    The reference gets fan-out by broadcasting one producer's chunks to N
    consumer chains in lock-step (``src/flow.rs:44-52``), each chain
    recomputing from the shared stream.  This actor instead runs a
    :class:`radiorust_tpu.blocks.graph.Graph` — the whole DAG, shared
    prefix included, as ONE device program per chunk — and publishes each
    named output on its own capacity-1 sender.  Events (and interrupt
    resets) are forwarded to every output, preserving the in-band ordering
    contract per stream.

    Delivery semantics per output: outputs with a connected consumer run
    in lock-step with backpressure (the reference's broadcast contract);
    an output *without* a consumer drops its chunks instead of stalling
    the others (a late subscriber simply starts at the live stream
    position, matching the live-rewiring model).  If NO output has a
    consumer, the actor parks — the single-output backpressure behavior.

    Everything else (rebind on shape/rate change, interrupt resets,
    per-output Warmup, 1-D/2-D batched-serving chunks, ``pipeline_depth``
    in-flight dispatch, typed setters like ``set_gain``/``set_shift``
    applied per node) is inherited from :class:`RuntimeBlock`.
    """

    def __init__(self, graph_spec, name: Optional[str] = None,
                 pipeline_depth: int = 0, mesh=None,
                 mesh_axis: Optional[str] = None, shard: str = "streams",
                 overlap: int = 1):
        from ..utils.profiling import GLOBAL_STATS
        if len(graph_spec._inputs) != 1:
            raise ValueError("RuntimeGraph wraps single-input graphs; "
                             "multi-input graphs are a compiled-path "
                             "feature (bind + graph_scan)")
        self.spec = graph_spec
        self.name = name or "RuntimeGraph"
        self.stats = GLOBAL_STATS.unique(self.name)
        self.pipeline_depth = pipeline_depth
        # Graphs serve on the stream axis (default) or time-sharded
        # (shard="time": one stream, whole mesh, D*chunk_len group
        # chunks — the DAG analog of RuntimeBlock's time mode).
        if shard not in ("streams", "time"):
            raise ValueError(f"RuntimeGraph shard must be 'streams' or "
                             f"'time', got {shard!r}")
        if shard == "time" and mesh is None:
            raise ValueError("shard='time' requires a mesh")
        self.shard = shard
        self.mesh = mesh
        self.overlap = overlap
        self.mesh_axis = _resolve_mesh_axis(mesh, mesh_axis)
        self._init_actor_fields()
        receiver, self.receiver_connector = new_receiver()
        self.senders: Dict[str, Sender] = {}
        self._connectors: Dict[str, SenderConnector] = {}
        for out_name in graph_spec._outputs:
            s, sc = new_sender()
            self.senders[out_name] = s
            self._connectors[out_name] = sc
        self._bindings: Dict[Tuple[int, int, float], Any] = {}
        self._task = _spawn(self._run(receiver))

    def out(self, name: str) -> _OutputHandle:
        """Producer handle for output ``name`` (connect consumers to it)."""
        return _OutputHandle(self._connectors[name])

    @property
    def sender_connector(self):
        raise AttributeError(
            "RuntimeGraph has named outputs; connect consumers via "
            "sink.feed_from(rg.out(name))")

    def _get_bound(self, chunk_len: int, sample_rate: float,
                   batch: int = 1):
        key = (batch, chunk_len, sample_rate)
        bound = self._bindings.get(key)
        if bound is None:
            from ..blocks.base import pack_wire, unpack_wire
            if self.mesh is not None and self.shard == "time":
                tsg = self._bind_time_sharded(chunk_len, sample_rate,
                                              batch)
                if tsg is not None:
                    self._bindings[key] = tsg
                    return tsg
                # else: logged fallback to the single-device program.
            bg = self.spec.bind(StreamSig(batch, chunk_len, sample_rate))
            in_name = next(iter(bg.in_sigs))

            process = bg.process
            if (self.mesh is not None and self.shard == "streams"
                    and bg.shard_batch_ok(
                        self.mesh.shape[self.mesh_axis])):
                # Data-parallel serving over the mesh: stream-batch dim of
                # state/inputs/resets shards across mesh_axis, params
                # replicate.  shard_map_step's specs are pytree prefixes,
                # so the graph's dict-valued chunks/resets shard the same
                # way as the chain path (blocks.base.jit_step_sharded).
                from ..blocks.base import shard_map_step
                process = shard_map_step(bg.process, self.mesh,
                                         self.mesh_axis)

            @jax.jit
            def step(pp, ps, px, reset):
                state, ys = process(
                    unpack_wire(pp), unpack_wire(ps),
                    {in_name: unpack_wire(px)}, {in_name: reset})
                return pack_wire(state), {k: pack_wire(v)
                                          for k, v in ys.items()}

            bg._jit = step
            self._bindings[key] = bg
        return self._bindings[key]

    def _bind_time_sharded(self, chunk_len: int, sample_rate: float,
                           batch: int):
        """shard="time" binding: the DAG runs time-sharded over the mesh
        (one group chunk of D per-device chunks per step).  Returns None
        (with a logged warning) when the chunk length does not divide or
        a node cannot time-shard — the caller falls back."""
        import jax.numpy as jnp

        from ..blocks.base import StreamSig, pack_wire, unpack_wire
        from ..parallel.time_shard import TimeShardedGraph
        d = self.mesh.shape[self.mesh_axis]
        try:
            if chunk_len % d:
                raise ValueError(f"chunk {chunk_len} not divisible by "
                                 f"the time axis ({d} devices)")
            inner = self.spec.bind(
                StreamSig(batch, chunk_len // d, sample_rate))
            tsg = TimeShardedGraph(inner, self.mesh,
                                   t_axis=self.mesh_axis,
                                   overlap=self.overlap)
        except (ValueError, NotImplementedError) as e:
            logging.getLogger(__name__).warning(
                "%s: cannot time-shard (%s); using the single-device "
                "program", self.name, e)
            return None
        in_name = next(iter(tsg.in_sigs))
        # The actor consumes/produces GROUP chunks.
        tsg.in_sigs, tsg.out_sigs = tsg.group_sigs()
        init_packed = pack_wire(tsg.init_state())

        @jax.jit
        def step(pp, ps, px, reset):
            params = unpack_wire(pp)
            state = unpack_wire(ps)
            x = unpack_wire(px)
            # All-or-nothing reset, rebuilt from packed planes (the wire
            # format at every jit boundary).
            init = unpack_wire(jax.tree.map(jnp.asarray, init_packed))
            any_r = jnp.any(reset)
            state = jax.tree.map(
                lambda s, i: jnp.where(any_r, jnp.asarray(i, s.dtype), s),
                state, init)
            new_state, ys = tsg.process(params, state, {in_name: x})
            return pack_wire(new_state), {k: pack_wire(v)
                                          for k, v in ys.items()}

        tsg._jit = step
        try:
            # Same construction-time trace forcing as the chain path:
            # trace-time capability rejections must hit the fallback.
            _trace_check(step, tsg.params, tsg.init_state(),
                         tsg.in_sigs[in_name])
        except (ValueError, NotImplementedError) as e:
            logging.getLogger(__name__).warning(
                "%s: cannot time-shard (%s); using the single-device "
                "program", self.name, e)
            return None
        return tsg

    # -- multi-output hooks -------------------------------------------------

    async def _broadcast(self, make_msg) -> None:
        """Send to every output that has a consumer; drop for outputs that
        don't; park (backpressure) while no output has any consumer."""
        while all(s._channel.receivers == 0 for s in self.senders.values()):
            await asyncio.sleep(0.01)
        for name, s in self.senders.items():
            if s._channel.receivers == 0:
                continue
            await s.send(make_msg(name))

    async def _emit_event(self, msg) -> None:
        await self._broadcast(lambda name: msg)

    async def _send_warmup(self, bound, inflight) -> None:
        if any(vf > 0 for vf in bound.valid_from.values()):
            await self._flush(inflight)
            for name, s in self.senders.items():
                vf = bound.valid_from[name]
                if vf > 0 and s._channel.receivers > 0:
                    await s.send(Warmup(vf))

    def _close_outputs(self) -> None:
        for s in self.senders.values():
            s.close()

    async def _fetch_send(self, entry) -> None:
        from ..blocks.base import unpack_wire
        # ``valid`` is always None for graphs: ragged (phase-mode
        # resampler) outputs are rejected at graph construction.
        pys, bound, n_in, batched, t0, valid = entry
        ys = {k: np.asarray(unpack_wire(jax.tree.map(np.asarray, v)))
              for k, v in pys.items()}
        self.chunks_processed += 1
        self.stats.record_chunk(n_in, time.perf_counter() - t0)
        await self._broadcast(
            lambda name: Samples(
                bound.out_sigs[name].sample_rate,
                ys[name][0] if (not batched
                                and bound.out_sigs[name].batch == 1)
                else ys[name]))


class Silence(_ProducerMixin):
    """Producer of zero chunks with tunable size and rate
    (``src/blocks/io/mod.rs:22-87``)."""

    def __init__(self, chunk_size: int, sample_rate: float):
        self.chunk_size = chunk_size
        self.sample_rate = sample_rate
        self.sender, self.sender_connector = new_sender()
        self._task = _spawn(self._run())

    def set_chunk_size(self, n: int):
        self.chunk_size = n

    def set_sample_rate(self, r: float):
        self.sample_rate = r

    async def _run(self):
        try:
            while True:
                chunk = np.zeros(self.chunk_size, np.complex64)
                await self.sender.send(Samples(self.sample_rate, chunk))
        except ChannelClosed:
            return
        finally:
            self.sender.close()


class Blackhole(_ConsumerMixin, EventHandling):
    """Sink that discards samples but observes events
    (``src/blocks/io/mod.rs:91-131``)."""

    def __init__(self):
        receiver, self.receiver_connector = new_receiver()
        self.event_handlers = EventHandlers()
        self.samples_seen = 0
        self._task = _spawn(self._run(receiver))

    async def _run(self, receiver):
        try:
            while True:
                msg = await receiver.recv()
                if isinstance(msg, Event):
                    self.event_handlers.invoke(msg)
                else:
                    # Per-stream time length (axis -1): correct for both
                    # 1-D chunks and batched [streams, n] serving chunks.
                    self.samples_seen += np.shape(msg.chunk)[-1]
        except ChannelClosed:
            return
        finally:
            receiver.close()


class _TemporalQueue:
    """Duration/age-tracked queue (``src/blocks/buffering.rs:33-112``)."""

    def __init__(self, clock=time.monotonic):
        self._q: List[Tuple[float, Any]] = []
        self._clock = clock
        self.duration = 0.0
        self.event_count = 0

    def push(self, msg):
        self._q.append((self._clock(), msg))
        if isinstance(msg, Event):
            self.event_count += 1
        else:
            self.duration += msg.duration

    def pop(self):
        if not self._q:
            return None
        _, msg = self._q.pop(0)
        if isinstance(msg, Event):
            self.event_count -= 1
        else:
            # Running total (the reference recomputes by summing the whole
            # queue each op, buffering.rs:54-59 — O(1) here, same value up
            # to float accumulation; reset to exact zero when drained).
            self.duration -= msg.duration
        if not self._q:
            self.duration = 0.0
        return msg

    def age(self) -> float:
        return self._clock() - self._q[0][0] if self._q else 0.0

    def __len__(self):
        return len(self._q)

    def leading_event(self) -> bool:
        return bool(self._q) and isinstance(self._q[0][1], Event)


QUEUE_MAX_EVENTS = 256


class Buffer(_ProducerMixin, _ConsumerMixin, EventHandling):
    """Elastic/lossy buffer (``src/blocks/buffering.rs:132-267``).

    Fills to ``initial_capacity`` seconds before draining, refills to
    ``min_capacity`` after underrun, suspends receiving above
    ``max_capacity``, and discards entries older than ``max_age`` (emitting
    one :class:`BufferOverflow` interrupt per gap).
    """

    def __init__(self, initial_capacity: float, min_capacity: float,
                 max_capacity: float, max_age: float,
                 clock=time.monotonic):
        self.initial = initial_capacity
        self.min_capacity = min_capacity
        self.max_capacity = max_capacity
        self.max_age = max_age
        self.event_handlers = EventHandlers()
        receiver, self.receiver_connector = new_receiver()
        self.sender, self.sender_connector = new_sender()
        self._queue = _TemporalQueue(clock)
        self._task = _spawn(self._run(receiver))

    async def _run(self, receiver):
        queue = self._queue
        initial = True
        underrun = True
        shutdown = False
        marked_missing = False
        fill_task = None  # persistent: cancelling a recv could lose a chunk
        drain_task = None
        try:
            while True:
                if shutdown and not len(queue):
                    return
                can_fill = (not shutdown
                            and queue.duration <= self.max_capacity
                            and queue.event_count < QUEUE_MAX_EVENTS)
                if can_fill and fill_task is None:
                    fill_task = asyncio.ensure_future(receiver.recv())
                want_drain = (not underrun) or shutdown
                drain_task = (asyncio.ensure_future(self.sender.reserve())
                              if want_drain else None)
                tasks = [t for t in (fill_task, drain_task) if t]
                if not tasks:
                    fill_task = asyncio.ensure_future(receiver.recv())
                    tasks = [fill_task]
                done, _ = await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED)
                # Only the reserve task is safe to cancel (reserving has no
                # side effects); the fill task persists across iterations.
                if drain_task is not None and drain_task not in done:
                    drain_task.cancel()
                    try:
                        await drain_task
                    except (asyncio.CancelledError, ChannelClosed):
                        pass
                    drain_task = None
                if fill_task is not None and fill_task in done:
                    # A drain (reserve) task that completed in the same
                    # wakeup must still have its result retrieved, else
                    # asyncio warns "Task exception was never retrieved"
                    # when the channel closed; the unused reservation is
                    # cancelled so it releases its claim on the slot.
                    if drain_task is not None and drain_task in done:
                        try:
                            drain_task.result().cancel()
                        except ChannelClosed:
                            pass
                        drain_task = None
                    try:
                        msg = fill_task.result()
                    except ChannelClosed:
                        shutdown = True
                        fill_task = None
                        continue
                    fill_task = None
                    if isinstance(msg, Event):
                        # Handlers observe events when the block receives
                        # them (impl_block_trait! EventHandling semantics).
                        self.event_handlers.invoke(msg)
                    queue.push(msg)
                    if initial:
                        if queue.duration >= self.initial:
                            underrun = False
                            initial = False
                    elif queue.duration >= self.min_capacity:
                        underrun = False
                    marked_missing = self._try_drain(marked_missing)
                elif drain_task is not None and drain_task in done:
                    try:
                        res = drain_task.result()
                    except ChannelClosed:
                        return
                    # Use the claimed reservation directly: it holds the
                    # slot, so a second try_reserve would see it as busy.
                    marked_missing, underrun = self._drain_one(
                        marked_missing, res)
        except ChannelClosed:
            return
        except Exception as exc:
            self._record_failure(exc)
            return
        finally:
            for t in (fill_task, drain_task):
                if t is not None:
                    t.cancel()
            receiver.close()
            self.sender.close()

    def _drop_stale(self, keep_last: bool) -> bool:
        # Only a LEADING event vetoes the drop; aged events further back
        # are discarded with the samples around them, exactly like the
        # reference's pop loop (buffering.rs:206-247).
        queue = self._queue
        dropped = False
        if queue.leading_event():
            return False
        limit = 1 if keep_last else 0
        while len(queue) > limit and queue.age() > self.max_age:
            queue.pop()
            dropped = True
        return dropped

    def _try_drain(self, marked_missing):
        try:
            res = self.sender.try_reserve()
        except ChannelClosed:
            return marked_missing
        if res is None:
            return marked_missing
        if len(self._queue) > 1 and self._drop_stale(keep_last=True):
            if not marked_missing:
                res.send(BufferOverflow())
                return True
        msg = self._queue.pop()
        if msg is not None:
            res.send(msg)
            return False
        res.cancel()
        return marked_missing

    def _drain_one(self, marked_missing, res=None):
        if res is None:
            try:
                res = self.sender.try_reserve()
            except ChannelClosed:
                return marked_missing, True
            if res is None:
                return marked_missing, False
        if self._drop_stale(keep_last=False):
            if not marked_missing:
                res.send(BufferOverflow())
                return True, False
        msg = self._queue.pop()
        if msg is None:
            res.cancel()
            return marked_missing, True
        res.send(msg)
        return False, False


class Rechunker(_ProducerMixin, _ConsumerMixin, EventHandling):
    """Regroup arbitrary chunk lengths into a fixed length
    (``src/blocks/chunks.rs:42-177``).

    Zero-copy where the reference is: full output chunks are split off the
    incoming chunk with ``separate_beginning`` (views into the same
    storage, ``chunks.rs:119-127``); only boundary-straddling remainders go
    through a pooled patchwork buffer (``chunks.rs:100-117``), whose
    storage recycles once the consumer releases it."""

    def __init__(self, output_chunk_len: int):
        assert output_chunk_len > 0
        self.output_chunk_len = output_chunk_len
        # Patchwork pools are created per stream dtype on first use so
        # boundary-straddling remainders keep the stream's dtype (a f64 or
        # real stream must not come out complex64 on some chunks only).
        self._pools: Dict[np.dtype, ChunkBufPool] = {}
        self.event_handlers = EventHandlers()
        receiver, self.receiver_connector = new_receiver()
        self.sender, self.sender_connector = new_sender()
        self._task = _spawn(self._run(receiver))

    def _pool(self, dtype) -> ChunkBufPool:
        dtype = np.dtype(dtype)
        pool = self._pools.get(dtype)
        if pool is None:
            pool = self._pools[dtype] = ChunkBufPool(dtype)
        return pool

    @property
    def pool(self) -> ChunkBufPool:
        """The stream-dtype pool (complex64 unless the stream differs)."""
        if len(self._pools) == 1:
            return next(iter(self._pools.values()))
        return self._pool(np.complex64)

    def set_output_chunk_len(self, n: int):
        assert n > 0
        self.output_chunk_len = n

    async def _run(self, receiver):
        patchwork: Optional[Tuple[float, ChunkBuf]] = None
        try:
            while True:
                msg = await receiver.recv()
                if isinstance(msg, Event):
                    self.event_handlers.invoke(msg)
                    if patchwork is not None and len(patchwork[1]):
                        await self.sender.send(SamplesLost())
                        patchwork = None
                    await self.sender.send(msg)
                    continue
                rate = msg.sample_rate
                if np.ndim(getattr(msg.chunk, "data", msg.chunk)) != 1:
                    # Batched [streams, n] serving chunks have no single
                    # time axis to regroup zero-copy; rechunk each stream
                    # before batching (or use blocks/chunks.py::rechunk on
                    # the bulk array).  Fail loudly over silently slicing
                    # the stream axis.
                    raise TypeError(
                        "Rechunker requires 1-D chunks; got batched "
                        f"shape {np.shape(np.asarray(msg.chunk))}")
                chunk = (msg.chunk if isinstance(msg.chunk, Chunk)
                         else Chunk.from_array(np.asarray(msg.chunk)))
                if patchwork is not None and patchwork[0] != rate \
                        and len(patchwork[1]):
                    await self.sender.send(SamplesLost())
                    patchwork = None
                n = self.output_chunk_len
                # A live set_output_chunk_len shrink can strand a patchwork
                # larger than the new length; signal the loss in-band.  A
                # patchwork of exactly n is a complete chunk — the top-up
                # branch below emits it (take=0), no loss.
                if patchwork is not None and len(patchwork[1]) > n:
                    await self.sender.send(SamplesLost())
                    patchwork = None
                # Top up an in-progress patchwork first.
                if patchwork is not None and len(patchwork[1]):
                    buf = patchwork[1]
                    take = min(n - len(buf), len(chunk))
                    buf.extend(chunk.separate_beginning(take).data)
                    chunk = chunk.discard_beginning(take)
                    if len(buf) == n:
                        await self.sender.send(Samples(rate, buf.finalize()))
                        patchwork = None
                # Full output chunks split off zero-copy.
                while len(chunk) >= n:
                    head = chunk.separate_beginning(n)
                    chunk = chunk.discard_beginning(n)
                    await self.sender.send(Samples(rate, head))
                if len(chunk):
                    if patchwork is None:
                        patchwork = (rate, self._pool(chunk.dtype)
                                     .get_with_capacity(n))
                    patchwork[1].extend(chunk.data)
        except ChannelClosed:
            return
        except Exception as exc:
            self._record_failure(exc)
            return
        finally:
            receiver.close()
            self.sender.close()


class KeyerSource(_ProducerMixin):
    """Streaming morse keyer producer wrapping
    :class:`radiorust_tpu.blocks.morse.Keyer`
    (``src/blocks/morse.rs:282-420``)."""

    def __init__(self, chunk_len: int, sample_rate: float, speed,
                 message: Optional[str] = None):
        from ..blocks.morse import Keyer
        self._keyer = Keyer(chunk_len, sample_rate, speed, message)
        self.sender, self.sender_connector = new_sender()
        self._task = _spawn(self._run())

    def send(self, text: str):
        self._keyer.send(text)

    def set_speed(self, speed):
        self._keyer.set_speed(speed)

    async def _run(self):
        try:
            while True:
                for chunk, events in self._keyer.chunks(1):
                    for e in events:
                        await self.sender.send(e)
                    await self.sender.send(
                        Samples(self._keyer.sample_rate, chunk))
        except ChannelClosed:
            return
        finally:
            self.sender.close()


class ArraySource(_ProducerMixin):
    """Feed a prerecorded IQ array as chunks (test/file source)."""

    def __init__(self, data, chunk_len: int, sample_rate: float,
                 repeat: bool = False):
        self.data = np.asarray(data, np.complex64)
        self.chunk_len = chunk_len
        self.sample_rate = sample_rate
        self.repeat = repeat
        self.sender, self.sender_connector = new_sender()
        self._task = _spawn(self._run())

    async def _run(self):
        try:
            carry = np.zeros(0, np.complex64)  # tail straddling a wrap
            while True:
                # Chunks are zero-copy views split off one backing array
                # (the reference's separate_beginning pattern,
                # src/bufferpool.rs:70-79); only wrap-straddling chunks
                # copy (stitched from tail + next cycle's head).
                whole = Chunk.from_array(self.data)
                while len(carry) and len(whole):
                    need = self.chunk_len - len(carry)
                    take = min(need, len(whole))
                    carry = np.concatenate(
                        [carry, np.asarray(whole.separate_beginning(take))])
                    whole = whole.discard_beginning(take)
                    if len(carry) == self.chunk_len:
                        await self.sender.send(
                            Samples(self.sample_rate, carry))
                        carry = np.zeros(0, np.complex64)
                while len(whole) >= self.chunk_len:
                    head = whole.separate_beginning(self.chunk_len)
                    whole = whole.discard_beginning(self.chunk_len)
                    await self.sender.send(Samples(self.sample_rate, head))
                if self.repeat:
                    # Never drop the tail: it leads the next cycle, so the
                    # repeated stream is gap-free (a silent splice would
                    # corrupt e.g. FM demod at every wrap).
                    if len(whole):
                        carry = (np.concatenate([carry, np.asarray(whole)])
                                 if len(carry) else
                                 np.asarray(whole).copy())
                    continue
                if len(whole):
                    # Final partial chunk: emit short rather than discard.
                    await self.sender.send(Samples(self.sample_rate, whole))
                return
        except ChannelClosed:
            return
        finally:
            self.sender.close()


class ArraySink(_ConsumerMixin, EventHandling):
    """Collect received samples into a list of chunks."""

    def __init__(self):
        receiver, self.receiver_connector = new_receiver()
        self.event_handlers = EventHandlers()
        self.chunks: List[np.ndarray] = []
        self.events: List[Event] = []
        self.sample_rate: Optional[float] = None
        self._task = _spawn(self._run(receiver))

    @property
    def samples(self) -> np.ndarray:
        # axis=-1: time axis for both 1-D chunks and batched [streams, n].
        return (np.concatenate(self.chunks, axis=-1) if self.chunks
                else np.zeros(0, np.complex64))

    async def _run(self, receiver):
        try:
            while True:
                msg = await receiver.recv()
                if isinstance(msg, Event):
                    self.events.append(msg)
                    self.event_handlers.invoke(msg)
                else:
                    self.sample_rate = msg.sample_rate
                    self.chunks.append(np.asarray(msg.chunk))
        except ChannelClosed:
            return
        finally:
            receiver.close()


class FileSink(_ConsumerMixin, EventHandling):
    """Stream received complex64 samples to a raw IQ file."""

    def __init__(self, path: str):
        receiver, self.receiver_connector = new_receiver()
        self.event_handlers = EventHandlers()
        self._file = open(path, "wb")
        self._task = _spawn(self._run(receiver))

    async def _run(self, receiver):
        try:
            while True:
                msg = await receiver.recv()
                if isinstance(msg, Event):
                    self.event_handlers.invoke(msg)
                else:
                    np.asarray(msg.chunk, np.complex64).tofile(self._file)
        except ChannelClosed:
            return
        finally:
            self._file.close()
            receiver.close()


class MapSignal(_ProducerMixin, _ConsumerMixin, EventHandling):
    """Applies a host closure to every message (samples *and* events)
    before forwarding — the reference's ``MapSignal``
    (``src/blocks/transform.rs:202-263``).  The closure is hot-swappable
    via :meth:`set_closure`.  Events are also observable via ``on_event``
    (the reference's ``NopSignal`` template, src/blocks/mod.rs:193-239)."""

    def __init__(self, closure=None):
        self._closure = closure if closure is not None else (lambda m: m)
        self.event_handlers = EventHandlers()
        receiver, self.receiver_connector = new_receiver()
        self.sender, self.sender_connector = new_sender()
        self._task = _spawn(self._run(receiver))

    def set_closure(self, closure):
        self._closure = closure

    async def _run(self, receiver):
        try:
            while True:
                msg = await receiver.recv()
                if isinstance(msg, Event):
                    self.event_handlers.invoke(msg)
                await self.sender.send(self._closure(msg))
        except ChannelClosed:
            return
        except Exception as exc:  # user closure raised
            self._record_failure(exc)
            return
        finally:
            receiver.close()
            self.sender.close()
