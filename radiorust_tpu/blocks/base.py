"""Block protocol and chain composition.

The reference wires independent Tokio tasks with capacity-1 channels
(``src/blocks/mod.rs:23-34``, ``src/flow.rs``).  This build replaces that
dynamic actor graph with *declarative block specs*:

- A :class:`Block` is a lightweight spec (constructor args only).
- ``block.bind(sig)`` resolves it against a stream signature
  ``(batch, chunk_len, sample_rate)`` and performs all host-side design work
  (filter responses, resampler taps, phase tables) — the analog of the
  reference recomputing designs when sample rate / chunk length change
  (``src/blocks/filters.rs:179-239``).
- The resulting :class:`BoundBlock` carries ``params`` (a pytree of traced,
  retunable values — the analog of ``tokio::sync::watch`` tunables), an
  ``init_state()`` pytree (the cross-chunk streaming state: filter tails,
  demod previous sample, oscillator phase, resampler history), and a pure
  ``process(params, state, x, reset)`` function.
- :class:`Chain` composes blocks sequentially; a bound chain is itself a
  bound block whose ``process`` is the fused composition — ``jax.jit`` then
  compiles the whole chain into one XLA program, and ``scan`` runs it over a
  stacked batch of chunks with ``lax.scan`` carrying all state.

``reset`` is a per-stream bool ``[batch]`` implementing the reference's
interrupt-event semantics (stateful blocks drop continuity state on
``is_interrupt()`` events, e.g. ``src/blocks/filters.rs:262-268``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["StreamSig", "Block", "BoundBlock", "Chain", "scan", "jit_step",
           "jit_step_sharded", "shard_map_step"]


@dataclass(frozen=True)
class StreamSig:
    """Static signature of a chunked stream.

    ``batch`` independent streams (channels), each delivering chunks of
    ``chunk_len`` complex64 samples at ``sample_rate`` Hz.  The analog of the
    reference's per-message ``(sample_rate, chunk.len())`` pair
    (``src/signal.rs:170-183``), made static so XLA sees fixed shapes.
    """

    batch: int
    chunk_len: int
    sample_rate: float

    def with_(self, **kw) -> "StreamSig":
        return dataclasses.replace(self, **kw)


class Block:
    """Declarative spec for a signal-processing block."""

    def bind(self, sig: StreamSig) -> "BoundBlock":
        raise NotImplementedError


class BoundBlock:
    """A block resolved against a stream signature.

    Subclasses set ``in_sig`` / ``out_sig`` and ``params`` and implement
    ``init_state`` / ``process``.

    ``input_is_real`` / ``output_is_real`` track a *structural* property of
    the stream (samples known to have zero imaginary part, e.g. after FM
    demodulation).  ``Chain.bind`` propagates it: blocks that preserve
    realness (real-coefficient LTI ops, gain) advertise it so downstream
    blocks can use cheaper real-input formulations.  The data stays
    complex64 on the wire either way — this is an optimization hint, not a
    dtype change.
    """

    in_sig: StreamSig
    out_sig: StreamSig
    params: Any = ()
    input_is_real: bool = False
    #: Output step index from which outputs are reference-comparable.
    #: Blocks that pad zero history the reference would still be
    #: accumulating (Filter's overlap-save tail, Overlapper's window) set
    #: this > 0; consumers (and the runtime's Warmup event) use it to skip
    #: warmup outputs.
    valid_from: int = 0

    @property
    def output_is_real(self) -> bool:
        return False

    def init_state(self):
        return ()

    def process(self, params, state, x, reset):
        """Pure step: (params, state, x[batch, chunk_len], reset[batch])
        -> (state', y[batch, out_chunk_len])."""
        raise NotImplementedError

    def shard_batch_ok(self, ndev: int) -> bool:
        """True if this block's math is valid on a per-device stream batch
        of ``in_sig.batch // ndev`` (data-parallel stream sharding,
        :func:`jit_step_sharded`).  Blocks with per-shard constraints
        beyond divisibility override this; composites delegate to
        members."""
        return self.in_sig.batch % ndev == 0

    # -- convenience -------------------------------------------------------

    def __call__(self, x, *, state=None, reset=None, params=None):
        """Eager single-step helper (mainly for tests)."""
        if state is None:
            state = self.init_state()
        if params is None:
            params = self.params
        if reset is None:
            reset = np.zeros((self.in_sig.batch,), dtype=bool)
        return self.process(params, state, x, reset)


def expand_reset(block: "BoundBlock", r, in_batch: int):
    """Widen a per-stream reset mask for a batch-growing block (e.g. the
    channelizer folds channels into the batch axis, so each incoming
    stream's flag repeats per derived stream).  Shared by ``_BoundChain``
    and ``BoundGraph``.

    The growth factor is the *static* ratio of the block's bound batch to
    the batch of the signature the reset originated from (``in_batch``).
    It must not be inferred from ``r``'s runtime shape: under ``shard_map``
    (data-parallel serving, time sharding) the local arrays are a fraction
    of the bound batch, and a runtime-shape comparison would repeat the
    mask to the *global* size inside a shard."""
    factor = block.in_sig.batch // in_batch
    if factor > 1 and hasattr(r, "shape") and r.shape:
        return jnp.repeat(r, factor)
    return r


class _BoundChain(BoundBlock):
    _input_is_real = False

    def __init__(self, bound: Sequence[BoundBlock]):
        self.blocks = tuple(bound)
        self.in_sig = bound[0].in_sig
        self.out_sig = bound[-1].out_sig
        self.params = tuple(b.params for b in bound)
        # Warmup taint is CUMULATIVE through a chain: a block with
        # valid_from=v emits reference-comparable chunks only v steps
        # after its *input* became comparable, so cascaded zero-primed
        # histories add (e.g. two overlap-save Filters -> 2 tainted
        # chunks, the skip_out=2 used by test_models/test_parallel).
        self.valid_from = sum(b.valid_from for b in bound)
        # A phase-mode (schedule-padded) tail block makes the whole
        # chain's output ragged; propagate for outer compositions.
        self.ragged_output = getattr(bound[-1], "ragged_output", False)

    def valid_counts(self, k0: int, nsteps: int = 1):
        """Schedule of valid output samples per chunk (ragged tail block
        only; full chunks otherwise)."""
        last = self.blocks[-1]
        if hasattr(last, "valid_counts"):
            return last.valid_counts(k0, nsteps)
        import numpy as _np
        return _np.full((nsteps,), self.out_sig.chunk_len, _np.int64)

    # Host-side schedule mirror for ragged tails (see _BoundResampler).
    def schedule_phase(self, state) -> int:
        return self.blocks[-1].schedule_phase(state[-1])

    def advance_schedule(self, phase: int):
        return self.blocks[-1].advance_schedule(phase)

    def init_state(self):
        return tuple(b.init_state() for b in self.blocks)

    def process(self, params, state, x, reset):
        new_state = []
        for block, p, s in zip(self.blocks, params, state, strict=True):
            s, x = block.process(p, s, x,
                                 expand_reset(block, reset,
                                              self.in_sig.batch))
            new_state.append(s)
        return tuple(new_state), x

    def shard_batch_ok(self, ndev: int) -> bool:
        return (self.in_sig.batch % ndev == 0
                and all(b.shard_batch_ok(ndev) for b in self.blocks))

    # Realness propagates THROUGH a nested chain: when a parent (outer
    # Chain.bind / Graph binding) marks this chain's input real, the flag
    # must re-propagate into the members (they were bound with the
    # default False), and the chain must report its last member's
    # realness — otherwise the pair-packed real-filter and single-plane
    # resampler paths silently stop composing under nesting.
    @property
    def input_is_real(self) -> bool:
        return self._input_is_real

    @input_is_real.setter
    def input_is_real(self, value: bool) -> None:
        self._input_is_real = bool(value)
        is_real = bool(value)
        for b in self.blocks:
            b.input_is_real = is_real
            is_real = b.output_is_real

    @property
    def output_is_real(self) -> bool:
        return self.blocks[-1].output_is_real


class Chain(Block):
    """Sequential composition of blocks.

    The analog of ``feed_from`` wiring in the reference
    (``src/flow.rs:255-273``), but static: binding resolves each block's
    output signature into the next block's input signature, and the composed
    ``process`` is a single pure function XLA fuses end-to-end.
    """

    def __init__(self, *blocks: Block):
        # Flatten nested chains (e.g. Chain(Squelch(...), am_receiver()))
        # so composition stays a flat block list — per-block machinery
        # (typed setters, time-shard handlers, checkpoints) sees the
        # constituent blocks, not an opaque sub-chain.
        flat = []
        for b in blocks:
            if isinstance(b, Chain):
                flat.extend(b.specs)
            else:
                flat.append(b)
        self.specs = tuple(flat)

    def bind(self, sig: StreamSig) -> _BoundChain:
        bound = []
        is_real = False
        for i, spec in enumerate(self.specs):
            b = spec.bind(sig)
            if getattr(b, "ragged_output", False) and i < len(self.specs) - 1:
                # Phase-mode resamplers emit schedule-padded chunks that
                # downstream compiled blocks would misread as samples.
                raise ValueError(
                    f"{type(b).__name__} produces padded (schedule-valid) "
                    "chunks at this chunk length and must be the LAST "
                    "block of a compiled chain; re-chunk to a multiple "
                    "of the resampling period or consume it through the "
                    "runtime layer")
            b.input_is_real = is_real
            bound.append(b)
            sig = b.out_sig
            is_real = b.output_is_real
        return _BoundChain(bound)


# ---------------------------------------------------------------------------
# Wire format for the jit boundary
#
# The framework packs every complex leaf crossing a jit boundary (program
# arguments and results, checkpoints) into a float32 array with
# a leading [2] axis (contiguous re/im planes) and reconstructs it with
# ``lax.complex`` inside the program.  Packed leaves are marked with a
# single-key dict so pytrees stay self-describing; the split/join fuses away
# in XLA.  State fed back into the next step stays in packed device form, so
# steady-state streaming pays no conversion cost.
# ---------------------------------------------------------------------------

_WIRE_KEY = "__c64_wire__"


def _is_complex_leaf(x):
    if isinstance(x, complex):
        # Bare Python complex scalars (e.g. MapSample.with_params closure
        # params) ride the wire format too, so every complex value
        # crosses the jit boundary the same way.
        return True
    return hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.complexfloating)


def pack_wire(tree):
    """Pack complex leaves for boundary crossing (host or traced)."""
    def visit(t):
        if isinstance(t, dict):
            return {k: visit(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(visit(v) for v in t)
        if _is_complex_leaf(t):
            from ..numbers import stream_real
            rdt = stream_real()
            if isinstance(t, np.ndarray) or np.isscalar(t):
                arr = np.asarray(t)
                return {_WIRE_KEY: np.stack(
                    [arr.real.astype(rdt), arr.imag.astype(rdt)])}
            return {_WIRE_KEY: jnp.stack(
                [jnp.real(t).astype(rdt), jnp.imag(t).astype(rdt)])}
        return t
    return visit(tree)


def unpack_wire(tree):
    """Reconstruct complex leaves (use inside jit; also works on host)."""
    def visit(t):
        if isinstance(t, dict):
            if set(t.keys()) == {_WIRE_KEY}:
                v = t[_WIRE_KEY]
                if isinstance(v, np.ndarray):
                    from ..numbers import stream_complex
                    return (v[0] + 1j * v[1]).astype(stream_complex())
                return jax.lax.complex(v[0], v[1])
            return {k: visit(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(visit(v) for v in t)
        return t
    return visit(tree)


def jit_step(bound: BoundBlock) -> Callable:
    """Jit-compile one chunk step with a wire-safe boundary.

    Returns ``step(packed_params, packed_state, packed_x, reset) ->
    (packed_state, packed_y)``.  Use :func:`pack_wire` on inputs once and
    :func:`unpack_wire` on outputs when host values are needed; the carried
    state round-trips in packed form.
    """

    @jax.jit
    def step(params, state, x, reset):
        state, y = bound.process(unpack_wire(params), unpack_wire(state),
                                 unpack_wire(x), reset)
        return pack_wire(state), pack_wire(y)

    return step


def jit_step_sharded(bound: BoundBlock, mesh, axis: str) -> Callable:
    """Wire-safe chunk step, **data-parallel over a mesh axis**.

    The stream-batch dimension — independent streams, the serving axis —
    shards across the mesh's ``axis``: every per-stream leaf (state, input
    chunks, reset mask) splits over devices while stream-independent
    ``params`` (filter responses, phasor tables) replicate.  No
    collectives are needed: streams never couple (the reference's analog
    is N disjoint block graphs in one process).  Same calling convention
    as :func:`jit_step`.

    Requires ``bound.shard_batch_ok(mesh.shape[axis])``: the batch must
    split evenly over the axis *and* every member block's per-shard
    constraints must hold on the local batch.  Designed for serving
    fleets of streams on several GPUs; validated on the virtual CPU mesh
    in tests.
    """
    ndev = mesh.shape[axis]
    if not bound.shard_batch_ok(ndev):
        raise ValueError(
            f"batch {bound.in_sig.batch} cannot shard over mesh axis "
            f"{axis!r} ({ndev} devices): the local batch must divide "
            f"evenly and satisfy every block's per-shard constraint")

    def local(params, state, x, reset):
        return bound.process(params, state, x, reset)

    sharded = shard_map_step(local, mesh, axis)

    @jax.jit
    def step(params, state, x, reset):
        new_state, y = sharded(unpack_wire(params), unpack_wire(state),
                               unpack_wire(x), reset)
        return pack_wire(new_state), pack_wire(y)

    return step


def shard_map_step(fn, mesh, axis: str):
    """``shard_map`` wrapper with the data-parallel serving specs.

    ``fn(params, state, x, reset) -> (state', y)`` where arg 0 (params)
    replicates and args 1-3 (state / input chunks / reset masks) shard
    their leading stream axis over ``axis``.  The specs are pytree
    prefixes, so dict-valued chunk/reset arguments (``BoundGraph``) work
    unchanged.  Single place for the serving sharding recipe — shared by
    :func:`jit_step_sharded` and ``runtime.RuntimeGraph``."""
    from jax.sharding import PartitionSpec as P

    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(axis), P(axis, None), P(axis)),
        out_specs=(P(axis), P(axis, None)),
        check_vma=False)


def scan(bound: BoundBlock, params, state, xs, resets=None):
    """Run a bound block over stacked chunks with ``lax.scan``.

    ``xs``: [T, batch, chunk_len] complex64.  ``resets``: optional [T, batch]
    bool.  Returns (final_state, ys[T, batch, out_chunk_len]).  This is the
    compiled replacement for the reference's per-chunk recv/process/send task
    loop (``src/blocks/mod.rs:193-239``).
    """
    batch = bound.in_sig.batch
    if resets is None:
        resets = np.zeros((xs.shape[0], batch), dtype=bool)

    def body(state, inp):
        x, reset = inp
        state, y = bound.process(params, state, x, reset)
        return state, y

    return jax.lax.scan(body, state, (xs, resets))


def make_scan(bound: BoundBlock) -> Callable:
    """Build a wire-safe compiled bulk runner.

    Returns ``run(packed_params, packed_state, packed_xs, resets) ->
    (packed_state, packed_ys)`` scanning over the leading chunk axis, with
    complex leaves packed at the boundary (see :func:`pack_wire`) and native
    complex inside the program.
    """

    @jax.jit
    def run(params, state, xs, resets):
        params = unpack_wire(params)

        def body(st, inp):
            x, reset = inp
            st, y = bound.process(params, st, x, reset)
            return st, y

        state, ys = jax.lax.scan(body, unpack_wire(state),
                                 (unpack_wire(xs), resets))
        return pack_wire(state), pack_wire(ys)

    return run


def no_reset(batch: int):
    return np.zeros((batch,), dtype=bool)
