"""Time-sharded chain execution with collective-permute halo exchange.

The reference streams chunks sequentially through per-block tasks; all
cross-chunk coupling lives in small per-block state (filter tail, resampler
ring, demod previous sample, oscillator phase — SURVEY.md §5).  That state
has a crucial property: for every block in the wideband receive path it is
either

1. a pure function of the block's *previous input chunk* (filter tail =
   previous chunk, ``src/blocks/filters.rs:240-260``; resampler history =
   tail of the input ring, ``src/blocks/resampling.rs:103-121``; demod prev
   = last input sample, ``src/blocks/modulation.rs:118-125``), or
2. advanced by a *closed form* per chunk (FreqShifter's integer phase index
   advances by a constant; FmMod's phase by the chunk's increment sum).

Therefore D consecutive chunks can be processed **in parallel on D
devices**: device d fetches device d-1's input chunk tail
(``jax.lax.ppermute`` — a collective permute riding the interconnect) and
reconstructs its predecessor state locally; device 0 uses the carry from
the previous step.  Sequential dependencies collapse into one ppermute per
stateful block plus an all-gather of scalar phase increments — the SDR
analog of sequence parallelism with halo exchange.

Blocks implement ``process_sharded(params, state, x, axis)`` (running
inside ``shard_map``); :class:`TimeShardedChain` assembles the mesh
program.  ``Overlapper`` uses the generic multi-hop halo (its state is
exactly a (k-1)-chunk halo).  ``Squelch``'s one-pole envelope is affine in
its carry and shards via an exclusive prefix of per-device affine maps;
``AgcControl``'s gain update is *clamped*-affine — still closed under
composition — and shards the same way with a 4-component map element.
``SlewRateLimiter`` is inherently sequential per sample (the complex clamp
has no O(1) composition) and is rejected; it remains channel-shardable.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..blocks import analysis as _analysis
from ..blocks import channelize as _channelize
from ..blocks import chunks as _chunks
from ..blocks import filters as _filters
from ..blocks import graph as _graph
from ..blocks import modulation as _modulation
from ..blocks import resampling as _resampling
from ..blocks import transform as _transform
from ..blocks.base import BoundBlock
from ..numbers import TAU

__all__ = ["TimeShardedChain", "TimeShardedGraph"]


def _ring_left(x, axis):
    """Each device receives the value held by its left neighbor (cyclic)."""
    n = jax.lax.axis_size(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    return jax.lax.ppermute(x, axis, perm)


def _is_first(axis):
    return jax.lax.axis_index(axis) == 0


def _halo_tail(x, carry, hist, axis):
    """The ``hist`` samples immediately preceding this device's chunk.

    For device d handling chunk d of the group, that is the tail of
    ``carry || x_0 || ... || x_{d-1}``.  Neighbor chunks arrive over the
    interconnect via cyclic collective permutes (multi-hop when ``hist``
    spans several chunks); positions before the group start come from the
    replicated ``carry`` (the previous step's tail).
    """
    n = x.shape[-1]
    if hist == 0:
        return x[:, :0]
    k = -(-hist // n)  # chunks of halo needed
    if k == 1:
        # Ship only the needed tail, not the whole chunk (a
        # 1-sample demod halo must not move a 512 kB chunk per step).
        prev_tail = _ring_left(x[:, -hist:], axis)
    else:
        parts = []
        cur = x
        for _ in range(k):
            cur = _ring_left(cur, axis)
            parts.append(cur)
        # parts[j-1] = x_{d-j}; assemble [x_{d-k} .. x_{d-1}], take its tail.
        prev_big = jnp.concatenate(parts[::-1], axis=-1)
        prev_tail = prev_big[:, -hist:]
    d = jax.lax.axis_index(axis)
    i = jnp.arange(hist)
    from_neighbors = i >= (hist - d * n)
    carry_idx = jnp.clip(d * n + i, 0, carry.shape[-1] - 1)
    return jnp.where(from_neighbors[None, :], prev_tail,
                     carry[:, carry_idx])


# -- per-block sharded processing -------------------------------------------
#
# Where a block's cross-chunk state is a pure function of its previous
# input (SURVEY.md §5), the sharded handler only *reconstructs that state
# from the left neighbor's halo* and then DELEGATES to the block's own
# ``process`` — inheriting its kernel choice, pair-packed realness,
# and numeric-mode config instead of duplicating the math (and diverging
# from it).  Only blocks whose state advances in closed form (FreqShifter,
# FmMod) or whose fused kernels carry intermediate-domain state keep
# hand-written sharded math.


def _no_reset(x):
    return jnp.zeros((x.shape[0],), bool)


def _sharded_stateless(block, params, state, x, axis):
    _, y = block.process(params, (), x, _no_reset(x))
    return (), y


def _sharded_combine(block, params, state, xs, axis):
    # Stateless elementwise fan-in: every input chunk is already this
    # device's time shard, so the combine is purely local.
    x0 = xs[0] if isinstance(xs, tuple) else xs
    _, y = block.process(params, (), xs, _no_reset(x0))
    return (), y


def _sharded_filter(block, params, state, x, axis):
    """Overlap-save filter: state = previous m input samples (m = the IR
    length — the full previous chunk in the reference's coupled geometry,
    src/blocks/filters.rs:240-260), rebuilt from the neighbor's tail.
    Decoupled geometry shrinks the halo to m < chunk_len bytes."""
    prev = _halo_tail(x, state["prev"], state["prev"].shape[-1], axis)
    return block.process(params, {"prev": prev}, x, _no_reset(x))


def _sharded_filter_bank(block, params, state, x, axis):
    # Same halo as Filter (the bands share one previous-input state).
    prev = _halo_tail(x, state["prev"], state["prev"].shape[-1], axis)
    return block.process(params, {"prev": prev}, x, _no_reset(x))


def _sharded_select(block, params, state, xs, axis):
    # Pure projection of a bank output tuple; no cross-chunk state.
    return (), xs[block.index]


def _sharded_resampler(block, params, state, x, axis):
    if getattr(block, "phase_mode", False):
        # Arbitrary-chunk (phase-mode) resampler: the grid phase advances
        # by C mod p per chunk, data-independently, so device d computes
        # its own phase in closed form (like the FreqShifter's k0); the
        # take-last carry then holds the group-advanced phase.  Each
        # device's output chunk keeps its own valid-prefix padding —
        # identical layout to sequential stepping.
        p = block.plan.p
        C = x.shape[-1]
        hist = _halo_tail(x, state["hist"], block.plan.phase_hist, axis)
        d = jax.lax.axis_index(axis).astype(jnp.int32)
        phase = (state["phase"] + d * jnp.int32(C % p)) % jnp.int32(p)
        return block.process(params, {"hist": hist, "phase": phase}, x,
                             _no_reset(x))
    hist = _halo_tail(x, state["hist"], block.plan.hist, axis)
    return block.process(params, {"hist": hist}, x, _no_reset(x))


def _sharded_fm_demod(block, params, state, x, axis):
    prev = _halo_tail(x, state["prev"][:, None], 1, axis)[:, 0]
    have = jnp.where(_is_first(axis), state["have_prev"], True)
    return block.process(
        params, {"prev": prev, "have_prev": have,
                 "last_out": state["last_out"]}, x, _no_reset(x))


def _sharded_freq_shifter(block, params, state, x, axis):
    d = jax.lax.axis_index(axis)
    denom = block.denom
    # Closed-form per-device phase-index offset: d chunks ahead of carry.
    k0 = (state["k0"] + d * params["adv"]) % denom
    theta0 = (state["start_phase"]
              + k0.astype(jnp.float32) * np.float32(TAU / denom))
    p0 = jax.lax.complex(jnp.cos(theta0), jnp.sin(theta0))
    ta = params["table_a"]
    tb = params["table_b"]
    outer, inner = ta.shape[-1], tb.shape[-1]
    xb = x.reshape(x.shape[0], outer, inner)
    y = (xb * p0[:, None, None] * ta[None, :, None]
         * tb[None, None, :]).reshape(x.shape)
    return {"k0": (k0 + params["adv"]) % denom,
            "start_phase": state["start_phase"]}, y


def _sharded_fm_mod(block, params, state, x, axis):
    # Per-device phase offset = sum of all earlier devices' increment sums:
    # an exclusive prefix over the mesh axis (scalars per stream only).
    increments = x.real.astype(jnp.float32) * params
    my_sum = jnp.sum(increments, axis=-1)                       # [batch]
    all_sums = jax.lax.all_gather(my_sum, axis)                 # [D, batch]
    d = jax.lax.axis_index(axis)
    mask = (jnp.arange(all_sums.shape[0]) < d)[:, None]
    prefix = jnp.sum(jnp.where(mask, all_sums, 0.0), axis=0)    # [batch]
    theta = (state["phase"] + prefix)[:, None] + jnp.cumsum(increments, axis=-1)
    theta = jnp.mod(theta, np.float32(TAU))
    y = jax.lax.complex(jnp.cos(theta), jnp.sin(theta))
    return {"phase": theta[:, -1]}, y


def _sharded_squelch(block, params, state, x, axis):
    """Squelch under time sharding.  The one-pole envelope is affine in
    its carry (e -> alpha^n e + B_d), so unlike the slew limiter's
    sequential complex clamp it shards exactly: each device computes its local offset
    B_d = (1-alpha) sum_k alpha^(n-1-k) |x_k|^2 (a weighted reduction,
    no scan), one ``all_gather`` of scalars-per-stream shares them, and
    the exclusive prefix of the affine maps seeds this device's incoming
    envelope; the block's own ``process`` then runs unchanged.

    f32 caveat: the weighted reduction sums in a different order than the
    sequential associative_scan, so an envelope landing within ~1 ulp of
    the hard threshold can gate the opposite way under sharding — the
    output then differs by that sample's full magnitude, not an epsilon.
    Exact in real arithmetic; tests pin envelopes away from the
    threshold.  (Same ordering caveat applies to ``_sharded_agc``'s map
    composition at its clip bounds.)"""
    alpha = params["alpha"]
    n = x.shape[-1]
    p = jnp.real(x * jnp.conj(x))
    powers = alpha ** jnp.arange(n - 1, -1, -1).astype(jnp.float32)
    b_loc = (1.0 - alpha) * jnp.sum(p * powers[None, :], axis=-1)  # [batch]
    all_b = jax.lax.all_gather(b_loc, axis)                        # [D, b]
    d = jax.lax.axis_index(axis)
    k = jnp.arange(all_b.shape[0])
    a_n = alpha ** np.float32(n)
    w = jnp.where(k < d, a_n ** jnp.clip(d - 1 - k, 0, None), 0.0)
    e_in = (a_n ** d) * state["env"] + jnp.sum(w[:, None] * all_b, axis=0)
    return block.process(params, {"env": e_in}, x, _no_reset(x))


def _sharded_agc(block, params, state, x, axis):
    """AgcControl under time sharding.  Each per-sample gain update is a
    clamped-affine map (``blocks/transform.py:_agc_elems``) and the family
    is closed under composition, so each device reduces its whole chunk to
    ONE composed map ``(a, b, lo, hi)``, an ``all_gather`` shares the D
    maps, a log-depth scan over the (tiny) device axis forms the exclusive
    prefix composition, and applying it to the carried gain seeds this
    device's incoming state; the block's own ``process`` then runs
    unchanged.  Exact in real arithmetic (the sequential scan composes the
    identical maps in a different association order — f32 rounding can
    differ by ulps, same caveat as Squelch)."""
    from ..blocks.transform import _agc_compose, _agc_elems
    elems = _agc_elems(params, x)
    inc = jax.lax.associative_scan(_agc_compose, elems, axis=-1)
    local = tuple(t[:, -1] for t in inc)                     # [batch] x4
    gathered = tuple(jax.lax.all_gather(t, axis) for t in local)
    pre = jax.lax.associative_scan(_agc_compose, gathered, axis=0)
    d = jax.lax.axis_index(axis)
    a, b, lo, hi = (t[jnp.maximum(d - 1, 0)] for t in pre)
    # Device 0 takes the identity map (no predecessor).
    first = d == 0
    a = jnp.where(first, jnp.ones_like(a), a)
    b = jnp.where(first, jnp.zeros_like(b), b)
    lo = jnp.where(first, jnp.full_like(lo, -np.inf), lo)
    hi = jnp.where(first, jnp.full_like(hi, np.inf), hi)
    g_in = jnp.clip(a * state["gain"] + b, lo, hi)
    return block.process(params, {"gain": g_in}, x, _no_reset(x))


def _sharded_overlapper(block, params, state, x, axis):
    """Overlapper under time sharding: the analysis window's history is a
    (k-1)-chunk halo, fetched with the generic multi-hop ppermute chain
    (``_halo_tail`` hops ceil(hist/n) neighbors)."""
    k = block.chunk_count
    b, n = x.shape
    if k == 1:
        return block.process(params, state, x, _no_reset(x))
    hist = (k - 1) * n
    h = _halo_tail(x, state["hist"].reshape(b, hist), hist, axis)
    return block.process(params, {"hist": h.reshape(b, k - 1, n)}, x,
                         _no_reset(x))


def _sharded_channelizer(block, params, state, x, axis):
    hist = _halo_tail(x, state["hist"], block.hist_len, axis)
    return block.process(params, {"hist": hist}, x, _no_reset(x))


_HANDLERS = {
    _channelize._BoundChannelizer: _sharded_channelizer,
    _chunks._BoundOverlapper: _sharded_overlapper,
    _filters._BoundFilter: _sharded_filter,
    _filters._BoundFilterBank: _sharded_filter_bank,
    _graph._BoundSelect: _sharded_select,
    _resampling._BoundResampler: _sharded_resampler,
    _modulation._BoundFmDemod: _sharded_fm_demod,
    _modulation._BoundFmMod: _sharded_fm_mod,
    _transform._BoundFreqShifter: _sharded_freq_shifter,
    _transform._BoundGain: _sharded_stateless,
    _transform._BoundSquelch: _sharded_squelch,
    _transform._BoundAgc: _sharded_agc,
    _transform._BoundMap: _sharded_stateless,
    _transform._BoundCombine: _sharded_combine,
    _analysis._BoundFourier: _sharded_stateless,
}


def _handler_for(block: BoundBlock):
    h = _HANDLERS.get(type(block))
    if h is None:
        raise NotImplementedError(
            f"{type(block).__name__} does not support time sharding "
            "(sequential per-sample state); use channel sharding")
    return h


def _retune_shift(nodes, params, state, shift: float):
    """Shared live-retune walk for the sharded executors: phase-continuous
    ``set_shift`` against every FreqShifter node
    (``src/blocks/transform.rs:384-390`` + ``:322-339``).

    Correctness under time sharding: the carried ``k0`` between groups is
    the *group-start* index for the next step (``take_last`` keeps the last
    device's advanced index), i.e. it has the same meaning as the
    sequential carry — so ``fold_phase_state`` applies unchanged, and the
    per-device offsets ``k0 + d*adv`` inside ``_sharded_freq_shifter``
    restart from the folded ``start_phase``
    with the new ``adv``.  State leaves may live sharded on the mesh; the
    fold pulls them to host numpy (retunes happen between steps, the same
    contract as the runtime actors' typed setters).
    """
    from ..blocks.transform import _BoundFreqShifter
    params = list(params)
    state = list(state)
    hit = False
    for i, blk in enumerate(nodes):
        if blk is not None and isinstance(blk, _BoundFreqShifter):
            host = jax.tree.map(np.asarray, state[i])
            params[i], state[i] = blk.retune(params[i], host, shift)
            hit = True
    if not hit:
        raise ValueError("no FreqShifter to retune")
    return tuple(params), tuple(state)


def _map_node_params(nodes, params, fn):
    """Params-only typed setters (gain, deviation, squelch, ...):
    ``fn(block, params) -> new params or None`` over every node."""
    out = []
    for blk, pp in zip(nodes, params):
        new = None if blk is None else fn(blk, pp)
        out.append(pp if new is None else new)
    return tuple(out)


class TimeShardedChain:
    """Executes a bound chain over ``t_devices * chunk_len`` samples per
    step, time-sharded across the mesh's ``t_axis`` (and channel-sharded
    across ``ch_axis`` when given).

    ``process(params, state, x_big)`` consumes ``[batch, D*chunk_len]``
    and returns the next carry and ``[batch, D*out_chunk_len]``; it is
    numerically identical to scanning the chain over the D chunks
    sequentially, up to f32 reduction-order ulps in the prefix handlers
    — which for the *thresholding* blocks (Squelch's gate, AGC's clip
    bounds) can flip a decision that lands within ~1 ulp of the
    threshold (see ``_sharded_squelch``).

    A chain is the linear special case of a DAG, so this is a thin
    wrapper over :class:`TimeShardedGraph` (one sharded implementation).
    """

    def __init__(self, bound_chain, mesh: Mesh, t_axis: str = "t",
                 ch_axis: Optional[str] = None, overlap: int = 1):
        from ..blocks.graph import linear_bound_graph
        self.bound = bound_chain
        self.mesh = mesh
        self.t_axis = t_axis
        self.ch_axis = ch_axis
        self.t_devices = mesh.shape[t_axis]
        self.in_sig = bound_chain.in_sig
        self.out_sig = bound_chain.out_sig
        self._graph = TimeShardedGraph(linear_bound_graph(bound_chain),
                                       mesh, t_axis=t_axis, ch_axis=ch_axis,
                                       overlap=overlap)

    def init_state(self):
        return self.bound.init_state()

    @property
    def params(self):
        return self.bound.params

    @params.setter
    def params(self, value):
        self.bound.params = value

    @property
    def blocks(self):
        """The wrapped chain's bound blocks (typed-setter surface —
        ``RuntimeBlock._map_blocks`` walks these)."""
        return self.bound.blocks

    @property
    def valid_from(self):
        """Zero-primed warmup length in output samples — the group's
        warmup equals the chain's (history priming happens once, at the
        head of the stream, regardless of how chunks split over
        devices)."""
        return self.bound.valid_from

    def group_sigs(self):
        """The group-level (D-chunk) stream signatures this executor
        consumes/produces per step."""
        from ..blocks.base import StreamSig
        d = self.t_devices
        i, o = self.in_sig, self.out_sig
        return (StreamSig(i.batch, d * i.chunk_len, i.sample_rate),
                StreamSig(o.batch, d * o.chunk_len, o.sample_rate))

    def jit_step(self):
        """Wire-safe group step for live serving (``RuntimeBlock(...,
        shard="time")``): same calling convention as
        ``blocks.base.jit_step`` over the GROUP signature.  ``reset`` is
        all-or-nothing — any True reinitializes every stream's carry
        before the group (the actor's pending-reset flag is per-actor;
        the sharded handlers carry no per-stream reset plumbing)."""
        from ..blocks.base import pack_wire, unpack_wire
        # Initial state enters as wire-format f32 planes and is rebuilt
        # inside the program (the wire format at every jit boundary).
        init_packed = pack_wire(self.init_state())

        @jax.jit
        def step(pp, ps, px, reset):
            params = unpack_wire(pp)
            state = unpack_wire(ps)
            x = unpack_wire(px)
            init = unpack_wire(jax.tree.map(jnp.asarray, init_packed))
            any_r = jnp.any(reset)
            state = jax.tree.map(
                lambda s, i: jnp.where(any_r, jnp.asarray(i, s.dtype), s),
                state, init)
            new_state, y = self.process(params, state, x)
            return pack_wire(new_state), pack_wire(y)

        return step

    def process(self, params, state, x_big):
        # The adapter's node 0 (the graph input) carries () params/state.
        new_state, ys = self._graph.process(
            ((), *params), ((), *state), {"in": x_big})
        return tuple(new_state[1:]), ys["out"]

    # -- live retune between groups (the typed-setter surface) --------------

    def set_shift(self, state, shift: float):
        """Phase-continuous mid-stream retune of every FreqShifter
        (``src/blocks/transform.rs:384-390``): updates
        ``self.params`` in place and returns the rewritten carry.  Call
        between ``process`` steps."""
        new_params, new_state = _retune_shift(
            self.bound.blocks, self.bound.params, state, shift)
        self.bound.params = new_params
        return new_state

    def update_params(self, fn) -> None:
        """Params-only live retune: ``fn(block, params) -> params or
        None`` over the chain's blocks (gain, deviation, squelch, AGC —
        anything that does not rewrite carried state)."""
        self.bound.params = _map_node_params(self.bound.blocks,
                                             self.bound.params, fn)


class TimeShardedGraph:
    """Time sharding over a compiled DAG (:class:`~radiorust_tpu.blocks.
    graph.BoundGraph`): the same per-block halo handlers as
    :class:`TimeShardedChain`, applied in topological order with fan-out
    values reused — D consecutive group-chunks of every graph input are
    processed on D devices per step.

    ``process(params, state, xs_big)`` consumes ``{input: [batch,
    D*chunk_len]}`` and returns ``(state', {output: [batch,
    D*out_chunk_len]})``, numerically identical to ``graph_scan`` over the
    D chunks sequentially.
    """

    def __init__(self, bound_graph, mesh: Mesh, t_axis: str = "t",
                 ch_axis: Optional[str] = None, overlap: int = 1):
        self.bound = bound_graph
        self.mesh = mesh
        self.t_axis = t_axis
        self.ch_axis = ch_axis
        self.t_devices = mesh.shape[t_axis]
        self.overlap = overlap
        self.in_sigs = bound_graph.in_sigs
        self.out_sigs = bound_graph.out_sigs
        handlers = [None if b is None else _handler_for(b)
                    for b in bound_graph.bound]

        bg = bound_graph
        taxis = t_axis

        t_dev = self.t_devices

        def run_nodes(params, state, xs):
            vals = [None] * len(bg.bound)
            new_pieces = []
            for i, b in enumerate(bg.bound):
                if b is None:
                    vals[i] = xs[bg._origin[i]]
                    new_pieces.append(())
                    continue
                up = bg._upstream[i]
                xin = (tuple(vals[u] for u in up)
                       if isinstance(up, tuple) else vals[up])
                piece, y = handlers[i](b, params[i], state[i], xin, taxis)
                vals[i] = y
                new_pieces.append(piece)
            ys = {n: vals[j] for n, j in bg._outputs.items()}
            # Carry extraction, inline (one program, one dispatch per
            # step): the next step's state is the LAST time shard's
            # piece, and every device needs it.  Masking all other
            # devices' pieces to zero and psum-ing broadcasts it in ~1x
            # the state size — bit-exact, the sum has one nonzero term.
            # (An earlier two-program form all-gathered every leaf: 8x
            # the halo traffic, plus a second dispatch.)  Running it
            # inside the compiled SPMD program also keeps multi-process
            # meshes legal (no eager ops on process-spanning arrays).
            keep = jax.lax.axis_index(taxis) == t_dev - 1

            def sel(a):
                z = jnp.where(keep, a, jnp.zeros_like(a))
                if z.dtype == jnp.bool_:
                    return jax.lax.psum(z.astype(jnp.int32),
                                        taxis).astype(jnp.bool_)
                return jax.lax.psum(z, taxis)

            carry = jax.tree.map(sel, tuple(new_pieces))
            return carry, ys

        def local_step(params, state, xs):
            # Halo/compute overlap (SURVEY §7): with
            # ``overlap=S`` the local batch splits into S independent
            # sub-groups, each running the full node walk.  In one chain
            # every halo ppermute is on the critical path (permute_i
            # needs y_{i-1}, compute_i needs permute_i) — nothing can
            # hide interconnect time.  S independent sub-group walks give the
            # latency-hiding scheduler compute to place between a
            # permute-start and its -done: sub-group j's permutes ride the
            # interconnect while sub-groups j±1 run their filters, so the
            # non-overlapped halo cost drops from H to ~H/S (docs/
            # SCALING.md table).  Per-stream rows never couple, so the
            # split is bit-exact vs overlap=1 at pair-preserving
            # sub-batches; when a sub-batch isolates ONE stream of a
            # real-filtered pair, that filter drops its pair-packed FFT
            # and the difference is f32-ulp-level (tests compare with
            # atol accordingly).  State leaves are batch-major by
            # framework convention (blocks' init_state).
            if overlap <= 1:
                return run_nodes(params, state, xs)
            b = next(iter(xs.values())).shape[0]
            if b % overlap:
                raise ValueError(
                    f"local batch {b} not divisible by overlap={overlap}")
            bs = b // overlap

            def cut(j):
                def f(leaf):
                    if leaf.shape[0] != b:
                        raise ValueError(
                            "state leaf not batch-major: "
                            f"shape {leaf.shape}, batch {b}")
                    return leaf[j * bs:(j + 1) * bs]
                return f

            carries, yss = [], []
            for j in range(overlap):
                sj = jax.tree.map(cut(j), state)
                xj = {k: v[j * bs:(j + 1) * bs] for k, v in xs.items()}
                cj, yj = run_nodes(params, sj, xj)
                carries.append(cj)
                yss.append(yj)
            carry = jax.tree.map(lambda *ls: jnp.concatenate(ls, axis=0),
                                 *carries)
            ys = {n: jnp.concatenate([y[n] for y in yss], axis=0)
                  for n in yss[0]}
            return carry, ys

        x_spec = P(ch_axis, t_axis) if ch_axis else P(None, t_axis)
        state_in_spec = P(ch_axis) if ch_axis else P()
        xs_specs = {n: x_spec for n in bg.in_sigs}
        ys_specs = {n: x_spec for n in bg.out_sigs}

        self._sharded = jax.jit(jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(P(), state_in_spec, xs_specs),
            out_specs=(state_in_spec, ys_specs),
            check_vma=False,
        ))

    def init_state(self):
        return self.bound.init_state()

    @property
    def params(self):
        return self.bound.params

    @params.setter
    def params(self, value):
        self.bound.params = value

    @property
    def blocks(self):
        """Aligned node list (``None`` for graph inputs) — the typed
        setters' walk surface (``RuntimeBlock._map_blocks`` /
        ``set_shift``), aligned with the params/state tuples."""
        return self.bound.bound

    @property
    def valid_from(self):
        """Per-output zero-primed warmup lengths (output samples;
        mesh-independent — history priming happens once at the head of
        the stream regardless of how chunks split over devices)."""
        return self.bound.valid_from

    def group_sigs(self):
        """Group-level (D-chunk) input/output signature dicts."""
        from ..blocks.base import StreamSig
        d = self.t_devices

        def grp(sigs):
            return {k: StreamSig(s.batch, d * s.chunk_len, s.sample_rate)
                    for k, s in sigs.items()}

        return grp(self.bound.in_sigs), grp(self.bound.out_sigs)

    def set_shift(self, state, shift: float):
        """Phase-continuous mid-stream retune over the DAG's nodes (see
        :meth:`TimeShardedChain.set_shift`); input nodes pass through."""
        new_params, new_state = _retune_shift(
            self.bound.bound, self.bound.params, state, shift)
        self.bound.params = new_params
        return new_state

    def update_params(self, fn) -> None:
        """Params-only live retune over the DAG's nodes."""
        self.bound.params = _map_node_params(self.bound.bound,
                                             self.bound.params, fn)

    def process(self, params, state, xs_big):
        return self._sharded(params, state, xs_big)
