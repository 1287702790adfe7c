"""Channel (expert) parallelism for channelizer chains.

The polyphase filterbank turns one wideband stream into ``M`` narrowband
channels that ride the batch axis (``blocks/channelize.py``).  Past a
single chip's capacity the natural split is the *channel* axis: each
device owns ``M / D`` channels and their entire downstream per-channel
processing (demod, gain, filters) — the expert-parallelism analog, with
channels as experts.  The reference's version of this workload is M
independent per-channel chains (``examples/bandwidth_meter/main.rs:54-57``
built M times), which a cluster would split the same way.

Device mapping (one ``shard_map`` over the whole chain, zero input
redistribution):

1. The wideband input chunk replicates (it is one stream — every device
   needs its strided polyphase subset, and a replicated broadcast is how
   it arrives from the host anyway).
2. Each device runs the branch FIR for its *branch group* (``M / D`` of
   the M polyphase branches) — the FIR work splits D ways.
3. One ``all_gather`` over the channel axis assembles the decimated
   branch values ``v[b, T, M]`` (this is the only collective; it moves
   the post-decimation data, 1/D of the input per device).
4. Each device contracts the DFT columns of its *channel group* only —
   the DFT work splits D ways — and feeds its ``[b * M/D, t]`` folded
   channels through the downstream blocks locally (pure data parallelism:
   channels never couple downstream).

Downstream per-channel state (demod previous sample, filter tails) lives
sharded on the channel axis; the channelizer's raw-input history is
replicated.  Composes with the serving batch axis (streams) the same way
``jit_step_sharded`` does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..blocks.channelize import _BoundChannelizer
from ..ops.channelizer import _dft_planes, branch_fir, dft_channels

__all__ = ["ChannelShardedChain"]


def _local_channelize(chan, params, hist, x, reset, axis: str, ndev: int):
    """Device-local PFB step: branch-group FIR -> all_gather -> local DFT
    channel columns.  Numerically identical to
    ``ops.channelizer.pfb_channelize`` (same contraction order per branch
    and per channel; only the *grouping* over devices differs).

    Returns (new_hist [b, hist_len] replicated, y_local [b * M/D, t]).
    """
    m, k = chan.m, chan.k
    mg = m // ndev                       # branch-group / channel-group size
    d_idx = jax.lax.axis_index(axis)
    hist = jnp.where(reset[:, None], jnp.zeros_like(hist), hist)
    xp = jnp.concatenate([hist, x], axis=-1)           # replicated
    b = xp.shape[0]
    total = xp.shape[-1]
    t_out = total // m - (k - 1)
    frames = xp.reshape(b, total // m, m)
    # Branch group: polyphase branches [d*mg, (d+1)*mg) of this device.
    fr = jax.lax.dynamic_slice_in_dim(
        jnp.real(frames).astype(jnp.float32), d_idx * mg, mg, axis=2)
    fi = jax.lax.dynamic_slice_in_dim(
        jnp.imag(frames).astype(jnp.float32), d_idx * mg, mg, axis=2)
    taps = jax.lax.dynamic_slice_in_dim(
        params["taps"].astype(jnp.float32), d_idx * mg, mg, axis=1)
    vr, vi = branch_fir(fr, fi, taps, t_out)
    # The only collective: assemble all branches (decimated data, 1/D of
    # the input per device).  Device order == branch-group order, so the
    # gather axis folds straight back into the branch axis.
    vr_all = jnp.moveaxis(jax.lax.all_gather(vr, axis), 0, 2)
    vi_all = jnp.moveaxis(jax.lax.all_gather(vi, axis), 0, 2)
    vr_full = vr_all.reshape(b, t_out, m)
    vi_full = vi_all.reshape(b, t_out, m)
    # DFT columns of this device's channel group only.
    dr, di = _dft_planes(m)
    dr = jax.lax.dynamic_slice_in_dim(jnp.asarray(dr), d_idx * mg, mg, 1)
    di = jax.lax.dynamic_slice_in_dim(jnp.asarray(di), d_idx * mg, mg, 1)
    y = dft_channels(vr_full, vi_full, dr, di)         # [b, T, mg]
    y = jnp.swapaxes(y, 1, 2).reshape(b * mg, t_out).astype(jnp.complex64)
    new_hist = xp[:, -chan.hist_len:] if chan.hist_len else hist
    return new_hist, y


class ChannelShardedChain:
    """Executes a bound channelizer chain with the M channels (and all
    their downstream processing) split across the mesh's channel axis.

    The chain's first block must be a :class:`Channelizer` binding; every
    later block must preserve the folded ``batch * M`` axis (per-channel
    blocks — demod, gain, filters — all do).  ``process(params, state, x,
    reset=None)`` has the bound chain's signature and is numerically
    identical to it (``tests/test_channel_shard.py``).

    ``stream_axis`` additionally shards the input-stream batch over a
    second mesh axis (the data-parallel serving split of
    ``jit_step_sharded``) for a 2-D streams x channels mesh: each device
    then owns one (stream group, channel group) tile, and the all_gather
    stays within its stream group's channel row.
    """

    def __init__(self, bound_chain, mesh: Mesh, axis: str = "c",
                 stream_axis: str | None = None):
        blocks = getattr(bound_chain, "blocks", None)
        if not blocks or not isinstance(blocks[0], _BoundChannelizer):
            raise ValueError("ChannelShardedChain requires a bound Chain "
                             "whose first block is a Channelizer")
        self.chan = blocks[0]
        self.rest = blocks[1:]
        self.ndev = mesh.shape[axis]
        if self.chan.m % self.ndev:
            raise ValueError(
                f"num_channels {self.chan.m} not divisible by mesh axis "
                f"{axis!r} ({self.ndev} devices)")
        self.stream_axis = stream_axis
        self.sdev = mesh.shape[stream_axis] if stream_axis else 1
        if bound_chain.in_sig.batch % self.sdev:
            raise ValueError(
                f"stream batch {bound_chain.in_sig.batch} not divisible "
                f"by mesh axis {stream_axis!r} ({self.sdev} devices)")
        folded = self.chan.out_sig.batch
        for blk in self.rest:
            if blk.in_sig.batch != folded or blk.out_sig.batch != folded:
                raise ValueError(
                    f"{type(blk).__name__} changes the folded channel "
                    f"batch; only batch-preserving per-channel blocks can "
                    f"channel-shard")
            if not blk.shard_batch_ok(self.ndev * self.sdev):
                raise ValueError(
                    f"{type(blk).__name__} cannot split {folded} channel "
                    f"rows over {self.ndev * self.sdev} devices "
                    f"(per-shard constraint)")
        self.bound = bound_chain
        self.mesh = mesh
        self.axis = axis
        self.in_sig = bound_chain.in_sig
        self.out_sig = bound_chain.out_sig
        # Runtime-actor surface (duck-types _BoundChain where it matters):
        # typed setters walk .blocks/params pairs, warmup reads valid_from.
        self.blocks = bound_chain.blocks
        self.valid_from = bound_chain.valid_from
        self._sharded = self._build()

    @property
    def params(self):
        return self.bound.params

    @params.setter
    def params(self, new):
        self.bound.params = new

    def init_state(self):
        """Chain-shaped state; downstream per-channel leaves are stored
        ``[batch, M, ...]`` (channel axis explicit) so they can shard."""
        b = self.in_sig.batch
        state = [self.chan.init_state()]
        for blk in self.rest:
            state.append(jax.tree.map(
                lambda a: np.reshape(a, (b, self.chan.m) + a.shape[1:]),
                blk.init_state()))
        return tuple(state)

    def state_from_chain(self, chain_state):
        """Convert a sequential chain checkpoint into this executor's
        layout (downstream per-channel leaves ``[batch*M, ...]`` ->
        ``[batch, M, ...]``): restore a single-device checkpoint onto a
        channel mesh (scale-up migration)."""
        b = self.in_sig.batch
        out = [chain_state[0]]
        for s in chain_state[1:]:
            out.append(jax.tree.map(
                lambda a: np.reshape(np.asarray(a),
                                     (b, self.chan.m) + a.shape[1:]), s))
        return tuple(out)

    def state_to_chain(self, state):
        """Inverse of :meth:`state_from_chain`: flatten the sharded state
        back to the sequential chain layout (scale-down migration /
        backend-agnostic checkpoints)."""
        out = [jax.tree.map(np.asarray, state[0])]
        for s in state[1:]:
            out.append(jax.tree.map(
                lambda a: np.reshape(np.asarray(a),
                                     (-1,) + a.shape[2:]), s))
        return tuple(out)

    def _build(self):
        mg = self.chan.m // self.ndev
        axis = self.axis
        s_ax = self.stream_axis

        def local(params, state, x, reset):
            bl = x.shape[0]                    # local stream batch
            new_hist, y = _local_channelize(
                self.chan, params[0], state[0]["hist"], x, reset,
                axis, self.ndev)
            # expand_reset would widen by the *global* factor M; the local
            # folded batch repeats each stream's flag mg times instead.
            r_loc = jnp.repeat(reset, mg) if self.rest else None
            new_state = [{"hist": new_hist}]
            for blk, p, s in zip(self.rest, params[1:], state[1:],
                                 strict=True):
                s_flat = jax.tree.map(
                    lambda a: a.reshape((bl * mg,) + a.shape[2:]), s)
                s_flat, y = blk.process(p, s_flat, y, r_loc)
                new_state.append(jax.tree.map(
                    lambda a: a.reshape((bl, mg) + a.shape[1:]), s_flat))
            t = y.shape[-1]
            return tuple(new_state), y.reshape(bl, mg, t)

        # Per-stream leaves shard over stream_axis when given; the
        # channelizer's raw-input history shards the same way (it is
        # per-stream), while staying replicated over the channel axis.
        hist_spec = P(s_ax) if s_ax else P()
        down_spec = P(s_ax, axis)
        state_specs = tuple([hist_spec] + [down_spec] * len(self.rest))
        self._smapped = jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(P(), state_specs, P(s_ax, None) if s_ax else P(),
                      P(s_ax) if s_ax else P()),
            out_specs=(state_specs, P(s_ax, axis, None)),
            check_vma=False)
        smapped = self._smapped
        m = self.chan.m

        # The folded-batch reshape happens inside the compiled program: on
        # a multi-process mesh an eager reshape of a process-spanning
        # array is not allowed (jax_spmd_mode='allow_jit').  On the 2-D
        # streams x channels mesh the reshape would merge TWO sharded
        # dims ([b@s, M@c, t] -> [b*M, t]) — unsupported by sharding
        # propagation in multi-controller jit (and ``out_sharding``
        # demands Explicit-mode mesh axes).  Gather the channel dim
        # within each stream row first (post-decimation data, 1/M of the
        # input — cheap), then merge sharded-b with replicated-M,
        # the supported case.
        fold = self._fold()

        def step(params, state, x, reset):
            new_state, y3 = smapped(params, state, x, reset)
            b, _, t = y3.shape
            return new_state, fold(y3).reshape(b * m, t)

        return jax.jit(step)

    def _fold(self):
        """Pre-fold regather for the 2-D mesh (see :meth:`_build`):
        identity on 1-D meshes; on streams x channels, gather the channel
        dim within each stream row.  ``jax.make_mesh`` defaults to
        Explicit axis types (sharding-in-types) while the ``Mesh`` ctor
        gives Auto — each needs its own regather API."""
        if not self.stream_axis:
            return lambda y3: y3
        from jax.sharding import AxisType, NamedSharding
        sh = NamedSharding(self.mesh, P(self.stream_axis, None, None))
        idx = self.mesh.axis_names.index(self.stream_axis)
        if self.mesh.axis_types[idx] == AxisType.Explicit:
            return lambda y3: jax.sharding.reshard(y3, sh)
        return lambda y3: jax.lax.with_sharding_constraint(y3, sh)

    def process(self, params, state, x, reset=None):
        if reset is None:
            reset = np.zeros((self.in_sig.batch,), dtype=bool)
        return self._sharded(params, state, x, reset)

    def jit_step(self):
        """Wire-safe chunk step (the channel-sharded analog of
        ``blocks.base.jit_step``): complex leaves cross the boundary as
        packed float32 planes, so runtime actors can drive the sharded
        program through backends that cannot marshal complex64."""
        from ..blocks.base import pack_wire, unpack_wire
        m = self.chan.m
        smapped = self._smapped
        fold = self._fold()

        @jax.jit
        def step(pp, ps, px, reset):
            new_state, y3 = smapped(unpack_wire(pp), unpack_wire(ps),
                                    unpack_wire(px), reset)
            b, _, t = y3.shape
            return pack_wire(new_state), pack_wire(fold(y3).reshape(b * m, t))

        return step
