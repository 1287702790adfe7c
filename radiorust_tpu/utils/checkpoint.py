"""Checkpoint / resume of streaming state.

The reference has no checkpointing (SURVEY.md §5): its only persistent
state is per-block stream state (filter tails, demod previous sample,
resampler rings, oscillator phase).  In this build that state is an
explicit pytree, so checkpointing is a direct serialization of the
(params, state) trees — complex leaves are stored as float32 planes via
the same wire packer used at the jit boundary, keeping checkpoint files
backend-agnostic.

A saved checkpoint restores a pipeline mid-stream with bit-equal
continuation (see tests/test_checkpoint.py).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..blocks.base import pack_wire, unpack_wire

__all__ = ["save_state", "load_state", "save_sharded", "load_sharded"]

_SEP = "\x1f"


def _flatten(tree, prefix=""):
    # Empty containers must serialize explicitly: a stateless block mid-chain
    # contributes an empty () state, and dropping it would shift every
    # following block's state one slot left (silent misalignment on restore).
    # They get a marker leaf whose path segment "!<kind>" records the kind.
    if isinstance(tree, dict):
        if not tree:
            yield (f"{prefix}{_SEP}!d" if prefix else "!d"), np.zeros(0)
            return
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{_SEP}d{k}" if prefix else f"d{k}")
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        if not tree:
            yield (f"{prefix}{_SEP}!{tag}" if prefix else f"!{tag}"), np.zeros(0)
            return
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{_SEP}{tag}{i}" if prefix
                                else f"{tag}{i}")
    else:
        # A bare leaf at the ROOT needs a reserved name ("=") that
        # _rebuild recognizes — any alphabetic name would be parsed as a
        # container-kind prefix (a root np.float32 params leaf, e.g.
        # GainControl's, previously saved fine but crashed on load).
        yield prefix if prefix else "=", tree


_EMPTY = {"!d": {}, "!l": [], "!t": ()}


def _rebuild(node):
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if len(keys) == 1 and keys[0] == "=":
        return node["="]                     # bare root leaf
    if len(keys) == 1 and keys[0] in _EMPTY:
        return _EMPTY[keys[0]]
    kinds = {k[0] for k in keys}
    assert len(kinds) == 1, f"mixed container kinds: {keys}"
    kind = kinds.pop()
    if kind == "d":
        return {k[1:]: _rebuild(v) for k, v in node.items()}
    items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
    seq = [_rebuild(v) for _, v in items]
    return seq if kind == "l" else tuple(seq)


def save_state(path: str, tree: Any) -> None:
    """Serialize a (possibly nested) params/state pytree to ``.npz``.

    The file lands at exactly ``path`` (``np.savez`` alone would append
    ``.npz`` to extension-less paths, breaking the save/load round-trip
    since ``np.load`` does not)."""
    packed = pack_wire(tree)
    arrays = {}
    for name, leaf in _flatten(packed):
        arrays[name] = np.asarray(leaf)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_state(path: str) -> Any:
    """Restore a pytree saved with :func:`save_state` (host numpy leaves,
    complex planes unpacked)."""
    data = np.load(path, allow_pickle=False)
    root: dict = {}
    for name in data.files:
        parts = name.split(_SEP)
        cur = root
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        value = data[name]
        cur[parts[-1]] = value[()] if value.shape == () else value
    tree = _rebuild(root)
    return unpack_wire(tree)


# ---------------------------------------------------------------------------
# Sharded (multi-device / multi-process) checkpoints via orbax
# ---------------------------------------------------------------------------

def save_sharded(path: str, tree: Any) -> None:
    """Checkpoint a pytree whose leaves may be mesh-sharded ``jax.Array``s
    — including arrays spanning processes on a multi-host
    (``jax.distributed``) job, where no single process can materialize
    the value and :func:`save_state`'s ``np.asarray`` would fail.

    Uses orbax (imported lazily, only here): every process
    writes only its addressable shards; the call is collective — all
    processes of the job must make it.  ``path`` must be an absolute
    path on a filesystem all processes share, and must not yet exist.

    Complex leaves are wire-packed to f32 planes first (same format as
    :func:`save_state`), keeping checkpoints backend-agnostic — orbax
    restore targets then never need complex dtype support."""
    import jax
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    # Packing runs as a compiled program: eager complex ops on
    # process-spanning arrays are illegal on multi-host meshes.  jit
    # preserves each
    # leaf's sharding; host numpy leaves enter replicated.
    packed = jax.jit(pack_wire)(tree)
    ckptr.save(path, packed)
    ckptr.wait_until_finished()


def load_sharded(path: str, like: Any, mesh=None, spec_fn=None) -> Any:
    """Restore a :func:`save_sharded` checkpoint onto a mesh.

    ``like`` is a matching pytree (e.g. ``executor.init_state()``)
    providing shapes/dtypes (never materialized — only
    ``jax.eval_shape`` touches it, so live process-spanning states are
    fine).  Leaves restore replicated over ``mesh`` (or onto the
    default device when no mesh is given) unless
    ``spec_fn(packed_leaf_struct) -> PartitionSpec`` places them —
    note it sees the *wire-packed* leaf (complex leaves carry a
    leading [2] plane axis), and it may place onto a different
    topology than the one that saved (scale-up/down migration).

    Collective on multi-process jobs, like :func:`save_sharded`."""
    import jax
    import orbax.checkpoint as ocp
    from jax.sharding import NamedSharding, PartitionSpec

    def target(leaf):
        if mesh is not None:
            spec = spec_fn(leaf) if spec_fn else PartitionSpec()
            sh = NamedSharding(mesh, spec)
        else:
            sh = jax.sharding.SingleDeviceSharding(jax.devices()[0])
        return jax.ShapeDtypeStruct(leaf.shape, leaf.dtype, sharding=sh)

    ckptr = ocp.StandardCheckpointer()
    like_packed = jax.tree.map(target, jax.eval_shape(pack_wire, like))
    restored = ckptr.restore(path, like_packed)
    # Unpack compiled too (eager complex ops are illegal on multi-host
    # meshes); shardings pass through.
    return jax.jit(unpack_wire)(restored)
