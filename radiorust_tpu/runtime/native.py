"""Threaded native runtime: C++ broadcast channels + one thread per block.

The reference pipelines blocks across CPU cores via Tokio tasks and its
``broadcast_bp`` channel (``src/sync/broadcast_bp.rs``).  This module is
the native equivalent for this build: each block runs on an OS thread,
handing Signal messages through the GIL-free C++ channel
(``radiorust_tpu/native/broadcast_bp.cpp``).  JAX device dispatch releases the
GIL, so host I/O, keying/control logic, and device compute for different
pipeline stages genuinely overlap — the same steady-state pipelining the
reference gets from its runtime, with the per-chunk math still on the
device.

Use :class:`NativeGraph` to build a pipeline::

    g = NativeGraph()
    src = g.source(chunk_iter)
    shifted = g.block(FreqShifter.with_shift(700.0), src)
    out = g.sink(shifted)
    g.run()          # blocks until sources drain
    out.samples      # collected output

The asyncio runtime (:mod:`radiorust_tpu.runtime.flow`) remains the
dynamic-rewiring API; this one favors throughput.
"""

from __future__ import annotations

import ctypes
import itertools
import pathlib
import subprocess
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from ..blocks.base import Block, StreamSig
from ..signal import Event, Samples

__all__ = ["NativeChannel", "NativeGraph", "load_library"]

# C++ sources ship inside the package (pyproject package-data) so the
# native runtime works from an installed wheel, not just a repo checkout.
_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[1] / "native"
_LIB = None


def _build_so(srcs) -> pathlib.Path:
    """Compile the shared library, preferring a build next to the sources
    (repo checkout) and falling back to a user cache dir when the package
    directory is read-only (system-installed wheel)."""
    import os
    override = os.environ.get("RRTPU_NATIVE_BUILD_DIR")
    candidates = ([pathlib.Path(override)] if override
                  else [_NATIVE_DIR,
                        pathlib.Path.home() / ".cache" / "radiorust_tpu"])
    last_err = None
    for d in candidates:
        so = d / "libbroadcast_bp.so"
        try:
            if so.exists() and all(so.stat().st_mtime >= s.stat().st_mtime
                                   for s in srcs):
                return so
            d.mkdir(parents=True, exist_ok=True)
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 "-o", str(so)] + [str(s) for s in srcs] + ["-lpthread"],
                check=True)
            return so
        except (OSError, subprocess.CalledProcessError) as e:
            last_err = e
    raise RuntimeError(f"could not build the native runtime: {last_err}")


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the native runtime library
    (broadcast_bp channel + IQ file loader)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = [_NATIVE_DIR / "broadcast_bp.cpp", _NATIVE_DIR / "iq_loader.cpp"]
    so = _build_so(srcs)
    lib = ctypes.CDLL(str(so))
    lib.bp_channel_new.restype = ctypes.c_void_p
    lib.bp_channel_free.argtypes = [ctypes.c_void_p]
    lib.bp_send.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.bp_send.restype = ctypes.c_int
    lib.bp_can_send.argtypes = [ctypes.c_void_p]
    lib.bp_can_send.restype = ctypes.c_int
    lib.bp_sender_close.argtypes = [ctypes.c_void_p]
    lib.bp_subscribe.argtypes = [ctypes.c_void_p]
    lib.bp_subscribe.restype = ctypes.c_int
    lib.bp_unsubscribe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bp_recv.argtypes = [ctypes.c_void_p, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_size_t)]
    lib.bp_recv.restype = ctypes.c_int
    lib.bp_recv_timeout.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_size_t),
                                    ctypes.c_int]
    lib.bp_recv_timeout.restype = ctypes.c_int
    lib.bp_enlister_retain.argtypes = [ctypes.c_void_p]
    lib.bp_enlister_release.argtypes = [ctypes.c_void_p]
    lib.iq_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.iq_open.restype = ctypes.c_void_p
    lib.iq_size.argtypes = [ctypes.c_void_p]
    lib.iq_size.restype = ctypes.c_long
    lib.iq_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.iq_read.restype = ctypes.c_long
    lib.iq_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class NativeChannel:
    """Python handle over a C++ capacity-1 broadcast channel.

    Payloads are Python objects; the channel carries integer tokens while a
    registry keeps the objects alive until every subscriber consumed them.
    """

    def __init__(self):
        self._lib = load_library()
        self._ptr = self._lib.bp_channel_new()
        self._tokens = itertools.count(1)
        self._registry: Dict[int, tuple] = {}
        self._reg_lock = threading.Lock()
        self._enlisted = True   # subscription point held open (see below)
        self._leak = False      # skip freeing (threads may still block on it)

    def send(self, obj) -> bool:
        """Blocking send; False when the channel is closed."""
        token = next(self._tokens)
        # Refcount = number of current receivers isn't knowable pre-send
        # (receivers may join); keep the object until the *next* send
        # completes, which implies all receivers took this one.
        with self._reg_lock:
            self._registry[token] = obj
            # Eviction safety: when send(t) is entered, send(t-1) has
            # returned, so every receiver consumed t-2 *in the C++ layer*;
            # program order then guarantees their Python-side lookups of
            # t-3 completed.  Anything older is unreachable.
            stale = [t for t in self._registry if t < token - 2]
            for t in stale:
                del self._registry[t]
        return self._lib.bp_send(self._ptr, token) == 0

    def close_sender(self):
        self._lib.bp_sender_close(self._ptr)

    def release_enlister(self):
        """Drop the subscription point (the reference's ``Enlister`` Drop,
        ``src/sync/broadcast_bp.rs:181-190``).  Until this is called the
        channel assumes more receivers may subscribe and a sender with no
        receivers blocks; afterwards, a sender whose receivers are all
        gone observes closure (``send`` returns False).  Idempotent."""
        if self._enlisted:
            self._enlisted = False
            self._lib.bp_enlister_release(self._ptr)

    def subscribe(self) -> int:
        return self._lib.bp_subscribe(self._ptr)

    def unsubscribe(self, rid: int):
        self._lib.bp_unsubscribe(self._ptr, rid)

    def recv(self, rid: int, timeout_ms: int = -1):
        """Blocking receive; returns (ok, obj)."""
        out = ctypes.c_size_t()
        rc = self._lib.bp_recv_timeout(self._ptr, rid, ctypes.byref(out),
                                       timeout_ms)
        if rc != 0:
            return False, None
        with self._reg_lock:
            obj = self._registry.get(int(out.value))
        return True, obj

    def __del__(self):
        # A channel whose graph timed out may still have daemon threads
        # parked inside bp_recv/bp_send; freeing the C++ state under them
        # is use-after-free.  NativeGraph marks such channels leaked.
        if self._leak:
            return
        try:
            self._lib.bp_channel_free(self._ptr)
        except Exception:
            pass


class _Node:
    def __init__(self, name: str):
        self.name = name
        self.out_channel: Optional[NativeChannel] = None
        self.thread: Optional[threading.Thread] = None
        self.failure: Optional[BaseException] = None


class _SinkNode(_Node):
    def __init__(self, name):
        super().__init__(name)
        self.chunks: List[np.ndarray] = []
        self.events: List[Event] = []
        self.sample_rate: Optional[float] = None

    @property
    def samples(self) -> np.ndarray:
        return (np.concatenate(self.chunks) if self.chunks
                else np.zeros(0, np.complex64))


class NativeGraph:
    """Static pipeline executed on OS threads with native channels."""

    def __init__(self):
        self._nodes: List[_Node] = []
        self._started = False

    def source(self, messages: Iterable, name: str = "source") -> _Node:
        """A producer draining an iterable of Samples/Event messages."""
        node = _Node(name)
        node.out_channel = NativeChannel()

        def run():
            try:
                for msg in messages:
                    if not node.out_channel.send(msg):
                        return
            except BaseException as exc:  # surfaced by NativeGraph.run
                node.failure = exc
            finally:
                # Always close: a raising iterator must not leave
                # downstream parked in recv forever.
                node.out_channel.close_sender()

        node.thread = threading.Thread(target=run, name=name, daemon=True)
        self._nodes.append(node)
        return node

    def block(self, spec: Block, upstream: _Node,
              name: Optional[str] = None) -> _Node:
        """A processing stage wrapping a compiled block spec."""
        import jax
        import jax.numpy as jnp

        from ..utils.profiling import GLOBAL_STATS
        node = _Node(name or type(spec).__name__)
        node.out_channel = NativeChannel()
        node.stats = GLOBAL_STATS.unique(node.name)
        in_ch = upstream.out_channel
        # Subscribe at wiring time (main thread): the subscription exists
        # before any thread starts, so run() can release the channels'
        # enlisters and closure becomes observable to blocked senders.
        rid = in_ch.subscribe()

        def run():
            import time as _time
            from ..signal import Warmup
            from ..blocks.base import jit_step, pack_wire, unpack_wire
            bindings: Dict = {}
            bound = None
            pstate = None
            pending_reset = False
            try:
                while True:
                    ok, msg = in_ch.recv(rid)
                    if not ok:
                        return
                    if isinstance(msg, Event):
                        if msg.is_interrupt:
                            pending_reset = True
                        node.stats.record_event()
                        if not node.out_channel.send(msg):
                            return
                        continue
                    chunk = np.asarray(msg.chunk)
                    t0 = _time.perf_counter()
                    key = (len(chunk), msg.sample_rate)
                    if key not in bindings:
                        b = spec.bind(StreamSig(1, *key))
                        # Wire-safe step (complex leaves packed as planes).
                        b._jit = jit_step(b)
                        bindings[key] = b
                    fresh = bindings[key] is not bound
                    if fresh:
                        bound = bindings[key]
                        pstate = pack_wire(bound.init_state())
                    if (fresh or pending_reset) and bound.valid_from > 0:
                        # Zero-primed history (first chunk, mid-stream
                        # signature change, or interrupt): warn consumers
                        # like the compiled path does
                        # (runtime/blocks.py::_send_warmup).
                        if not node.out_channel.send(Warmup(
                                bound.valid_from)):
                            return
                    reset = np.asarray([pending_reset and not fresh])
                    pending_reset = False
                    pstate, py = bound._jit(pack_wire(bound.params), pstate,
                                            pack_wire(chunk[None, :]), reset)
                    y = np.asarray(unpack_wire(jax.tree.map(np.asarray, py)))
                    node.stats.record_chunk(len(chunk),
                                            _time.perf_counter() - t0)
                    out = Samples(bound.out_sig.sample_rate, y[0])
                    if not node.out_channel.send(out):
                        return
            except BaseException as exc:  # surfaced by NativeGraph.run
                node.failure = exc
            finally:
                # Close before unsubscribing so downstream drains out and
                # upstream's next send observes this receiver gone instead
                # of deadlocking on an undelivered slot.
                node.out_channel.close_sender()
                in_ch.unsubscribe(rid)

        node.thread = threading.Thread(target=run, name=node.name,
                                       daemon=True)
        self._nodes.append(node)
        return node

    def sink(self, upstream: _Node, name: str = "sink") -> _SinkNode:
        node = _SinkNode(name)
        in_ch = upstream.out_channel
        rid = in_ch.subscribe()  # wiring-time, see block()

        def run():
            try:
                while True:
                    ok, msg = in_ch.recv(rid)
                    if not ok:
                        return
                    if isinstance(msg, Event):
                        node.events.append(msg)
                    else:
                        node.sample_rate = msg.sample_rate
                        node.chunks.append(np.asarray(msg.chunk))
            except BaseException as exc:  # surfaced by NativeGraph.run
                node.failure = exc
            finally:
                in_ch.unsubscribe(rid)

        node.thread = threading.Thread(target=run, name=name, daemon=True)
        self._nodes.append(node)
        return node

    def run(self, timeout: Optional[float] = 60.0):
        """Start all threads and join until the pipeline drains.

        Raises the first node failure (a block/source thread exception) as
        a ``RuntimeError`` chained to the original exception; raises
        ``TimeoutError`` when a node neither finishes nor fails within
        ``timeout`` seconds."""
        # Wiring is complete: every subscription was taken at graph-build
        # time, so drop the channels' subscription points.  From here on a
        # sender whose receivers are all gone observes closure instead of
        # waiting for receivers that can no longer appear (the reference's
        # Enlister drop, src/sync/broadcast_bp.rs:181-190).
        for node in self._nodes:
            if node.out_channel is not None:
                node.out_channel.release_enlister()
        for node in reversed(self._nodes):
            node.thread.start()
        for node in self._nodes:
            node.thread.join(timeout)
            if node.thread.is_alive():
                # Threads may still be parked inside the C++ channel;
                # freeing it under them is use-after-free, so leak instead.
                for n in self._nodes:
                    if n.out_channel is not None:
                        n.out_channel._leak = True
                self._raise_failure()
                raise TimeoutError(f"node {node.name} did not finish")
        self._raise_failure()

    def _raise_failure(self) -> None:
        for node in self._nodes:
            if node.failure is not None:
                raise RuntimeError(
                    f"node {node.name} failed") from node.failure
