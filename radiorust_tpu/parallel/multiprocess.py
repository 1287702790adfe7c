"""Multi-process (multi-host) distributed execution.

One host controls only its own devices; a multi-host job is driven by N
identical processes running the same program (multi-controller SPMD).  This module
is the bring-up + validation layer for that mode:

- :func:`initialize` wraps ``jax.distributed.initialize`` — after it,
  ``jax.devices()`` is the *global* device list and every mesh built from
  it spans processes, so the sharded executors
  (:class:`~radiorust_tpu.parallel.time_shard.TimeShardedChain`,
  :class:`~radiorust_tpu.parallel.channel_shard.ChannelShardedChain`)
  run unchanged: their programs are jit-compiled SPMD, their halos /
  all_gathers become cross-host collectives automatically.  (The
  executors deliberately contain no eager ops on process-spanning
  arrays — everything post-``shard_map`` runs under jit — which is what
  ``jax_spmd_mode='allow_jit'`` requires.)
- :func:`launch_local_cluster` spawns an N-process **fake cluster on one
  machine** (each process gets its own virtual CPU devices via
  ``--xla_force_host_platform_device_count``), the honest stand-in for
  N hosts in an environment with one real chip; ``tools/fake_cluster.py``
  uses it to value-check the sharded WFM/channelizer paths over a
  2-process global mesh.
- :func:`assert_addressable_allclose` validates a process-spanning
  output against a locally computed reference by comparing only the
  shards this process can address (fetching the full array is neither
  possible nor necessary — every process checks its own slice, and
  :func:`all_processes_ok` agrees on the verdict).

The distributed contract being preserved is the reference's lock-step
delivery: every consumer sees every chunk exactly once, in order
(``/root/reference/src/sync/broadcast_bp.rs:230-331``) — here that is
the determinism of the compiled SPMD step: all processes execute the
same program over the same logical stream, and the value checks pin the
outputs to the sequential scan.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "initialize", "launch_local_cluster", "free_port",
    "assert_addressable_allclose", "all_processes_ok", "process_index",
]


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               heartbeat_timeout_seconds: Optional[int] = None) -> None:
    """Join the job's coordination service (multi-controller bring-up).

    Call once, before any other JAX API touches devices.  The three
    arguments come from the launcher (coordinator ``host:port``, process
    count, this process's index); the fake-cluster workers use
    ``localhost``.

    ``heartbeat_timeout_seconds`` bounds dead-peer DETECTION latency:
    survivors of a peer crash error out of pending collectives once the
    coordination service misses that many seconds of heartbeats (JAX
    default 100 — the fake cluster's r4 SIGKILL drill measured ~103 s to
    detection; the elastic drill runs with 10 for <15 s detection).
    Production guidance in docs/SCALING.md: low enough to meet the
    recovery SLO, high enough to ride out GC/compile pauses."""
    import jax
    kw = {}
    if heartbeat_timeout_seconds is not None:
        kw["heartbeat_timeout_seconds"] = heartbeat_timeout_seconds
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)


def process_index() -> int:
    import jax
    return jax.process_index()


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_local_cluster(script: str, num_processes: int = 2,
                         local_devices: int = 4,
                         args: Sequence[str] = (),
                         timeout: float = 900.0,
                         env_extra: Optional[dict] = None):
    """Spawn ``num_processes`` copies of ``script`` as a fake cluster.

    Each worker gets ``JAX_PLATFORMS=cpu`` with ``local_devices`` virtual
    devices and the argv tail ``--process-id I --coordinator
    127.0.0.1:PORT --num-processes N`` (parse these and call
    :func:`initialize`).  Returns ``(returncodes, outputs)``; the caller
    decides what a nonzero code means.  A worker still running when the
    shared ``timeout`` deadline passes is killed and reported with code
    ``None`` — a HANG verdict the failure drills assert against (a dead
    peer must make survivors *error out*, not park in a collective)."""
    import time as _time
    port = free_port()
    env = dict(os.environ)
    env.update(env_extra or {})
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{local_devices}")
    procs = []
    for i in range(num_processes):
        procs.append(subprocess.Popen(
            [sys.executable, script, *args,
             "--process-id", str(i),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(num_processes)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    deadline = _time.monotonic() + timeout
    codes: List[Optional[int]] = []
    outputs: List[str] = []
    try:
        for p in procs:
            left = max(1.0, deadline - _time.monotonic())
            try:
                out, _ = p.communicate(timeout=left)
                codes.append(p.returncode)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                codes.append(None)      # hang: killed by the launcher
            outputs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return codes, outputs


def assert_addressable_allclose(global_array, want: np.ndarray,
                                atol: float, rows=None, label: str = "",
                                skip: int = 0) -> None:
    """Compare this process's addressable shards of ``global_array``
    against the matching slices of the host reference ``want``.

    ``rows``: optional boolean mask over axis 0 (e.g. the channel-energy
    guard for demodulated channel outputs).  ``skip``: ignore the first
    ``skip`` positions of the LAST axis (warmup outputs)."""
    for sh in global_array.addressable_shards:
        got = np.asarray(sh.data)
        ref = want[sh.index]
        mask = None
        if rows is not None:
            mask = rows[sh.index[0]] if isinstance(sh.index, tuple) \
                else rows
            got, ref = got[mask], ref[mask]
        if skip:
            # Which global positions of the last axis does this shard
            # cover?  Compare only those at/after `skip`.
            sl = sh.index[-1] if isinstance(sh.index, tuple) else slice(None)
            start = sl.start or 0
            cut = max(0, skip - start)
            got, ref = got[..., cut:], ref[..., cut:]
        np.testing.assert_allclose(
            got, ref, atol=atol,
            err_msg=f"{label} shard {sh.index} on process "
                    f"{process_index()}")


def all_processes_ok(ok: bool) -> bool:
    """Global AND across processes (so every worker exits with the same
    verdict even if only one saw a mismatch)."""
    from jax.experimental import multihost_utils
    flags = multihost_utils.process_allgather(np.array([bool(ok)]))
    return bool(np.all(flags))
