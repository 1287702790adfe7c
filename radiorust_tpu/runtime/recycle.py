"""Checkpoint-based worker recycling for long-lived serving.

Bounds each worker process's lifetime: serve N chunks, checkpoint the
live stream state (:meth:`RuntimeBlock.save_checkpoint`), exit, and let a
fresh process resume bit-exactly (``load_checkpoint`` re-emits neither a
``Warmup`` event nor a state reset —
``test_checkpoint.py::test_runtime_block_checkpoint_resume``).  Whatever
a process accumulates over its lifetime (host memory above all) resets at
every recycle.

:func:`serve_recycling` composes those pieces into a generation
supervisor: the parent feeds input chunks to worker subprocesses over
queues and stitches their outputs into one gapless stream; a worker
recycles itself after ``chunks_per_worker`` chunks.

One process per card: a JAX process reserves most of a GPU's memory when
it first uses it, so a second process on the same card fails for want of
memory.  The supervisor therefore refuses to run once it has itself
initialized a GPU backend, and generations run strictly serially — the
next one starts only after the previous one has exited (or been killed).

The reference has no analog — its workers are long-lived OS threads
(``src/blocks/mod.rs:27-34``); this reuses the same checkpoint machinery
as the elastic-recovery drill (``tools/fake_cluster.py``).
"""

import multiprocessing
import queue
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["serve_recycling"]

_NO_SENTINEL = object()  # "no end-of-stream sentinel was queued"


def _supervisor_holds_gpu() -> bool:
    """Whether this process has already initialized a GPU backend."""
    import sys
    if "jax" not in sys.modules:
        return False
    from jax._src import xla_bridge
    if not xla_bridge.backends_are_initialized():
        return False
    import jax
    return jax.default_backend() == "gpu"


def _reap(proc) -> None:
    """Terminate, then kill, a worker that is still alive."""
    if proc.is_alive():
        proc.terminate()
        proc.join(5.0)
    if proc.is_alive():
        proc.kill()
        proc.join(5.0)


def _worker(spec_builder, sample_rate, ckpt_path, resume, in_q, out_q,
            jax_platform):
    """One worker generation: serve chunks from ``in_q`` until the budget
    sentinel or end-of-stream, emitting each output on ``out_q`` in lock
    step (the capacity-1 channel discipline of the runtime itself).

    Runs in a fresh ``spawn`` process.  Protocol on ``out_q``:
    ``("chunk", array)`` per output, then exactly one of
    ``("recycle", stats)`` (budget reached, checkpoint written),
    ``("done", stats)`` (end of stream), or ``("error", repr)`` —
    ``stats`` = ``{"warmups": n, "maxrss_mb": peak_rss}``.
    """
    if jax_platform is not None:
        import jax
        jax.config.update("jax_platforms", jax_platform)
    import asyncio
    import queue as _queue

    from ..signal import Samples, Warmup
    from .blocks import ArraySink, RuntimeBlock, wait_until
    from .flow import new_sender

    async def run():
        sender, connector = new_sender()
        blk = RuntimeBlock(spec_builder())
        if resume:
            blk.load_checkpoint(ckpt_path)
        sink = ArraySink()
        blk.receiver_connector.connect(connector)
        sink.feed_from(blk)
        loop = asyncio.get_running_loop()
        served = emitted = 0

        def _next_item():
            # Poll so a worker orphaned by supervisor death exits instead
            # of blocking on the queue forever (it would hold the card
            # for every later run).
            while True:
                try:
                    return in_q.get(timeout=5.0)
                except _queue.Empty:
                    parent = multiprocessing.parent_process()
                    if parent is None or not parent.is_alive():
                        raise RuntimeError(
                            "supervisor process died; worker exiting")

        while True:
            item = await loop.run_in_executor(None, _next_item)
            if item is None:  # end of stream
                out_q.put(("done", _finish(sink)))
                return
            await sender.send(Samples(sample_rate, item))
            served += 1
            if served == 1:
                # The lock-step protocol below assumes one output chunk
                # per input; a phase-mode (ragged) resampler tail emits a
                # trimmed schedule (zero-valid chunks are skipped by the
                # actor), which would hang the wait.  Reject with a clear
                # error once the first chunk has bound the chain.
                await wait_until(lambda: blk._bound is not None, blk,
                                 sink, timeout=None)
                if getattr(blk._bound, "ragged_output", False):
                    raise RuntimeError(
                        "serve_recycling requires one output chunk per "
                        "input; phase-mode (arbitrary-ratio) resampler "
                        "tails emit a trimmed schedule — re-chunk to a "
                        "multiple of the resampling period or serve "
                        "through RuntimeBlock directly")
            # Lock-step: surface this chunk's output (and any actor
            # failure) before accepting the next input, so the supervisor
            # sees a gapless ordered stream and a crash points at the
            # chunk that caused it.
            # timeout=None: the first chunk includes compilation; genuine
            # hangs are the supervisor's liveness timeout to handle,
            # failures surface through the actors' .failure polling here.
            await wait_until(lambda: len(sink.chunks) >= served, blk, sink,
                             timeout=None)
            while emitted < len(sink.chunks):
                out_q.put(("chunk", sink.chunks[emitted]))
                emitted += 1
            if served >= budget:
                # If the stream ended exactly at the budget boundary the
                # supervisor has already queued the None sentinel — peek
                # for it so the final generation skips the dead
                # checkpoint write (a device->host state sync).  An Empty
                # race just means a harmless extra checkpoint.
                try:
                    nxt = await loop.run_in_executor(
                        None, lambda: in_q.get(timeout=0.5))
                except _queue.Empty:
                    nxt = _NO_SENTINEL
                if nxt is None:
                    out_q.put(("done", _finish(sink)))
                    return
                # Between sends — the same contract as the typed setters.
                blk.save_checkpoint(ckpt_path)
                out_q.put(("recycle", _finish(sink)))
                return

    def _finish(sink):
        import resource
        return {
            "warmups": sum(isinstance(e, Warmup) for e in sink.events),
            # Linux ru_maxrss is KiB: the generation's peak RSS, the
            # number that resets at every recycle.
            "maxrss_mb": round(resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1),
        }

    try:
        # First message is this generation's budget; the supervisor sends
        # it right after spawn, so a long wait means it died in between.
        budget = in_q.get(timeout=60.0)
        asyncio.run(run())
    except Exception as exc:  # surface to the supervisor, don't hang it
        out_q.put(("error", repr(exc)))
        raise


def serve_recycling(
    spec_builder: Callable, chunks: Sequence[np.ndarray],
    sample_rate: float, *, chunks_per_worker: int, ckpt_path: str,
    jax_platform: Optional[str] = None, timeout: float = 300.0,
    stats: Optional[list] = None,
) -> Tuple[List[np.ndarray], int, List[int]]:
    """Serve ``chunks`` through ``spec_builder()`` across recycled worker
    processes; returns ``(output_chunks, generations, warmups_per_gen)``.

    ``spec_builder`` must be a picklable top-level callable returning the
    block spec (each generation rebuilds and rebinds it — the checkpoint
    carries only the stream state, exactly like cross-process resume).
    From a script, call under ``if __name__ == "__main__":`` — workers
    are ``spawn`` processes, which re-import the caller's main module.
    The stitched ``output_chunks`` are bit-identical to an uninterrupted
    single-process run (``tests/test_recycle.py``).  ``jax_platform``
    forces the worker backend (tests pass ``"cpu"``; ``None`` keeps the
    environment's default — the GPU in production).  Pass a list as
    ``stats`` to collect each generation's terminal report
    (``{"warmups", "maxrss_mb"}`` — the peak-RSS series resets at every
    recycle).

    Raises :class:`RuntimeError` if this process has already initialized
    a GPU backend while the workers would use the GPU: the card takes one
    process at a time (give each its share with
    ``XLA_PYTHON_CLIENT_MEM_FRACTION`` if both really must hold it).
    """
    if chunks_per_worker < 1:
        raise ValueError("chunks_per_worker must be >= 1")
    if jax_platform != "cpu" and _supervisor_holds_gpu():
        raise RuntimeError(
            "serve_recycling: this process has initialized the GPU backend; "
            "each worker generation needs the card to itself.  Start the "
            "supervisor before any JAX use, or set "
            "XLA_PYTHON_CLIENT_MEM_FRACTION for every process.")
    ctx = multiprocessing.get_context("spawn")
    outs: List[np.ndarray] = []
    warmups: List[int] = []
    i, gens = 0, 0
    resume = False  # first generation is a cold start
    while True:
        in_q: multiprocessing.Queue = ctx.Queue()
        out_q: multiprocessing.Queue = ctx.Queue()
        proc = ctx.Process(
            target=_worker,
            args=(spec_builder, sample_rate, ckpt_path, resume, in_q,
                  out_q, jax_platform))
        proc.start()
        gens += 1
        try:
            in_q.put(chunks_per_worker)  # generation budget
            fed = 0
            while fed < chunks_per_worker and i < len(chunks):
                in_q.put(np.asarray(chunks[i]))
                i += 1
                fed += 1
            if fed < chunks_per_worker or i >= len(chunks):
                # End-of-stream sentinel; also sent when the stream ends
                # exactly at the budget so the last generation can skip
                # its dead checkpoint write.
                in_q.put(None)
            kind = None
            deadline = timeout
            while True:
                # Poll with liveness checks: a worker that dies before it
                # can report (e.g. killed, or the spawn bootstrap failed
                # because the caller's script lacks an
                # `if __name__ == "__main__"` guard) must raise promptly,
                # not block the full timeout.
                try:
                    kind, payload = out_q.get(timeout=min(1.0, timeout))
                except queue.Empty:
                    if not proc.is_alive():
                        # Drain any message that raced the exit (the queue
                        # feeder flushes on child exit, but not instantly).
                        try:
                            kind, payload = out_q.get(timeout=1.0)
                        except queue.Empty:
                            raise RuntimeError(
                                f"recycling worker (gen {gens}) died "
                                f"without reporting (exit "
                                f"{proc.exitcode}); if serve_recycling is "
                                f"called from a script, it must run under "
                                f"`if __name__ == '__main__'` "
                                f"(multiprocessing spawn re-imports the "
                                f"main module)") from None
                    else:
                        deadline -= 1.0
                        if deadline <= 0:
                            # Reap before raising: a live child would
                            # still hold the card under a caller's retry.
                            _reap(proc)
                            raise TimeoutError(
                                f"recycling worker (gen {gens}) produced "
                                f"no message for {timeout} s")
                        continue
                deadline = timeout
                if kind == "chunk":
                    outs.append(payload)
                elif kind == "error":
                    proc.join(timeout)
                    _reap(proc)
                    raise RuntimeError(f"recycling worker (gen {gens}) "
                                       f"failed: {payload}")
                else:  # "recycle" | "done"
                    warmups.append(payload["warmups"])
                    if stats is not None:
                        stats.append(payload)
                    break
            proc.join(timeout)
            if proc.exitcode != 0:
                # Never start the next generation (or return to a caller
                # that might) while this one could still hold the card.
                _reap(proc)
                raise RuntimeError(
                    f"recycling worker (gen {gens}) exited {proc.exitcode}")
        finally:
            # Release the queue feeder threads even when a raise leaves
            # unread chunks behind (a blocked feeder would hang the
            # caller's interpreter at exit); by the time the normal path
            # gets here the worker has consumed every input it was fed.
            for q in (in_q, out_q):
                q.cancel_join_thread()
                q.close()
        if kind == "done" or (kind == "recycle" and i >= len(chunks)):
            # Budget boundary coinciding with end-of-stream: everything
            # is served; don't spin up an empty generation.
            return outs, gens, warmups
        resume = True
