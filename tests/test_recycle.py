"""Checkpoint-based worker recycling (runtime/recycle.py).

The stitched output of a stream served across recycled worker processes
must be bit-identical to one uninterrupted run, and only the first (cold)
generation may emit a Warmup event — resumed generations continue the
stream state, they do not re-prime it.
"""

import numpy as np
import pytest

from radiorust_tpu.blocks.base import Chain
from radiorust_tpu.blocks.filters import Filter
from radiorust_tpu.blocks.transform import FreqShifter, GainControl
from radiorust_tpu.runtime import serve_recycling


def _spec():
    return Chain(
        FreqShifter.with_shift(1000.0),
        Filter.new(lambda b, f: np.where(np.abs(f) <= 200.0, 1.0, 0.0)),
        GainControl(0.5),
    )


def _chunks(t=7, n=256, seed=3):
    rng = np.random.default_rng(seed)
    return list((rng.standard_normal((t, n))
                 + 1j * rng.standard_normal((t, n))).astype(np.complex64))


@pytest.mark.parametrize("budget,want_gens", [(3, 3), (7, 1)])
def test_recycling_bit_exact(tmp_path, budget, want_gens):
    xs = _chunks()
    path = str(tmp_path / "gen.npz")
    stats = []
    outs, gens, warmups = serve_recycling(
        _spec, xs, 8000.0, chunks_per_worker=budget, ckpt_path=path,
        jax_platform="cpu", stats=stats)
    assert gens == want_gens
    assert len(stats) == gens
    assert all(s["maxrss_mb"] > 0 for s in stats), stats
    # Only the cold generation primes zero history (Warmup); every
    # resumed generation continues the checkpointed stream state.
    assert warmups[0] == 1 and all(w == 0 for w in warmups[1:]), warmups
    # Uninterrupted single-worker run == stitched recycled run, bitwise.
    ref, gens1, _ = serve_recycling(
        _spec, xs, 8000.0, chunks_per_worker=len(xs) + 1, ckpt_path=path,
        jax_platform="cpu")
    assert gens1 == 1
    np.testing.assert_array_equal(np.concatenate(outs),
                                  np.concatenate(ref))


def _ragged_spec():
    from radiorust_tpu.blocks.resampling import Downsampler
    return Downsampler(384.0, 200.0)  # phase mode at chunk 100


def test_recycling_rejects_phase_mode(tmp_path):
    # Ragged (trimmed-schedule) chains break the lock-step protocol; the
    # worker must reject them with a clear error, not hang.
    xs = [np.ones(100, np.complex64)] * 2
    with pytest.raises(RuntimeError, match="one output chunk per input"):
        serve_recycling(_ragged_spec, xs, 1024.0, chunks_per_worker=4,
                        ckpt_path=str(tmp_path / "gen.npz"),
                        jax_platform="cpu", timeout=120.0)


def _dying_spec():
    import os
    os._exit(3)  # simulates a worker killed before it can report


def test_recycling_dead_worker_raises_promptly(tmp_path):
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="died without reporting"):
        serve_recycling(_dying_spec, _chunks(2), 8000.0,
                        chunks_per_worker=4,
                        ckpt_path=str(tmp_path / "gen.npz"),
                        jax_platform="cpu", timeout=120.0)
    # Liveness polling, not the full queue timeout.
    assert time.monotonic() - t0 < 60.0


def test_recycling_surfaces_worker_error(tmp_path):
    # A 3-D chunk is not a stream the actor can bind; the worker's failure
    # must surface as a supervisor-side RuntimeError, not a hang.
    bad = [np.zeros((3, 5, 7), np.complex64)]
    path = str(tmp_path / "gen.npz")
    with pytest.raises(RuntimeError, match="recycling worker"):
        serve_recycling(_spec, bad, 8000.0, chunks_per_worker=4,
                        ckpt_path=path, jax_platform="cpu", timeout=120.0)


def test_supervisor_holding_the_gpu_is_refused(tmp_path, monkeypatch):
    # One process per card: a supervisor that already initialized the GPU
    # backend must not spawn GPU workers (they would fail for memory).
    from radiorust_tpu.runtime import recycle
    monkeypatch.setattr(recycle, "_supervisor_holds_gpu", lambda: True)
    with pytest.raises(RuntimeError, match="card to itself"):
        serve_recycling(_spec, _chunks(t=1), 8000.0, chunks_per_worker=1,
                        ckpt_path=str(tmp_path / "gen.npz"))


def test_supervisor_on_cpu_does_not_hold_the_gpu():
    import jax

    from radiorust_tpu.runtime import recycle
    jax.devices()                     # the CPU backend is initialized
    assert not recycle._supervisor_holds_gpu()
