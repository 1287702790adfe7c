"""Regression test of the serving soak harness (tools/soak.py): the
full actor stack (SdrRx -> Rechunker -> RuntimeBlock -> Buffer ->
Blackhole) must sustain a short CPU run with the harness's decay /
memory-creep / queue-growth checks passing and the record schema
intact.  The full-length run of the same harness goes on the GPU."""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_soak_harness_cpu():
    # 30 s: four 7.5 s throughput buckets, long enough that the other
    # test workers sharing the CPU average out of the decay check.
    env = dict(os.environ, JAX_PLATFORMS="cpu", SOAK_SECONDS="30")
    env.pop("XLA_FLAGS", None)  # single-device run, not the test mesh
    r = subprocess.run(
        [sys.executable, str(REPO / "tools" / "soak.py")],
        env=env, capture_output=True, text=True, timeout=560)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads(r.stdout)
    assert rec["ok"] and rec["platform"] == "cpu"
    assert rec["chunks_processed"] > 100
    assert rec["throughput_ok"] and rec["rss_ok"] and rec["queue_ok"]
    assert rec["sink_samples"] > 0
    # Sink samples are real 48 kHz audio: chunks * 24576 in / (64/3).
    expect = rec["chunks_processed"] * rec["chunk"] * 3 // 64
    assert abs(rec["sink_samples"] - expect) <= 3 * rec["chunk"]
