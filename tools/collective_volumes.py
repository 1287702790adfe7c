"""Measure per-step collective traffic of the sharded executors.

SCALING.md's halo table was analytic; this tool measures it: the sharded
step programs are compiled (8-device mesh) and the post-SPMD-partitioning
HLO is scanned for collective ops — every ``collective-permute`` /
``all-gather`` / ``all-reduce`` / ``all-to-all`` / ``reduce-scatter`` with
its (per-device, i.e. local-shard) output shape.  Bytes are what one
device sends/receives over the device interconnect per executor step.

Run on any platform (`JAX_PLATFORMS=cpu` forced — the HLO op mix after
partitioning is backend-independent; only codegen differs):

    python tools/collective_volumes.py
"""

from __future__ import annotations

import os
import re
import sys
from collections import Counter

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2,
                "s16": 2, "u16": 2, "f32": 4, "s32": 4, "u32": 4,
                "f64": 8, "s64": 8, "u64": 8, "c64": 8, "c128": 16}

_SHAPE_RE = re.compile(r"\b(pred|s8|u8|bf16|f16|s16|u16|f32|s32|u32|f64|"
                       r"s64|u64|c64|c128)\[([0-9,]*)\]")
_OP_RE = re.compile(r"=\s*(?:\([^)]*\)|\S+)\s+"
                    r"(collective-permute|all-gather|all-reduce|"
                    r"all-to-all|reduce-scatter)(?:-start)?\(")
# Non-greedy op capture: greedy [\w\-]+ would swallow the '-start'
# suffix of async collective pairs (the form latency-hiding scheduling
# emits), misclassifying them and emptying
# schedule_overlap_report's collective list.
_OP_ALL_RE = re.compile(r"=\s*(?:\([^)]*\)|\S+)\s+([\w\-]+?)(?:-start)?\(")


def _bytes_of(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def collective_volumes(hlo_text: str):
    """-> (Counter op->count, Counter op->bytes) from partitioned HLO."""
    counts: Counter = Counter()
    vols: Counter = Counter()
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m or "-done(" in line:
            continue
        op = m.group(1)
        # Output shapes precede the op name on the defining line; a tuple
        # output lists each element (async pairs are filtered above).
        head = line[:m.end()]
        total = sum(_bytes_of(d, s) for d, s in _SHAPE_RE.findall(head))
        counts[op] += 1
        vols[op] += total
    return counts, vols


def _compiled_text(jitted, *args):
    return jitted.lower(*args).compile().as_text()


def schedule_overlap_report(hlo_text: str):
    """Dataflow-independence of each collective in the ENTRY computation.

    An async latency-hiding scheduler can only hide a collective behind
    compute that is dataflow-INDEPENDENT of it (neither ancestor nor
    descendant).  In a single chain every halo permute is on the critical
    path (permute_i needs y_{i-1}; compute_i needs permute_i), so the
    independent set is ~empty; ``TimeShardedGraph(overlap=S)`` splits the
    batch into S independent sub-group walks exactly to create this
    slack.  Returns a dict: per collective op, the min/mean count of
    independent heavy ops (fusions/dots/convolutions — where the FLOPs
    live) and the mean independent fraction of all heavy ops.
    """
    lines = hlo_text.splitlines()
    start = next(i for i, l in enumerate(lines) if l.startswith("ENTRY"))
    name_re = re.compile(r"^%([\w.\-]+) = ")
    deps: dict = {}          # name -> list of operand names
    ops: dict = {}           # name -> op kind
    order = []
    for raw in lines[start + 1:]:
        line = raw.strip()
        if line.startswith("}"):
            break
        m = name_re.match(line)
        if not m:
            continue
        name = m.group(1)
        mo = _OP_ALL_RE.search(line)
        kind = mo.group(1) if mo else "?"
        # Defs precede uses in printed HLO; filtering operand tokens to
        # already-defined names drops computation refs (calls=%fused...).
        operands = [o for o in re.findall(r"%([\w.\-]+)", line[m.end():])
                    if o in deps]
        deps[name] = operands
        ops[name] = kind
        order.append(name)
    users: dict = {n: [] for n in order}
    for n in order:
        for o in deps[n]:
            users[o].append(n)

    def closure(seed, edges):
        seen, stack = {seed}, [seed]
        while stack:
            for nxt in edges[stack.pop()]:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen

    heavy = {n for n, k in ops.items()
             if "fusion" in k or k in ("dot", "convolution", "custom-call")}
    colls = [n for n, k in ops.items()
             if k in ("collective-permute", "all-gather", "all-reduce",
                      "all-to-all", "reduce-scatter")]
    report: dict = {}
    for n in colls:
        dependent = closure(n, deps) | closure(n, users)
        indep = len(heavy - dependent)
        r = report.setdefault(ops[n], {"n": 0, "min": 10 ** 9, "sum": 0})
        r["n"] += 1
        r["min"] = min(r["min"], indep)
        r["sum"] += indep
    return {k: {"count": v["n"], "min_indep_heavy": v["min"],
                "mean_indep_heavy": round(v["sum"] / v["n"], 1),
                "mean_indep_frac": round(v["sum"] / v["n"]
                                         / max(len(heavy), 1), 3)}
            for k, v in report.items()}


def _time_sharded_volumes(ts, params, state, xs):
    """The full step program — halos AND the inline carry-extraction
    psums (review r3 found the extraction originally ran as a second
    program of all-gathers, 8x the halo bytes, invisible to this tool;
    it is now fused into the step and counted here).  Returns
    (counts, volumes, schedule_overlap_report)."""
    txt = _compiled_text(ts._graph._sharded, params, state, xs)
    counts, vols = collective_volumes(txt)
    return counts, vols, schedule_overlap_report(txt)


def measure_time_sharded_wfm(n: int = 16384, batch: int = 1, d: int = 8,
                             overlap: int = 1):
    from radiorust_tpu.blocks.base import StreamSig
    from radiorust_tpu.models.wfm import wfm_receiver
    from radiorust_tpu.parallel.time_shard import TimeShardedChain
    mesh = jax.make_mesh((d,), ("t",))
    sig = StreamSig(batch, n, 1024000.0)
    ts = TimeShardedChain(wfm_receiver().bind(sig), mesh, overlap=overlap)
    x = np.zeros((batch, d * n), np.complex64)
    return _time_sharded_volumes(ts, ((), *ts.params),
                                 ((), *ts.init_state()), {"in": x})


def measure_channel_sharded(d: int = 8):
    from radiorust_tpu.blocks.base import StreamSig
    from radiorust_tpu.models.channelizer import channelized_receiver
    from radiorust_tpu.parallel.channel_shard import ChannelShardedChain
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:d]), ("c",))
    chain = channelized_receiver(num_channels=64, input_rate=1024000.0)
    bound = chain.bind(StreamSig(1, 16384, 1024000.0))
    cs = ChannelShardedChain(bound, mesh, axis="c")
    x = np.zeros((1, 16384), np.complex64)
    reset = np.zeros((1,), bool)
    txt = _compiled_text(cs._sharded, cs.params, cs.init_state(), x, reset)
    counts, vols = collective_volumes(txt)
    return counts, vols, schedule_overlap_report(txt)


def main():
    rows = []
    for name, fn, note in [
        ("WFM time-sharded t=8 (batch 1, n=16384)",
         measure_time_sharded_wfm,
         "per-block halos: 2 filters + 2 resamplers + demod"),
        ("WFM t=8 batch 8, overlap=1",
         lambda: measure_time_sharded_wfm(batch=8),
         "serial halos: ~0 independent compute per permute"),
        ("WFM t=8 batch 8, overlap=4",
         lambda: measure_time_sharded_wfm(batch=8, overlap=4),
         "sub-batch pipelining: ~3/4 of compute independent per permute"),
        ("Channelizer 64ch channel-sharded c=8 (n=16384)",
         measure_channel_sharded,
         "branch all_gather (decimated data)"),
    ]:
        counts, vols, sched = fn()
        total = sum(vols.values())
        detail = ", ".join(f"{op} x{counts[op]} = {vols[op]/1024:.1f} kB"
                           for op in sorted(counts))
        perm = sched.get("collective-permute")
        frac = "-" if perm is None else f"{perm['mean_indep_frac']:.0%}"
        rows.append((name, total, detail, frac, note))
        print(f"{name}\n  total {total/1024:.1f} kB/device/step"
              f"  [{detail}]  ({note})")
        for op, r in sorted(sched.items()):
            print(f"  {op}: x{r['count']}, independent heavy ops "
                  f"min {r['min_indep_heavy']} mean {r['mean_indep_heavy']}"
                  f" ({r['mean_indep_frac']:.0%} of compute hideable)")
    print()
    print("| configuration | bytes/device/step | breakdown |"
          " permute-hideable compute |")
    print("|---|---|---|---|")
    for name, total, detail, frac, note in rows:
        print(f"| {name} | {total/1024:.1f} kB | {detail} | {frac} |")


if __name__ == "__main__":
    main()
