"""radiorust_tpu — a software-defined-radio framework on JAX/XLA.

A from-scratch rebuild of the capabilities of JanBeh/radiorust (a Tokio
actor-graph SDR library) as a JAX/XLA dataflow: DSP blocks are declarative
specs with pure ``process(state, chunk_batch)`` functions; chains of blocks
compile into single fused XLA programs scanned over chunk batches; filter/IR
design runs host-side in float64; the hot sample path runs on the
accelerator (an NVIDIA GPU) in complex64; multi-device scaling shards channels and time blocks over a
``jax.sharding.Mesh`` with collective-permute halo exchange for streaming
state.

See SURVEY.md for the reference analysis and layer mapping.
"""

from . import math, metering, numbers, windowing  # noqa: F401
from .blocks import morse  # noqa: F401

__version__ = "0.1.0"
